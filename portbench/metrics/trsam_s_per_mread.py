"""Host seconds of the transcriptome projection (quant/trsam.py
quant_transcriptome: the indel, soft-clip and single-end bans, the soft-clip
extension with its mismatch re-check and the projection onto the
transcripts, inside quant; not the records' encoding) per million reads of
the window: pipeline.TIMERS trsam.  A program without the span reads
nothing."""


def read(rec):
    t = rec["timers"]
    if "trsam" not in t or not rec["reads"]:
        return None
    return t["trsam"] / rec["reads"] * 1e6
