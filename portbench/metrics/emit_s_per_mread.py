"""Host seconds of each read's output outside solo_count, quant and
bam_encode (run.py emit: chimeric detection, SJ.out.tab records, stats,
SAM, unmapped FASTX) per million reads of the window: pipeline.TIMERS
emit."""


def read(rec):
    v = rec["timers"].get("emit")
    if v is None or not rec["reads"]:
        return None
    return v / rec["reads"] * 1e6
