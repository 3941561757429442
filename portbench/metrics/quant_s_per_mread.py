"""Host seconds of quantification (quant/: GeneCounts and TranscriptomeSAM per
read) per million reads of the window: pipeline.TIMERS quant."""


def read(rec):
    keys = ['quant']
    if not any(k in rec["timers"] for k in keys) or not rec["reads"]:
        return None
    return sum(rec["timers"].get(k, 0.0) for k in keys) / rec["reads"] * 1e6
