"""Host seconds of the batch's prepare stage (ops/pipeline.py _align_batch:
clipping, read parsing) per million reads of the window: pipeline.TIMERS
prepare."""


def read(rec):
    keys = ['prepare']
    if not any(k in rec["timers"] for k in keys) or not rec["reads"]:
        return None
    return sum(rec["timers"].get(k, 0.0) for k in keys) / rec["reads"] * 1e6
