"""Host seconds of the finish stage (pipeline._fast_finish and the per-read
finish) per million reads of the window: pipeline.TIMERS finish."""


def read(rec):
    keys = ['finish']
    if not any(k in rec["timers"] for k in keys) or not rec["reads"]:
        return None
    return sum(rec["timers"].get(k, 0.0) for k in keys) / rec["reads"] * 1e6
