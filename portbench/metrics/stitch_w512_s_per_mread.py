"""Seconds of the W512 stitch level (ops/batch_engine.py: windows, the stitch
engine, assembly) per million reads of the window: pipeline.TIMERS
stitch_level_W512."""


def read(rec):
    keys = ['stitch_level_W512']
    if not any(k in rec["timers"] for k in keys) or not rec["reads"]:
        return None
    return sum(rec["timers"].get(k, 0.0) for k in keys) / rec["reads"] * 1e6
