"""Seconds of the device stitch engine's grow loop (ops/device_stitch.py) at
both levels per million reads of the window: pipeline.TIMERS dev_grow_W8 +
dev_grow_W512."""


def read(rec):
    keys = ['dev_grow_W8', 'dev_grow_W512']
    if not any(k in rec["timers"] for k in keys) or not rec["reads"]:
        return None
    return sum(rec["timers"].get(k, 0.0) for k in keys) / rec["reads"] * 1e6
