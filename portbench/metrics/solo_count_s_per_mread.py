"""Host seconds of STARsolo's per-read work (solo/: barcode match, feature
record) per million reads of the window: pipeline.TIMERS solo_count."""


def read(rec):
    keys = ['solo_count']
    if not any(k in rec["timers"] for k in keys) or not rec["reads"]:
        return None
    return sum(rec["timers"].get(k, 0.0) for k in keys) / rec["reads"] * 1e6
