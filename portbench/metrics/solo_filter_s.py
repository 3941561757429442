"""Seconds of STARsolo's cell filtering (solo/solo.py Solo.process:
cell_filtering of every feature, EmptyDrops_CR and the filtered matrices),
once a job: pipeline.TIMERS solo_filter."""


def read(rec):
    return rec["timers"].get("solo_filter")
