"""Seconds of STARsolo's UMI collapse (solo/solo.py Solo.process: the
count_* step of every feature), once a job: pipeline.TIMERS
solo_collapse."""


def read(rec):
    return rec["timers"].get("solo_collapse")
