"""Seconds of STARsolo's end of job (solo/: UMI collapse, matrices,
EmptyDrops_CR cell calling, Solo.out files), once a job: pipeline.TIMERS
solo_process."""


def read(rec):
    v = rec["timers"].get("solo_process")
    return v if v else None
