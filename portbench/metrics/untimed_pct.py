"""Share (%) of the window that the job spent outside every top-level host
span (run.py align_reads, the job's scope): 100 x pipeline.TIMERS untimed /
the window."""


def read(rec):
    if "untimed" not in rec["timers"] or rec["window_s"] <= 0:
        return None
    return 100.0 * rec["timers"]["untimed"] / rec["window_s"]
