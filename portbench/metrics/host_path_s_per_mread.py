"""Host seconds of the per-read host finish (ops/pipeline.py _align_batch:
finish_read for the reads the batch engine left, inside finish) per million
reads of the window: pipeline.TIMERS host_path.  A job traced with the
job's scope (TIMERS untimed) in which no read took the host path reads 0."""


def read(rec):
    t = rec["timers"]
    if "untimed" not in t or not rec["reads"]:
        return None
    return t.get("host_path", 0.0) / rec["reads"] * 1e6
