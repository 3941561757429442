"""Seconds of EmptyDrops_CR's Monte-Carlo null (solo/emptydrops.py: the
simulations and each candidate's count of lower ones, inside solo_filter),
once a job: pipeline.TIMERS solo_mc.  A job traced with the job's scope
(TIMERS untimed) in which no Monte-Carlo step ran reads 0; a program
without the span (no solo/mc_null.py) reads nothing."""
import importlib.util


def read(rec):
    t = rec["timers"]
    if "untimed" not in t:
        return None
    if "solo_mc" not in t and \
            importlib.util.find_spec("star_tpu_torch.solo.mc_null") is None:
        return None
    return t.get("solo_mc", 0.0)
