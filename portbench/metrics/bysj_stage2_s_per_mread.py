"""Host seconds of BySJout's stage 2 (run.py: the stage-1 junctions collapsed
and filtered, and the reads held for a novel junction mapped again on the
host with their output) per million reads of the window: pipeline.TIMERS
bysj_stage2.  A job traced with the job's scope (TIMERS untimed) that held
no read reads 0; a program without the span (no pipeline.COUNTS beside it)
reads nothing."""
import sys


def read(rec):
    t = rec["timers"]
    if "untimed" not in t or not rec["reads"]:
        return None
    pipeline = sys.modules.get("star_tpu_torch.ops.pipeline")
    if "bysj_stage2" not in t and not hasattr(pipeline, "COUNTS"):
        return None
    return t.get("bysj_stage2", 0.0) / rec["reads"] * 1e6
