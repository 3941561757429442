"""Seconds of the seed loop (the MMP search on the card, sa_search.make_mmp_fn
through make_fused_seed_fn, with its download) per million reads of the
window: pipeline.TIMERS seed_loop."""


def read(rec):
    keys = ['seed_loop']
    if not any(k in rec["timers"] for k in keys) or not rec["reads"]:
        return None
    return sum(rec["timers"].get(k, 0.0) for k in keys) / rec["reads"] * 1e6
