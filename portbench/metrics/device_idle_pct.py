"""Share (%) of the window in which no operation ran on the card:
100 x (1 - union of the CUDA activity torch.profiler recorded / the
window).  The profiler has been seen to drop events; a run prints the
kernels it saw against fetch.LAUNCHES, and where it saw fewer the share is
an upper bound."""


def read(rec):
    if "busy_s" not in rec or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
