"""Share (%) of its roofline that the fetch_window kernel
(ops/csrc/fetch_rows.cu) reaches over the window's calls: the least time the
bytes the calls need take at 3.35 TB/s (each distinct 32-byte sector read
once, each window written once, 8 B a start) over the kernel time of the
same calls launched again after the window, each between its own CUDA events
behind a sleep kernel (harness/trace.py roofline)."""


def read(rec):
    f = rec.get("fetch")
    if not f or not f["calls"] or f["kernel_ms"] <= 0:
        return None
    return 100.0 * f["bound_ms"] / f["kernel_ms"]
