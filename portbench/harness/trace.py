"""What a traced run (--trace 1) reads besides the program's own timers:
host spans at the program's stage boundaries, the device's activity from
torch.profiler, and every fetch_window call of the window, launched again
after it between CUDA events for the kernel's roofline.

window_bytes, the call recorder and queued_ms are frozen copies of
chip_smoke.py's window_bytes, record_fetches and queued_ms (the bring-up
smoke script at the repository's root), cut to what the benchmark needs.
"""
from __future__ import annotations

import time
import weakref

import numpy as np

HBM_BW = 3.35e12          # H100 SXM (NVIDIA data sheet), bytes/s


# ----------------------------------------------------------- host spans
class Spans:
    """records (stage, start ns, end ns) of every pipeline._tick of the
    program by standing a recording subclass in for the class in the
    modules that bind it (ops/pipeline.py and run.py)"""

    def __init__(self, modules):
        self.modules = modules
        self.spans = []

    def __enter__(self):
        base = self.base = self.modules[0]._tick
        spans = self.spans

        class tick(base):
            def __enter__(self):
                self.s_ns = time.time_ns()
                return super().__enter__()

            def __exit__(self, *a):
                r = super().__exit__(*a)
                spans.append((self.key, self.s_ns, time.time_ns()))
                return r

        for m in self.modules:
            m._tick = tick
        return self

    def __exit__(self, *a):
        for m in self.modules:
            m._tick = self.base


def label_gap(spans, a, b):
    """what the host did in [a, b): the three stages whose spans overlap it
    most, by share of the gap, and the share no span covers ("untimed")"""
    if not spans:
        return "untimed 100%"
    keys = [s[0] for s in spans]
    s0 = np.array([s[1] for s in spans], np.int64)
    s1 = np.array([s[2] for s in spans], np.int64)
    ov = np.clip(np.minimum(s1, b) - np.maximum(s0, a), 0, None)
    by = {}
    for k, v in zip(keys, ov.tolist()):
        if v:
            by[k] = by.get(k, 0) + v
    hit = ov > 0
    lo, hi = np.maximum(s0[hit], a), np.minimum(s1[hit], b)
    covered = 0
    if hit.any():
        order = np.argsort(lo)
        lo, hi = lo[order], np.maximum.accumulate(hi[order])
        new = np.ones(len(lo), bool)
        new[1:] = lo[1:] > hi[:-1]
        idx = np.nonzero(new)[0]
        ends = np.append(hi[idx[1:] - 1], hi[-1])
        covered = int((ends - lo[idx]).sum())
    top = sorted(by.items(), key=lambda x: -x[1])[:3]
    parts = [f"{k} {100 * v / (b - a):.0f}%" for k, v in top]
    parts.append(f"untimed {100 * (1 - covered / (b - a)):.0f}%")
    return ", ".join(parts)


# ----------------------------------------------------------- device trace
def device_activity(prof, w0_ns, w1_ns):
    """(busy seconds, top device ops [[name, s]], idle gaps [(start, end)]
    ns, kernel names by count) of the profiler's CUDA events inside the
    window [w0_ns, w1_ns]"""
    from torch.autograd import DeviceType
    starts, ends, names = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        a, b = e.start_ns(), e.end_ns()
        if b <= w0_ns or a >= w1_ns:
            continue
        starts.append(max(a, w0_ns))
        ends.append(min(b, w1_ns))
        names.append(e.name())
    if not starts:
        return 0.0, [], [(w0_ns, w1_ns)], {}
    s = np.array(starts, np.int64)
    e = np.array(ends, np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    # a new busy interval starts where a start lies past every earlier end
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.nonzero(new)[0]
    u_s = s[idx]
    u_e = np.append(reach[idx[1:] - 1], reach[-1])
    busy = float((u_e - u_s).sum()) / 1e9
    gaps = [(w0_ns, int(u_s[0]))] + list(zip(u_e[:-1].tolist(),
                                              u_s[1:].tolist()))
    gaps.append((int(u_e[-1]), w1_ns))
    per = {}
    count = {}
    for n, a, b in zip(names, starts, ends):
        per[n] = per.get(n, 0.0) + (b - a) / 1e9
        count[n] = count.get(n, 0) + 1
    top = sorted(per.items(), key=lambda x: -x[1])[:10]
    return busy, [[n, v] for n, v in top], gaps, count


# ----------------------------------------------------------- the kernel
def window_bytes(torch, start, width, n):
    """bytes a window fetch must move: each distinct 32-byte sector that its
    live windows cover read once, each live window written once, 8 B per
    start (frozen copy of chip_smoke.window_bytes)"""
    live = start[start >= 0].clamp(max=n - width)
    if live.numel() == 0:
        return start.numel() * 8
    s = torch.sort(live).values
    a, b = s // 32, (s + width - 1) // 32
    prev = torch.cat([b.new_full((1,), -1), torch.cummax(b, 0).values[:-1]])
    sectors = int((b - torch.maximum(a, prev + 1) + 1).clamp(min=0).sum())
    return sectors * 32 + live.numel() * width + start.numel() * 8


class FetchRecorder:
    """records every fetch_window call on the card made while active: (weak
    reference to the table, table bytes, a copy of the starts, width); after
    chip_smoke.record_fetches, without its phase attribution"""

    def __init__(self, fetch):
        self.fetch = fetch
        self.calls = []

    def __enter__(self):
        real = self.real = self.fetch.fetch_window
        calls = self.calls

        def recorded(table, start, width):
            out = real(table, start, width)
            if start.numel() and start.is_cuda:
                calls.append((weakref.ref(table), table.numel(),
                              start.clone(), int(width)))
            return out

        self.fetch.fetch_window = recorded
        return self

    def __exit__(self, *a):
        self.fetch.fetch_window = self.real


def queued_ms(torch, items, prep, run, chunk=32):
    """device time in ms of run(prep(item), item) over items, summed per
    call from a pair of CUDA events just around it; each chunk of calls is
    queued behind a sleep kernel so that an event pair brackets its own
    call's kernels (frozen copy of chip_smoke.queued_ms)"""
    def event():
        return torch.cuda.Event(enable_timing=True)
    cycles, total, i = 1 << 24, 0.0, 0
    while i < len(items):
        part = items[i:i + chunk]
        args = [prep(it) for it in part]
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        pairs = []
        for it, x in zip(part, args):
            a, b = event(), event()
            a.record()
            run(x, it)
            b.record()
            pairs.append((a, b))
        if slept.query():
            if cycles >= 1 << 34:
                raise RuntimeError("queued_ms: the host cannot keep ahead")
            cycles *= 4
            continue
        torch.cuda.synchronize()
        total += sum(a.elapsed_time(b) for a, b in pairs)
        i += chunk
    return total


def roofline(torch, fetch, calls):
    """the recorded calls launched again through the kernel's launcher:
    {"kernel_ms", "bound_ms", "bytes", "calls"}.  A table freed since is
    stood in for by an uninitialised one of its size (same offsets, so the
    same access pattern)."""
    subs = {}

    def table(c):
        t = c[0]()
        if t is None:
            t = subs.get(c[1])
            if t is None:
                if len(subs) > 12:
                    subs.clear()
                t = subs[c[1]] = torch.empty(c[1], dtype=torch.int8,
                                             device="cuda")
        return t

    ms = queued_ms(torch, calls, table,
                   lambda t, c: fetch.fetch_window(t, c[2], c[3]))
    nb = sum(window_bytes(torch, c[2], c[3], c[1]) for c in calls)
    return {"kernel_ms": ms, "bound_ms": nb / HBM_BW * 1e3, "bytes": nb,
            "calls": len(calls)}
