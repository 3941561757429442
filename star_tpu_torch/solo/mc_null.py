"""EmptyDrops_CR's Monte-Carlo null and its count of lower simulations.

Simulation ``isim`` of ``sim_n`` draws ``max_count`` genes from the ambient
profile with std::mt19937 seeded ``(19760110 * (isim + 1)) mod 2^32`` and
libstdc++'s ``discrete_distribution`` (a ``generate_canonical<double, 53>``
uniform, two words low first, and the lower bound of it in the cumulative
profile ``cp``), and sums its log-probability after each draw in double in
the reference's order: ``row[ic] = ((row[ic - 1] + logp[g]) + logtab[ic])
- logtab[cur[g]]``, ``cur[g]`` the draws of gene g so far and ``logtab[k]``
the host's ``math.log(k)``.  A candidate of ``c`` UMIs and observed
log-probability ``o`` has ``n_lower`` = the simulations whose ``row[c] < o``.

The candidates come grouped by their UMI count (``group_count``, ascending
and distinct, at most ``max_count = len(logtab) - 1``), each group's
observed values sorted (``obs[group_off[g]:group_off[g + 1]]``,
``group_candidates`` makes them).  Each simulation that reaches a group's
count adds one to the slot of the group's histogram that its row falls in
(the group's values ``<=`` it); a prefix sum of the histogram gives the
n_lower of each candidate in that order.

On CUDA tensors ``null_histogram`` launches the hand-written kernel
``ops/csrc/emptydrops.cu`` (one thread per simulation; ``LAUNCHES`` counts
its launches); on CPU tensors it takes the plain PyTorch version
``_null_histogram_torch``, vectorised across the simulations.  There is no
fallback between the two.  The kernel replaces no TPU kernel: star_tpu runs
this loop in Python.  It is bound by a serial chain of dependent integer
steps per thread (up to 623 seeding steps, then two twists, a binary search
and a hash probe per draw), not by bytes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

LAUNCHES = 0          # kernel launches of null_histogram (CUDA tensors only)
SHARED_BYTES = 232448  # shared memory a block can use on Hopper (227 KB)
CHUNK = 2048          # simulations per pass of the plain version

_N, _M = 624, 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


def group_candidates(counts, obs):
    """(group_count, group_off, obs_sorted, order) of candidates with UMI
    counts `counts` and observed log-probabilities `obs`: the distinct
    counts ascending, each group's start in the sorted values, the values
    sorted by (count, value), and the candidates' indices in that order"""
    counts = np.asarray(counts, dtype=np.int64)
    obs = np.asarray(obs, dtype=np.float64)
    order = np.lexsort((obs, counts))
    group_count, first = np.unique(counts[order], return_index=True)
    group_off = np.append(first, len(order))
    return group_count, group_off, obs[order], order


def _check(cp, logp, logtab, group_count, group_off, obs, sim_n):
    dev = cp.device
    for name, t, dt in (("cp", cp, torch.float64),
                        ("logp", logp, torch.float64),
                        ("logtab", logtab, torch.float64),
                        ("group_count", group_count, torch.int32),
                        ("group_off", group_off, torch.int32),
                        ("obs", obs, torch.float64)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"null_histogram: {name} must be a contiguous "
                             f"1-D {dt} tensor")
        if t.device != dev:
            raise ValueError(f"null_histogram: {name} on {t.device}, cp on "
                             f"{dev}")
    if cp.numel() < 1 or logp.numel() != cp.numel():
        raise ValueError("null_histogram: cp and logp must have one entry "
                         "per gene, at least one")
    if logtab.numel() < 1 or group_off.numel() != group_count.numel() + 1:
        raise ValueError("null_histogram: logtab needs log(0..max_count), "
                         "group_off one entry more than group_count")
    if not 0 <= int(sim_n) < 2**31 - 128:
        raise ValueError(f"null_histogram: sim_n {sim_n} out of range")


def null_histogram(cp, logp, logtab, group_count, group_off, obs,
                   sim_n: int) -> torch.Tensor:
    """the groups' histograms of the simulations' rows: int32
    [len(obs) + len(group_count)] on the tensors' device (module doc)"""
    _check(cp, logp, logtab, group_count, group_off, obs, sim_n)
    if cp.is_cuda:
        return _null_histogram_cuda(cp, logp, logtab, group_count, group_off,
                                    obs, int(sim_n))
    return _null_histogram_torch(cp, logp, logtab, group_count, group_off,
                                 obs, int(sim_n))


def n_lower(cp, logp, logtab, group_count, group_off, obs,
            sim_n: int) -> np.ndarray:
    """n_lower of each candidate in the grouped order (module doc): each
    group's prefix sums of its histogram, the last slot (below none)
    dropped"""
    hist = null_histogram(cp, logp, logtab, group_count, group_off, obs,
                          sim_n).cpu().numpy().astype(np.int64)
    go = group_off.tolist()
    out = np.empty(go[-1], dtype=np.int64)
    for g in range(len(go) - 1):
        out[go[g]:go[g + 1]] = np.cumsum(hist[go[g] + g:go[g + 1] + g])
    return out


# ------------------------------------------------------------ plain version
def mt_seed(seeds: torch.Tensor) -> torch.Tensor:
    """std::mt19937's seeded state: int64 [624, S] for uint32 seeds [S]"""
    mt = torch.empty((_N, seeds.numel()), dtype=torch.int64,
                     device=seeds.device)
    x = seeds.to(torch.int64) & _MASK32
    mt[0] = x
    for i in range(1, _N):
        x = (1812433253 * (x ^ (x >> 30)) + i) & _MASK32
        mt[i] = x
    return mt


def mt_twist(mt: torch.Tensor) -> torch.Tensor:
    """the next generation of [624, S] states, in the generator's order: a
    word reads the new words 227 before it (i + 397 - 624) and, for the
    last, the new first word"""
    new = torch.empty_like(mt)
    for a, b in ((0, 227), (227, 454), (454, 623), (623, 624)):
        nxt = mt[a + 1:b + 1] if b < _N else new[0:1]
        y = (mt[a:b] & _UPPER) | (nxt & _LOWER)
        src = (mt[a + _M:b + _M] if b <= _N - _M
               else new[a + _M - _N:b + _M - _N])
        new[a:b] = src ^ (y >> 1) ^ ((y & 1) * _MATRIX_A)
    return new


def mt_words(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """the first n >= 1 tempered words of std::mt19937 for each seed:
    int64 [n, S]"""
    mt = mt_seed(seeds)
    out = []
    for _ in range(-(-n // _N)):
        mt = mt_twist(mt)
        y = mt ^ (mt >> 11)
        y = y ^ ((y << 7) & 0x9D2C5680)
        y = y ^ ((y << 15) & 0xEFC60000)
        out.append(y ^ (y >> 18))
    return torch.cat(out)[:n]


def canonical(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """generate_canonical<double, 53> of two words, low first, clamped
    below 1.0"""
    u = (w0.double() + w1.double() * 4294967296.0) * 2.0 ** -64
    return torch.where(u >= 1.0, torch.full_like(u, 1.0 - 2.0 ** -53), u)


def occurrences(ig: torch.Tensor) -> torch.Tensor:
    """[M, S] genes drawn -> [M, S] the draw's count of its gene so far
    (1 at a gene's first draw), per column"""
    m = ig.shape[0]
    steps = torch.arange(m, dtype=torch.int64, device=ig.device)[:, None]
    key, perm = torch.sort(ig * (m + 1) + steps, dim=0)
    gene = key // (m + 1)
    start = torch.ones_like(gene, dtype=torch.bool)
    start[1:] = gene[1:] != gene[:-1]
    first = torch.where(start, steps.expand_as(gene), torch.zeros_like(gene))
    occ = steps - torch.cummax(first, dim=0).values + 1
    return torch.empty_like(occ).scatter_(0, perm, occ)


def _null_histogram_torch(cp, logp, logtab, group_count, group_off, obs,
                          sim_n):
    """plain version: the simulations CHUNK at a time, each step of the row
    one vector operation over them"""
    dev = cp.device
    max_count = logtab.numel() - 1
    gc = group_count.tolist()
    go = group_off.tolist()
    hist = torch.zeros(go[-1] + len(gc), dtype=torch.int64, device=dev)

    def count(g, row):
        lo, hi = go[g], go[g + 1]
        k = torch.searchsorted(obs[lo:hi], row, right=True)
        hist[lo + g:hi + g + 1] += torch.bincount(k, minlength=hi - lo + 1)

    for s0 in range(0, sim_n, CHUNK):
        isim = torch.arange(s0, min(s0 + CHUNK, sim_n), dtype=torch.int64,
                            device=dev)
        row = torch.zeros(isim.numel(), dtype=torch.float64, device=dev)
        g = 0
        if g < len(gc) and gc[g] == 0:
            count(g, row)
            g += 1
        if max_count:
            w = mt_words((19760110 * (isim + 1)) & _MASK32, 2 * max_count)
            u = canonical(w[0::2], w[1::2])
            ig = torch.searchsorted(cp, u, right=False).clamp_(
                max=cp.numel() - 1)
            lp = logp[ig]
            lc = logtab[occurrences(ig)]
            for ic in range(1, max_count + 1):
                row = ((row + lp[ic - 1]) + logtab[ic]) - lc[ic - 1]
                if g < len(gc) and gc[g] == ic:
                    count(g, row)
                    g += 1
    return hist.to(torch.int32)


# ------------------------------------------------------------------- kernel
def _null_histogram_cuda(cp, logp, logtab, group_count, group_off, obs,
                         sim_n):
    global LAUNCHES
    dev = cp.device
    max_count = logtab.numel() - 1
    n_groups = group_count.numel()
    slot_bits = max(1, (2 * max_count - 1).bit_length())
    hist = torch.zeros(obs.numel() + n_groups, dtype=torch.int32, device=dev)
    state = torch.empty((_N, sim_n), dtype=torch.int32, device=dev)
    table = torch.empty((1 << slot_bits, sim_n, 2), dtype=torch.int32,
                        device=dev)
    if sim_n == 0:
        return hist
    shared = 16 * cp.numel() <= SHARED_BYTES
    rc = _lib().mc_null_launch(
        cp.data_ptr(), logp.data_ptr(), cp.numel(), logtab.data_ptr(),
        max_count, group_count.data_ptr(), group_off.data_ptr(), n_groups,
        obs.data_ptr(), hist.data_ptr(), state.data_ptr(), table.data_ptr(),
        slot_bits, sim_n,
        int(shared), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("mc_null kernel launch failed: "
                           + _lib().mc_null_error_string(rc).decode())
    LAUNCHES += 1
    return hist


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..ops import _build
        lib = _build.load("emptydrops")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.mc_null_launch.restype = ctypes.c_int
        lib.mc_null_launch.argtypes = [p, p, i64, p, i64, p, p, i64, p, p, p,
                                       p, i64, i64, i64, p]
        lib.mc_null_error_string.restype = ctypes.c_char_p
        lib.mc_null_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


def load() -> None:
    """build (at a checkout's first use) and load the kernel's library"""
    _lib()
