"""Batched MMP seed search on the device (PyTorch + the fetch_window kernel).

Thousands of (read, start, direction) probes are resolved per call: SAi
prefix descent, then binary search over the suffix array of the doubled text
T2.  One uniform byte comparator covers all read-direction x genome-strand
cases (see genome/fasta.py build_t2).  Results are bit-identical to the host
reference (align.seed.mmp_search) and to star_tpu.ops.sa_search; tests
enforce this.

Every random access is one byte window of ops.fetch.fetch_window, called
through the module attribute: the packed SAi pair (value and flag bits in one
int32 each, 8 bytes), the SA row (4 bytes) and the suffix text (QL bytes).
Each search loop is a Python ``while`` that runs until every lane has
converged, so the typical SAi-narrowed bisection ends in a few steps.  The
SAi descent (sai_descent), the case resolution (resolve_mmp) and the two
searches' steps (neighbour_lcp, prefix_bounds) also serve the sharded index
(parallel/mesh.py).

Reference behavior replicated: source/ReadAlign_maxMappableLength2strands.cpp
(SAi descent + the 3 result cases), source/SuffixArrayFuns.cpp:133-207
(maxMappableLength double binary search).  The index arrays live in device
memory for the whole run (the analog of the reference's shared-memory genome
residency, source/SharedMemory.cpp).

Capacity: this single-device index requires n_sa < 2^30 (the packed SAi keeps
30 value bits) and a doubled text under 2 GiB (SA rows stored as int32).
Byte offsets into the tables are int64.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import fetch
from .fetch import TILE, pad_table, resolve_device

_VAL_MASK = 0x3FFFFFFF   # packed SAi: low 30 bits = value
_NBIT = 1 << 30          # bit 30 = prefix crosses an N/spacer
# bit 31 (sign) = prefix absent


def pack_sai(gi) -> np.ndarray:
    """SAi (value, absent, nbit) planes -> one int32 entry per slot"""
    if gi.n_sa >= _NBIT:
        raise ValueError("packed SAi requires n_sa < 2^30 (use sharded path)")
    v = gi.sai_val.astype(np.int64) & _VAL_MASK
    v |= gi.sai_nbit.astype(np.int64) << 30
    v |= gi.sai_absent.astype(np.int64) << 31
    return v.astype(np.uint32).view(np.int32)


@dataclass
class DeviceIndex:
    """device-resident genome index tables (byte-fetchable layout)"""
    t2f: torch.Tensor      # int8, padded (genome doubled text)
    saf: torch.Tensor      # int8 view of int32 SA rows, padded
    saif: torch.Tensor     # int8 view of packed-int32 SAi, padded
    level_start: tuple     # python ints, len L+1
    n_sa: int
    n_levels: int
    ql: int                # max query length (padded compare window)
    device: torch.device

    @classmethod
    def build(cls, gi, ql: int = 512, device=None):
        if ql > TILE:
            raise ValueError("query window must fit one fetch tile")
        if 2 * gi.n_genome + ql >= 2**31 or gi.n_sa >= _VAL_MASK:
            raise ValueError("single-device index requires <2GiB tables "
                             "(use sharded path)")
        device = resolve_device(device)
        put = lambda a: torch.from_numpy(a).to(device)
        return cls(
            t2f=put(pad_table(gi.t2)),
            saf=put(pad_table(gi.sa.astype(np.int32))),
            saif=put(pad_table(pack_sai(gi))),
            level_start=tuple(int(x) for x in gi.sai_level_start),
            n_sa=gi.n_sa,
            n_levels=gi.sa_index_nbases,
            ql=ql,
            device=device,
        )


def lcp_lt(g, qpad, qlen):
    """lcp(query, suffix bytes g) and suffix<query, over the query window.
    qpad padding: -1 => query smaller (prefix semantics), 127 => larger."""
    neq = qpad != g
    has = neq.any(dim=1)
    # argmax returns the index of the FIRST maximum: the first mismatch
    first = neq.to(torch.uint8).argmax(dim=1)
    lcp = torch.minimum(torch.where(has, first, qpad.shape[1]), qlen)
    qc = qpad.gather(1, first[:, None])[:, 0]
    gc = g.gather(1, first[:, None])[:, 0]
    return lcp, has & (gc < qc)


# SAi entry layouts: (dtype, value mask, N-flag bit); the sign bit marks an
# absent prefix in both.  DeviceIndex packs an entry into one int32; the
# sharded index (parallel/mesh.py) into one int64, for n_sa >= 2^30.
SAI32 = (torch.int32, _VAL_MASK, _NBIT)
SAI64 = (torch.int64, (1 << 62) - 1, 1 << 62)


def sai_descent(saif, layout, level_start, n_sa, q, qlen, valid):
    """SAi prefix descent of a batch (reference: reduce Lind while the
    prefix is absent) over the packed SAi byte table saif.  Returns
    (lind, lmax, isa1, isa2, i2s, no_n, good, has_next) [B] tensors, isa2
    the reference's SAi bound and i2s the tight one (see make_mmp_fn).
    Lanes not valid do no fetch and come out as case 1 of make_mmp_fn."""
    dtype, val_mask, nbit = layout
    esize = torch.tensor([], dtype=dtype).element_size()
    L = len(level_start) - 1
    B = q.shape[0]
    dev = q.device
    lvl_start = torch.tensor(level_start[:-1], dtype=torch.int64, device=dev)
    lvl_end = torch.tensor(level_start[1:], dtype=torch.int64, device=dev)

    # SAi prefix values at each level (base-4 over raw byte codes,
    # bug-compatible with the reference's unchecked index arithmetic)
    qn = q[:, :L].clamp(min=0).long()
    acc = torch.zeros(B, dtype=torch.int64, device=dev)
    prefix_vals = []
    for l in range(L):
        acc = acc * 4 + qn[:, l]
        prefix_vals.append(acc)
    prefix_vals = torch.stack(prefix_vals, dim=1)  # [B, L]; level l+1 at col l

    lmax = torch.clamp(qlen, max=L)
    ind = prefix_vals.gather(1, (lmax - 1).clamp(min=0)[:, None])[:, 0]

    # typically resolves in one fetch because full-depth prefixes of real
    # reads are present
    lind = lmax.clamp(min=1)
    done = ~valid
    z = torch.zeros(B, dtype=torch.int64, device=dev)
    v1, v2, off = z, z, z
    while bool((~done).any()):
        off_n = lvl_start[lind - 1] + ind
        # entries off_n and off_n + 1; the bytes of each are reinterpreted,
        # so "prefix absent" stays in the sign bit
        pair = fetch.fetch_window(saif, torch.where(done, -1, off_n * esize),
                                  2 * esize).view(dtype)
        v1 = torch.where(done, v1, pair[:, 0].long())
        v2 = torch.where(done, v2, pair[:, 1].long())
        off = torch.where(done, off, off_n)
        absent = v1 < 0
        step = ~done & absent & (lind > 1)
        done = done | ~absent | (lind <= 1)
        lind = torch.where(step, lind - 1, lind)
        ind = torch.where(step, ind >> 2, ind)

    isa1 = v1 & val_mask
    no_n = (v1 & nbit) == 0
    has_next = off + 1 < lvl_end[lind - 1]
    good = has_next & (v2 >= 0)
    isa2 = torch.where(good, (v2 & val_mask) - 1, n_sa - 1)
    i2s = torch.where(has_next, (v2 & val_mask) - 1, n_sa - 1)
    return lind, lmax, isa1, isa2, i2s, no_n, good, has_next


def resolve_mmp(L, q, qlen, valid, desc, best_lcp, equal_range):
    """(maxL, nrep, lo, hi) [B] int64 of a batch from its SAi descent desc
    (sai_descent) and two searches over the suffix array rows [lo, hi):
        best_lcp(q, qlen, lo, hi, lanes) -> [B] the longest lcp of the
            query's insertion neighbours (neighbour_lcp);
        equal_range(q, best, lo, hi, lanes) -> ([B], [B]) the first and
            one past the last row that share the query's first best bases
            (prefix_bounds).
    make_mmp_fn searches one index; parallel/mesh.py make_sharded_mmp
    searches each shard's clip of the rows and combines."""
    lind, lmax, isa1, isa2, i2s, no_n, good, has_next = desc
    # i2s is the tight search bound even when the next SAi entry is absent:
    # absent entries store the next PRESENT block start, so rows with this
    # prefix still end at value-1.  The reference searches [iSA1, nSA-1]
    # there; the result is provably identical because the query starts with
    # the present prefix, so its insertion point, lcp neighbors and equal
    # range all live inside the tight interval.  Only the returned bounds of
    # a 0-length match use the reference's loose i2 (isa2, below).
    case1 = ((lind < L) & no_n & good) | ~valid
    case2 = ~case1 & (isa1 == isa2) & no_n & good
    # case 4 — search-free resolution the reference misses: if the descent
    # stopped below Lmax, the (Lind+1)-prefix is ABSENT, so maxL == Lind
    # exactly and the equal range is the whole SAi block [isa1, i2s].  Same
    # when Lind == qlen: the full query matched at SAi level.  Requires
    # has_next so the block end is known, and no_n: an N-flagged block also
    # holds rows that leave the prefix at a spacer or the text end (e.g.
    # "0" + spacer inside the "03" block), which the full search excludes.
    # (star_tpu's case 4 omits no_n and so differs from the host oracle on
    # such queries.)  The reference runs its full double binary search here
    # with identical output.
    case4 = ~case1 & ~case2 & has_next & no_n \
        & ((lind < lmax) | (lind >= qlen))
    case3 = ~case1 & ~case2 & ~case4
    l0 = torch.where(good & no_n, lind, 0)

    # ---- insertion-point neighbours in [isa1, i2s]: case 3, and case 2's
    # single row
    best = best_lcp(q, qlen, isa1, i2s + 1, case2 | case3)
    best = torch.where(case3, torch.maximum(best, l0), best)

    # ---- equal range of the best prefix within [isa1, i2s] (case 3)
    nz = case3 & (best > 0)
    lo1, end1 = equal_range(q, best, isa1, i2s + 1, nz)
    # a 0-length match reports the reference's loose [iSA1, iSA2] bounds
    lo1 = torch.where(nz, lo1, isa1)
    hi1 = torch.where(nz, end1 - 1, isa2)

    # ---- combine the cases
    max_l = torch.where(case1 | case4, lind,
                        torch.where(case2 | nz, best, 0))
    lo_out = torch.where(case1 | case2 | case4, isa1, lo1)
    hi_out = torch.where(case1, isa2,
                         torch.where(case2, isa1,
                                     torch.where(case4, i2s, hi1)))
    return max_l, hi_out - lo_out + 1, lo_out, hi_out


def lower_bound(suffix_window, qpad, qlen, lo, hi):
    """first row in [lo0, hi0) whose suffix (suffix_window(rows, run) ->
    [B, QL] bytes) >= query; the loop runs until every lane has converged"""
    while bool((lo < hi).any()):
        run = lo < hi
        mid = (lo + hi) // 2
        _, lt = lcp_lt(suffix_window(mid, run), qpad, qlen)
        lo = torch.where(run & lt, mid + 1, lo)
        hi = torch.where(run & ~lt, mid, hi)
    return lo


def neighbour_lcp(suffix_window, q, qlen, lo, hi, lanes):
    """the longest lcp of the query's two insertion neighbours among rows
    [lo, hi) (0 off lanes and where the rows are empty)"""
    live = lanes & (lo < hi)
    ins = lower_bound(suffix_window, q, qlen, torch.where(live, lo, 0),
                      torch.where(live, hi, 0))
    run_a = live & (ins < hi)
    run_b = live & (ins > lo)
    g = suffix_window(torch.cat([torch.minimum(ins, hi - 1),
                                 torch.maximum(ins - 1, lo)]),
                      torch.cat([run_a, run_b]))
    B = q.shape[0]
    l2, _ = lcp_lt(g, torch.cat([q, q]), torch.cat([qlen, qlen]))
    return torch.maximum(torch.where(run_a, l2[:B], 0),
                         torch.where(run_b, l2[B:], 0))


def prefix_bounds(suffix_window, q, best, lo, hi, lanes):
    """the first and one past the last of rows [lo, hi) whose suffix starts
    with the query's first best bases (equal where there is none)"""
    B, QL = q.shape
    keep = torch.arange(QL, device=q.device)[None, :] < best[:, None]
    qr = torch.cat([torch.where(keep, q, -1), torch.where(keep, q, 127)])
    b0 = torch.where(lanes, lo, 0)
    b1 = torch.where(lanes, hi, 0)
    bounds = lower_bound(suffix_window, qr, torch.cat([best, best]),
                         torch.cat([b0, b0]), torch.cat([b1, b1]))
    return bounds[:B], bounds[B:]


def make_mmp_fn(di: DeviceIndex):
    """returns a function
        mmp(queries [B, QL] int8 (-1 padded), qlen [B], valid=None)
            -> (maxL, nrep, lo, hi) each [B] int64
    on tensors on di.device."""
    L = di.n_levels
    QL = di.ql
    dev = di.device
    t2f, saf, saif = di.t2f, di.saf, di.saif

    def suffix_window(rows, run):
        """SA rows -> suffix byte windows [B, QL]; lanes not in run are
        skipped (junk)"""
        sa = fetch.fetch_window(saf, torch.where(run, rows * 4, -1), 4)
        pos = sa.view(torch.int32)[:, 0].long()
        return fetch.fetch_window(t2f, torch.where(run, pos, -1), QL)

    best_lcp = functools.partial(neighbour_lcp, suffix_window)
    equal_range = functools.partial(prefix_bounds, suffix_window)

    def mmp(queries, qlen, valid=None):
        q = queries.clamp(min=-1)
        qlen = qlen.long()
        if valid is None:
            valid = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
        desc = sai_descent(saif, SAI32, di.level_start, di.n_sa, q, qlen,
                           valid)
        return resolve_mmp(L, q, qlen, valid, desc, best_lcp, equal_range)

    return mmp
