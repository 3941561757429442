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
converged, so the typical SAi-narrowed bisection ends in a few steps.

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


def make_mmp_fn(di: DeviceIndex):
    """returns a function
        mmp(queries [B, QL] int8 (-1 padded), qlen [B], valid=None)
            -> (maxL, nrep, lo, hi) each [B] int64
    on tensors on di.device."""
    L = di.n_levels
    QL = di.ql
    n_sa = di.n_sa
    dev = di.device
    lvl_start = torch.tensor(di.level_start[:-1], dtype=torch.int64, device=dev)
    lvl_end = torch.tensor(di.level_start[1:], dtype=torch.int64, device=dev)
    t2f, saf, saif = di.t2f, di.saf, di.saif

    def lcp_lt(g, qpad, qlen):
        """lcp(query, suffix bytes g) and suffix<query, over the QL window.
        qpad padding: -1 => query smaller (prefix semantics), 127 => larger."""
        neq = qpad != g
        has = neq.any(dim=1)
        # argmax returns the index of the FIRST maximum: the first mismatch
        first = neq.to(torch.uint8).argmax(dim=1)
        lcp = torch.minimum(torch.where(has, first, QL), qlen)
        qc = qpad.gather(1, first[:, None])[:, 0]
        gc = g.gather(1, first[:, None])[:, 0]
        return lcp, has & (gc < qc)

    def suffix_window(rows, run):
        """SA rows -> suffix byte windows [B, QL]; lanes not in run are
        skipped (junk)"""
        sa = fetch.fetch_window(saf, torch.where(run, rows * 4, -1), 4)
        pos = sa.view(torch.int32)[:, 0].long()
        return fetch.fetch_window(t2f, torch.where(run, pos, -1), QL)

    def lower_bound(qpad, qlen, lo, hi):
        """first row in [lo0, hi0) whose suffix >= query; the loop runs
        until every lane has converged"""
        while bool((lo < hi).any()):
            run = lo < hi
            mid = (lo + hi) // 2
            g = suffix_window(mid, run)
            _, lt = lcp_lt(g, qpad, qlen)
            lo = torch.where(run & lt, mid + 1, lo)
            hi = torch.where(run & ~lt, mid, hi)
        return lo

    def mmp(queries, qlen, valid=None):
        B = queries.shape[0]
        q = queries.clamp(min=-1)
        qlen = qlen.long()
        if valid is None:
            valid = torch.ones(B, dtype=torch.bool, device=dev)

        # ---- SAi prefix values at each level (base-4 over raw byte codes,
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

        # ---- SAi descent (reference: reduce Lind while prefix absent);
        # typically resolves in one fetch because full-depth prefixes of real
        # reads are present
        lind = lmax.clamp(min=1)
        done = ~valid
        z = torch.zeros(B, dtype=torch.int64, device=dev)
        v1, v2, off = z, z, z
        while bool((~done).any()):
            off_n = lvl_start[lind - 1] + ind
            # entries off_n and off_n + 1; the four bytes of each are
            # reinterpreted, so "prefix absent" stays in the sign bit
            pair = fetch.fetch_window(saif, torch.where(done, -1, off_n * 4),
                                      8).view(torch.int32)
            v1 = torch.where(done, v1, pair[:, 0].long())
            v2 = torch.where(done, v2, pair[:, 1].long())
            off = torch.where(done, off, off_n)
            absent = v1 < 0
            step = ~done & absent & (lind > 1)
            done = done | ~absent | (lind <= 1)
            lind = torch.where(step, lind - 1, lind)
            ind = torch.where(step, ind >> 2, ind)

        isa1 = v1 & _VAL_MASK
        no_n = (v1 & _NBIT) == 0
        has_next = off + 1 < lvl_end[lind - 1]
        good = has_next & (v2 >= 0)
        isa2 = torch.where(good, (v2 & _VAL_MASK) - 1, n_sa - 1)
        # Tight search bound even when the next SAi entry is absent: absent
        # entries store the next PRESENT block start, so rows with this
        # prefix still end at value-1.  The reference searches [iSA1, nSA-1]
        # there; the result is provably identical because the query starts
        # with the present prefix, so its insertion point, lcp neighbors and
        # equal range all live inside the tight interval.  Only the returned
        # bounds of a 0-length match use the reference's loose i2 (below).
        i2s = torch.where(has_next, (v2 & _VAL_MASK) - 1, n_sa - 1)

        case1 = ((lind < L) & no_n & good) | ~valid
        case2 = ~case1 & (isa1 == isa2) & no_n & good
        # case 4 — search-free resolution the reference misses: if the
        # descent stopped below Lmax, the (Lind+1)-prefix is ABSENT, so
        # maxL == Lind exactly and the equal range is the whole SAi block
        # [isa1, i2s].  Same when Lind == qlen: the full query matched at
        # SAi level.  Requires has_next so the block end is known, and no_n:
        # an N-flagged block also holds rows that leave the prefix at a
        # spacer or the text end (e.g. "0" + spacer inside the "03" block),
        # which the full search excludes.  (star_tpu's case 4 omits no_n and
        # so differs from the host oracle on such queries.)  The reference
        # runs its full double binary search here with identical output.
        case4 = ~case1 & ~case2 & has_next & no_n \
            & ((lind < lmax) | (lind >= qlen))
        case3 = ~case1 & ~case2 & ~case4
        l0 = torch.where(good & no_n, lind, 0)

        # ---- case-3 insertion-point search in [i1, i2s]
        i1, i2 = isa1, i2s
        ins = lower_bound(q, qlen, torch.where(case3, i1, 0),
                          torch.where(case3, i2 + 1, 0))

        # ---- neighbor lcps (case 3) + the case-2 single compare, one batch
        rows_a = torch.where(case2, isa1, torch.minimum(ins, i2))
        rows_b = torch.where(case2, isa1, torch.maximum(ins - 1, i1))
        run_a = case2 | (case3 & (ins <= i2))
        run_b = case3 & (ins - 1 >= i1)
        g2 = suffix_window(torch.cat([rows_a, rows_b]),
                           torch.cat([run_a, run_b]))
        l2, _ = lcp_lt(g2, torch.cat([q, q]), torch.cat([qlen, qlen]))
        l_a = torch.where(run_a, l2[:B], 0)
        l_b = torch.where(run_b, l2[B:], 0)
        best = torch.maximum(torch.maximum(l_a, l_b),
                             torch.where(case3, l0, 0))

        # ---- equal range of the best prefix within [i1, i2] (case 3)
        nz = case3 & (best > 0)
        keep = torch.arange(QL, device=dev)[None, :] < best[:, None]
        qr = torch.cat([torch.where(keep, q, -1), torch.where(keep, q, 127)])
        b0 = torch.where(nz, i1, 0)
        b1 = torch.where(nz, i2 + 1, 0)
        bounds = lower_bound(qr, torch.cat([best, best]),
                             torch.cat([b0, b0]), torch.cat([b1, b1]))
        # a 0-length match reports the reference's loose [iSA1, iSA2] bounds
        lo1 = torch.where(nz, bounds[:B], isa1)
        hi1 = torch.where(nz, bounds[B:] - 1, isa2)

        # ---- combine the cases
        max_l = torch.where(case1 | case4, lind,
                            torch.where(case2, l_a, torch.where(nz, best, 0)))
        lo_out = torch.where(case1 | case2 | case4, isa1, lo1)
        hi_out = torch.where(case1, isa2,
                             torch.where(case2, isa1,
                                         torch.where(case4, i2s, hi1)))
        return max_l, hi_out - lo_out + 1, lo_out, hi_out

    return mmp
