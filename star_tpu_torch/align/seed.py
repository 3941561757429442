"""Maximal Mappable Prefix (MMP) seed search — host reference implementation.

The device path (ops.sa_search) batches thousands of these probes;
this module defines the exact semantics both share (reference behavior:
source/ReadAlign_maxMappableLength2strands.cpp, source/SuffixArrayFuns.cpp
maxMappableLength, source/ReadAlign_mapOneRead.cpp seed loop,
source/ReadAlign_storeAligns.cpp piece bookkeeping).

All suffix comparisons are plain byte comparisons of the query against the
doubled text T2 (see genome/fasta.py), which collapses the reference's four
(read-direction x genome-strand) compare variants into one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..genome.index import GenomeIndex


# --------------------------------------------------------------------- compare
def suffix_cmp(gi: GenomeIndex, Q: np.ndarray, L0: int, row: int) -> Tuple[int, int]:
    """Compare query Q (bytes) against suffix at SA[row], skipping L0 known-
    equal chars.  Returns (lcp, order) with order <0 if Q < suffix, >0 if
    Q > suffix, 0 if Q is fully matched (prefix of suffix)."""
    p = int(gi.sa[row])
    t2 = gi.t2_bytes
    n2 = len(t2)
    nq = len(Q)
    i = L0
    while i < nq:
        g = t2[p + i] if p + i < n2 else 5
        q = Q[i]
        if q != g:
            return i, (1 if q > g else -1)
        i += 1
    return nq, 0


def _lcp(gi, Q, row, L0=0):
    l, _ = suffix_cmp(gi, Q, L0, row)
    return l


def _suffix_less_than_query(gi, Q, row) -> bool:
    _, order = suffix_cmp(gi, Q, 0, row)
    return order > 0  # Q > suffix


def _suffix_prefix_less(gi, Qp, row) -> bool:
    """suffix < prefix Qp strictly (prefix-match => not less)"""
    _, order = suffix_cmp(gi, Qp, 0, row)
    return order > 0


def _suffix_prefix_greater(gi, Qp, row) -> bool:
    """suffix > prefix Qp strictly (prefix-match => not greater)"""
    _, order = suffix_cmp(gi, Qp, 0, row)
    return order < 0


def mmp_full_search(gi: GenomeIndex, Q: np.ndarray, i1: int, i2: int, L0: int):
    """Longest-prefix match of Q among suffixes SA[i1..i2] (inclusive).

    Returns (maxL, lo, hi).  Equivalent to the reference's double binary
    search: maxL = max lcp over the range; [lo,hi] = the contiguous rows
    achieving it (= the SA block of prefix Q[:maxL] inside [i1,i2])."""
    # find insertion point of Q in [i1, i2+1)
    lo, hi = i1, i2 + 1
    while lo < hi:
        mid = (lo + hi) // 2
        if _suffix_less_than_query(gi, Q, mid):
            lo = mid + 1
        else:
            hi = mid
    # neighbors of the insertion point achieve the max lcp
    best = L0
    if lo <= i2:
        best = max(best, _lcp(gi, Q, lo))
    if lo - 1 >= i1:
        best = max(best, _lcp(gi, Q, lo - 1))
    if best == 0:
        return 0, i1, i2
    Qp = Q[:best]
    # equal range of prefix Q[:best] within [i1, i2]
    a, b = i1, i2 + 1
    while a < b:
        mid = (a + b) // 2
        if _suffix_prefix_less(gi, Qp, mid):
            a = mid + 1
        else:
            b = mid
    lo1 = a
    a, b = lo1, i2 + 1
    while a < b:
        mid = (a + b) // 2
        if _suffix_prefix_greater(gi, Qp, mid):
            b = mid
        else:
            a = mid + 1
    hi1 = a - 1
    return best, lo1, hi1


def sai_lookup(gi: GenomeIndex, Q: np.ndarray):
    """SAi prefix lookup -> (Lind, iSA1, iSA2, noN, iSA2good)
    (reference: ReadAlign_maxMappableLength2strands.cpp:23-64)."""
    Lmax = min(gi.sa_index_nbases, len(Q))
    ind1 = 0
    for ii in range(Lmax):
        ind1 = (ind1 << 2) + int(Q[ii])
    Lind = Lmax
    while Lind > 0:
        off = int(gi.sai_level_start[Lind - 1]) + ind1
        if not gi.sai_absent[off]:
            break
        Lind -= 1
        ind1 >>= 2
    iSA1 = int(gi.sai_val[off])
    noN = not bool(gi.sai_nbit[off])
    if int(gi.sai_level_start[Lind - 1]) + ind1 + 1 < int(gi.sai_level_start[Lind]):
        off2 = off + 1
        if not gi.sai_absent[off2]:
            iSA2 = int(gi.sai_val[off2]) - 1
            good = True
        else:
            iSA2 = gi.n_sa - 1
            good = False
    else:
        iSA2 = gi.n_sa - 1
        good = False
    return Lind, iSA1, iSA2, noN, good


def mmp_search(gi: GenomeIndex, Q: np.ndarray):
    """One MMP probe: returns (maxL, nRep, lo, hi)."""
    Lind, iSA1, iSA2, noN, good = sai_lookup(gi, Q)
    if Lind < gi.sa_index_nbases and noN and good:
        return Lind, iSA2 - iSA1 + 1, iSA1, iSA2
    if iSA1 == iSA2 and noN and good:
        maxL = _lcp(gi, Q, iSA1, Lind)
        return maxL, 1, iSA1, iSA1
    L0 = Lind if (good and noN) else 0
    maxL, lo, hi = mmp_full_search(gi, Q, iSA1, iSA2, L0)
    return maxL, hi - lo + 1, lo, hi


# ------------------------------------------------------------------ seed loop
@dataclass
class SeedResult:
    """per-read seed search output: the sorted piece table PC"""
    pc: List[list]          # rows [rStart, Length, Dir, Nrep, SAstart, SAend, iFrag]
    nA: int
    nUM: Tuple[int, int]
    mult_nmin: int
    mult_nmin_l: int
    max_good_piece: int
    n_split: int


PC_rStart, PC_Length, PC_Dir, PC_Nrep, PC_SAstart, PC_SAend, PC_iFrag = range(7)


def quality_split(read1: np.ndarray, Lread: int, max_nsplit: int, min_lsplit: int):
    """split combined read into good (all-nucleotide) pieces
    (reference: SequenceFuns.cpp qualitySplit)."""
    from ..constants import MARK_FRAG_SPACER_BASE
    pieces = []
    i = 0
    lgood_min = 0
    ifrag = 0
    while i < Lread and len(pieces) < max_nsplit:
        while i < Lread and read1[i] > 3:
            if read1[i] == MARK_FRAG_SPACER_BASE:
                ifrag += 1
            i += 1
        if i == Lread:
            break
        i0 = i
        while i < Lread and read1[i] <= 3:
            i += 1
        if i - i0 > lgood_min:
            lgood_min = i - i0
        if i - i0 < min_lsplit:
            continue
        pieces.append((i0, i - i0, ifrag))
    return pieces, lgood_min


def store_align(res: SeedResult, P, iDir: int, shift: int, nrep: int, L: int,
                lo: int, hi: int, ifrag: int):
    """insert a seed into the sorted piece table
    (reference: ReadAlign_storeAligns.cpp, simple variant)."""
    if nrep > P.seedMultimapNmax:
        if nrep < res.mult_nmin or res.mult_nmin == 0:
            res.mult_nmin = nrep
            res.mult_nmin_l = L
        return
    res.nUM = (res.nUM[0] + (nrep if nrep == 1 else 0),
               res.nUM[1] + (nrep if nrep != 1 else 0))
    res.nA += nrep
    r_start = shift if iDir == 0 else shift + 1 - L
    pc = res.pc
    ip = len(pc) - 1
    while ip >= 0:
        if pc[ip][PC_rStart] <= r_start:
            if pc[ip][PC_rStart] == r_start and pc[ip][PC_Length] < L:
                ip -= 1
                continue
            if pc[ip][PC_rStart] == r_start and pc[ip][PC_Length] == L:
                return  # duplicate
            break
        ip -= 1
    pc.insert(ip + 1, [r_start, L, iDir, nrep, lo, hi, ifrag])
    if len(pc) > P.seedPerReadNmax:
        raise RuntimeError("too many pieces per read; increase --seedPerReadNmax")


def search_pieces(gi: GenomeIndex, P, read1: np.ndarray, Lread: int) -> SeedResult:
    """full per-read seed search (reference: ReadAlign_mapOneRead.cpp loop)."""
    res = SeedResult(pc=[], nA=0, nUM=(0, 0), mult_nmin=0, mult_nmin_l=0,
                     max_good_piece=0, n_split=0)
    pieces, lgood_min = quality_split(read1, Lread, P.maxNsplit, P.seedSplitMin)
    res.max_good_piece = lgood_min
    res.n_split = len(pieces)
    if not pieces:
        return res

    ssl = min(P.seedSearchStartLmax, int(P.seedSearchStartLmaxOverLread * (Lread - 1)))
    comp = None
    for (p_start, p_len, ifrag) in pieces:
        n_start = p_len // ssl + 1 if (P.seedSearchStartLmax > 0 and ssl < p_len) else 1
        l_start = p_len // n_start
        flag_dir_map = True
        for i_dir in range(2):
            for istart in range(n_start):
                if flag_dir_map or istart > 0:
                    l_mapped = 0
                    while istart * l_start + l_mapped + P.seedMapMin < p_len:
                        if i_dir == 0:
                            shift = p_start + istart * l_start + l_mapped
                        else:
                            shift = p_start + p_len - istart * l_start - 1 - l_mapped
                        seed_len = p_len - l_mapped - istart * l_start
                        # sparse suffix array: probe sa_sparse_d phase
                        # offsets, keep the best maxL+iDist (reference:
                        # ReadAlign_maxMappableLength2strands.cpp:18-113)
                        probes = []
                        max_l_best = 0
                        for i_dist in range(min(seed_len, gi.sa_sparse_d)):
                            ps = shift + i_dist if i_dir == 0 else shift - i_dist
                            plen = seed_len - i_dist
                            if i_dir == 0:
                                Q = read1[ps:ps + plen]
                            else:
                                Q = 3 - read1[ps - plen + 1: ps + 1][::-1]
                            maxL, nrep, lo, hi = mmp_search(
                                gi, np.ascontiguousarray(Q))
                            probes.append((i_dist, ps, maxL, nrep, lo, hi))
                            max_l_best = max(max_l_best, maxL + i_dist)
                        for (i_dist, ps, maxL, nrep, lo, hi) in probes:
                            if maxL + i_dist == max_l_best:
                                store_align(res, P, i_dir, ps, nrep, maxL,
                                            lo, hi, ifrag)
                        if (i_dir == 0 and istart == 0 and l_mapped == 0
                                and shift + max_l_best == p_len):
                            flag_dir_map = False
                        if max_l_best == 0:
                            break  # safety; cannot happen for real genomes
                        l_mapped += max_l_best
    return res
