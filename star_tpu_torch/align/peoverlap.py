"""PE mate-overlap merge-remap (--peOverlapNbasesMin).

Reference behavior: source/ReadAlign_peOverlapMergeMap.cpp — detect mate
overlap with localSearchNisMM both ways (SequenceFuns.cpp:317), merge the
pair into one SE read, remap it, convert every window transcript back to PE
coordinates (Transcript::peOverlapSEtoPE) rescoring with Transcript::alignScore
(Transcript_alignScore.cpp), and REPLACE the PE alignments whenever the
merged read produced any window (the original score only gates peOv.yes,
which in turn only gates chimeric detection).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .transcript import Transcript

MAX_N_EXONS = 20


def local_search_n_is_mm(x, nx: int, y, ny: int, p_mm: float) -> int:
    """reference localSearchNisMM (Ns count as mismatches)"""
    n_match_best = 0
    n_mm_best = 0
    ix_best = nx
    for ix in range(nx):
        n_match = 0
        n_mm = 0
        for iy in range(min(ny, nx - ix)):
            if x[ix + iy] == y[iy] and y[iy] < 4:
                n_match += 1
            else:
                n_mm += 1
        if ((n_match > n_match_best
             or (n_match == n_match_best and n_mm < n_mm_best))
                and (n_mm / n_match if n_match else float("inf")) <= p_mm):
            ix_best = ix
            n_match_best = n_match
            n_mm_best = n_mm
    return ix_best


def pe_merge_mates(read1, len0: int, len1: int, n_bases_min: int,
                   p_mm: float):
    """returns (n_ov, mate_start, merged) or (0, None, None)
    (reference ReadAlign::peMergeMates)"""
    m1 = read1[:len0]
    m2 = read1[len0 + 1:len0 + 1 + len1]  # revcomp of mate2 (Read1 layout)
    s1 = local_search_n_is_mm(m1, len0, m2, len1, p_mm)
    s0 = local_search_n_is_mm(m2, len1, m1, len0, p_mm)
    o1 = min(len1, len0 - s1)
    o0 = min(len0, len1 - s0)
    n_ov = max(o0, o1)
    if n_ov < n_bases_min:
        return 0, None, None
    if o1 >= o0:
        mate_start = [0, s1]
        merged = np.concatenate([m1, m2[o1:]])
    else:
        mate_start = [s0, 0]
        merged = np.concatenate([m2, m1[o0:]])
    return n_ov, mate_start, merged.astype(np.int8)


def se_to_pe(t: Transcript, mate_start, read_length, lread_pe: int
             ) -> Optional[Transcript]:
    """reference Transcript::peOverlapSEtoPE: convert a merged-SE alignment
    back to PE read coordinates (None if conversion fails)"""
    m_len = [read_length[t.Str], read_length[1 - t.Str]]
    m_sta2 = [0, m_len[0] + 1]
    m_sta = [mate_start[0], mate_start[1]]
    if t.Str == 1:
        for ii in range(2):
            m_sta[ii] = t.Lread - read_length[ii] - m_sta[ii]
        m_sta[0], m_sta[1] = m_sta[1], m_sta[0]
    m_end = [m_sta[0] + m_len[0], m_sta[1] + m_len[1]]

    o = Transcript()
    o.Lread = lread_pe
    for imate in range(2):
        for iex in range(t.nExons):
            ex_r, ex_g, ex_l = t.exons[iex][0], t.exons[iex][1], t.exons[iex][2]
            if ex_r >= m_end[imate] or ex_r + ex_l <= m_sta[imate]:
                continue
            ifrag = t.Str if imate == 0 else 1 - t.Str
            if iex < t.nExons - 1:
                sj = t.canonSJ[iex]
                sja = t.sjAnnot[iex]
                sjs = t.sjStr[iex]
                shf = list(t.shiftSJ[iex])
            else:
                sj, sja, sjs, shf = -1, 0, 0, [0, 0]
            if ex_r >= m_sta[imate]:
                ng, nl = ex_g, ex_l
                nr = ex_r - m_sta[imate] + m_sta2[imate]
            else:
                nr = m_sta2[imate]
                delta = m_sta[imate] - ex_r
                nl = ex_l - delta
                ng = ex_g + delta
            if ex_r + ex_l > m_end[imate]:
                nl -= ex_r + ex_l - m_end[imate]
            o.exons.append([nr, ng, nl, ifrag, t.exons[iex][4]
                            if len(t.exons[iex]) > 4 else -1])
            o.canonSJ.append(sj)
            o.sjAnnot.append(sja)
            o.sjStr.append(sjs)
            o.shiftSJ.append(shf)
            o.nExons += 1
            if o.nExons > MAX_N_EXONS:
                return None
        if o.nExons > 0:
            o.canonSJ[o.nExons - 1] = -3
            o.sjAnnot[o.nExons - 1] = 0
            o.sjStr[o.nExons - 1] = 0
            o.shiftSJ[o.nExons - 1] = [0, 0]

    o.intronMotifs = list(t.intronMotifs)
    o.sjMotifStrand = t.sjMotifStrand
    o.Chr, o.Str, o.roStr = t.Chr, t.Str, t.roStr
    o.gStart, o.gLength, o.cStart = t.gStart, t.gLength, t.cStart
    o.rLength = sum(e[2] for e in o.exons)
    o.mappedLength = o.rLength
    o.rStart = o.exons[0][0] if o.exons else 0
    o.roStart = o.rStart if o.roStr == 0 else lread_pe - o.rStart - o.rLength
    o.nGap, o.lGap = t.nGap, t.lGap
    o.nDel, o.nIns = t.nDel, t.nIns
    o.lDel, o.lIns = t.nDel, t.lIns  # reference quirk: lDel=t.nDel
    o.nUnique, o.nAnchor = t.nUnique, t.nAnchor
    o.sjYes = any(c >= 0 for c in o.canonSJ[:max(o.nExons - 1, 0)])
    return o


def align_score(t: Transcript, read1, read1rc, G, P) -> int:
    """reference Transcript::alignScore: recompute score/nMM/nMatch"""
    t.maxScore = 0
    t.nMM = 0
    t.nMatch = 0
    if t.nExons == 0:
        return 0
    R = read1 if t.roStr == 0 else read1rc
    score = 0
    for iex in range(t.nExons):
        r0, g0, ln = t.exons[iex][0], t.exons[iex][1], t.exons[iex][2]
        for ii in range(ln):
            r1 = R[r0 + ii]
            g1 = G[g0 + ii]
            if r1 > 3 or g1 > 3:
                pass
            elif r1 == g1:
                score += 1
                t.nMatch += 1
            else:
                t.nMM += 1
                score -= 1
    for iex in range(t.nExons - 1):
        if t.sjAnnot[iex] == 1:
            score += P.sjdbScore
        else:
            c = t.canonSJ[iex]
            if c == -3:
                pass
            elif c == -2:
                score += ((t.exons[iex + 1][0] - t.exons[iex][0] - t.exons[iex][2])
                          * P.scoreInsBase + P.scoreInsOpen)
            elif c == -1:
                score += ((t.exons[iex + 1][1] - t.exons[iex][1] - t.exons[iex][2])
                          * P.scoreDelBase + P.scoreDelOpen)
            elif c == 0:
                score += P.scoreGapNoncan + P.scoreGap
            elif c in (1, 2):
                score += P.scoreGap
            elif c in (3, 4):
                score += P.scoreGapGCAG + P.scoreGap
            elif c in (5, 6):
                score += P.scoreGapATAC + P.scoreGap
    if P.scoreGenomicLengthLog2scale != 0:
        glen = max(1, t.exons[-1][1] + t.exons[-1][2] - t.exons[0][1])
        score += int(math.ceil(math.log2(glen)
                               * P.scoreGenomicLengthLog2scale - 0.5))
    t.maxScore = score
    return score
