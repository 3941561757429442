"""Seed extension and stitching into transcripts.

Reference behavior: source/extendAlign.cpp, source/stitchAlignToTranscript.cpp,
source/stitchWindowAligns.cpp.  The include/exclude enumeration over window
seeds, gap scoring (mismatch fill / indel / intron with canonical-motif
detection and repeat-shift flushing), sjdb overrides, end extension order, and
the transcript dedup/top-list rules are reproduced exactly; the host recursion
here is the semantic reference for the batched device DP.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..constants import (MARK_FRAG_SPACER_BASE, MAX_N_EXONS, SCORE_MATCH)
from .transcript import Transcript, blocks_overlap
from .windows import WA_Length, WA_rStart, WA_gStart, WA_Nrep, WA_Anchor, WA_iFrag, WA_sjA

DEF_READ_SEQ_LENGTH_MAX = 650
MAX_SJ_REPEAT_SEARCH = 255


class ExtendResult:
    __slots__ = ("ok", "extendL", "maxScore", "nMatch", "nMM")

    def __init__(self):
        self.ok = False
        self.extendL = 0
        self.maxScore = 0
        self.nMatch = 0
        self.nMM = 0


def extend_align(R, G, r_start, g_start, dR, dG, L, l_prev, n_mm_prev,
                 n_mm_max, p_mm_max, extend_to_end) -> ExtendResult:
    res = ExtendResult()
    n_genome = len(G)
    score = 0
    n_match = 0
    n_mm = 0

    if extend_to_end:
        i_ext = 0
        while i_ext < L:
            iS = dR * i_ext
            iG = dG * i_ext
            gpos = g_start + iG
            if gpos < 0 or gpos >= n_genome or G[gpos] == 5:
                res.extendL = 0
                res.maxScore = -999999999
                res.nMatch = 0
                res.nMM = n_mm_max + 1
                res.ok = True
                return res
            rch = R[r_start + iS]
            if rch == MARK_FRAG_SPACER_BASE:
                break
            if rch > 3 or G[gpos] > 3:
                i_ext += 1
                continue
            if G[gpos] == rch:
                n_match += 1
                score += SCORE_MATCH
            else:
                n_mm += 1
                score -= SCORE_MATCH
            i_ext += 1
        if i_ext > 0:
            res.extendL = i_ext
            res.maxScore = score
            res.nMatch = n_match
            res.nMM = n_mm
            res.ok = True
        return res

    for i in range(L):
        iS = dR * i
        iG = dG * i
        gpos = g_start + iG
        if gpos < 0 or gpos >= n_genome or G[gpos] == 5 or R[r_start + iS] == MARK_FRAG_SPACER_BASE:
            break
        rch = R[r_start + iS]
        if rch > 3 or G[gpos] > 3:
            continue
        if G[gpos] == rch:
            n_match += 1
            score += SCORE_MATCH
            if score > res.maxScore:
                if n_mm + n_mm_prev <= min(p_mm_max * (l_prev + i + 1), float(n_mm_max)):
                    res.extendL = i + 1
                    res.maxScore = score
                    res.nMatch = n_match
                    res.nMM = n_mm
        else:
            if n_mm + n_mm_prev >= min(p_mm_max * (l_prev + L), float(n_mm_max)):
                break
            n_mm += 1
            score -= SCORE_MATCH
    res.ok = res.extendL > 0
    return res


def stitch_align_to_transcript(r_a_end, g_a_end, r_b_start, g_b_start, L,
                               i_frag_b, sj_ab, P, R, gi, tr: Transcript,
                               n_mm_max_total) -> int:
    """stitch seed B onto the partial transcript; returns the score delta or a
    large negative rejection code."""
    if tr.nExons >= P.maxNExons:
        return -1000010
    G = gi.G_bytes
    score = 0
    last = tr.nExons - 1

    if (sj_ab != -1 and tr.exons[last][4] == sj_ab and tr.exons[last][3] == i_frag_b
            and r_b_start == r_a_end + 1 and g_a_end + 1 < g_b_start):
        # annotated-junction stitch: the two seeds came from the same sjdb
        # pseudo-chromosome entry
        if gi.sjdb_motif[sj_ab] == 0 and (L <= gi.sjdb_shift_right[sj_ab]
                                          or tr.exons[last][2] <= gi.sjdb_shift_left[sj_ab]):
            return -1000006
        tr.exons.append([r_b_start, g_b_start, L, i_frag_b, sj_ab])
        tr.canonSJ.append(int(gi.sjdb_motif[sj_ab]))
        tr.shiftSJ.append([int(gi.sjdb_shift_left[sj_ab]), int(gi.sjdb_shift_right[sj_ab])])
        tr.sjAnnot.append(1)
        tr.sjStr.append(int(gi.sjdb_strand[sj_ab]))
        tr.nExons += 1
        tr.nMatch += L
        score += SCORE_MATCH * L + P.sjdbScore
        return score

    # general stitching
    tr.canonSJ.append(0)
    tr.shiftSJ.append([0, 0])
    tr.sjAnnot.append(0)
    tr.sjStr.append(0)

    if tr.exons[last][3] == i_frag_b:
        g_b_end = g_b_start + L - 1
        r_b_end = r_b_start + L - 1
        if r_b_end <= r_a_end:
            tr.canonSJ.pop(); tr.shiftSJ.pop(); tr.sjAnnot.pop(); tr.sjStr.pop()
            return -1000001
        if g_b_end <= g_a_end:
            tr.canonSJ.pop(); tr.shiftSJ.pop(); tr.sjAnnot.pop(); tr.sjStr.pop()
            return -1000002
        if r_b_start <= r_a_end:
            g_b_start += r_a_end - r_b_start + 1
            r_b_start = r_a_end + 1
            L = r_b_end - r_b_start + 1
        score += SCORE_MATCH * (r_b_end - r_b_start + 1)

        g_gap = g_b_start - g_a_end - 1
        r_gap = r_b_start - r_a_end - 1

        n_match = L
        n_mm = 0
        delv = 0
        insv = 0
        n_ins = 0
        n_del = 0
        jR = 0
        j_can = 999
        g_b_start1 = g_b_start - r_gap - 1

        if g_gap == 0 and r_gap == 0:
            pass
        elif g_gap > 0 and r_gap > 0 and r_gap == g_gap:
            for ii in range(1, r_gap + 1):
                if G[g_a_end + ii] < 4 and R[r_a_end + ii] < 4:
                    if R[r_a_end + ii] == G[g_a_end + ii]:
                        score += SCORE_MATCH
                        n_match += 1
                    else:
                        score -= SCORE_MATCH
                        n_mm += 1
        elif g_gap > r_gap:
            # deletion or intron
            n_del = 1
            delv = g_gap - r_gap
            if P.alignIntronMax > 0 and delv > P.alignIntronMax:
                _pop_junction(tr)
                return -1000003

            score1 = 0
            jR1 = 1
            while True:
                jR1 -= 1
                if (R[r_a_end + jR1] != G[g_b_start1 + jR1] and G[g_b_start1 + jR1] < 4
                        and R[r_a_end + jR1] == G[g_a_end + jR1]):
                    score1 -= SCORE_MATCH
                if not (score1 + P.scoreStitchSJshift >= 0 and tr.exons[last][2] + jR1 > 1):
                    break

            max_score2 = -999999
            score1 = 0
            j_pen = 0
            while True:
                if R[r_a_end + jR1] == G[g_a_end + jR1] and R[r_a_end + jR1] != G[g_b_start1 + jR1]:
                    score1 += SCORE_MATCH
                if R[r_a_end + jR1] != G[g_a_end + jR1] and R[r_a_end + jR1] == G[g_b_start1 + jR1]:
                    score1 -= SCORE_MATCH
                j_can1 = -1
                j_pen1 = 0
                score2 = score1
                if delv >= P.alignIntronMin:
                    d1, d2 = G[g_a_end + jR1 + 1], G[g_a_end + jR1 + 2]
                    a1, a2 = G[g_b_start1 + jR1 - 1], G[g_b_start1 + jR1]
                    if d1 == 2 and d2 == 3 and a1 == 0 and a2 == 2:
                        j_can1 = 1
                    elif d1 == 1 and d2 == 3 and a1 == 0 and a2 == 1:
                        j_can1 = 2
                    elif d1 == 2 and d2 == 1 and a1 == 0 and a2 == 2:
                        j_can1 = 3
                        j_pen1 = P.scoreGapGCAG
                    elif d1 == 1 and d2 == 3 and a1 == 2 and a2 == 1:
                        j_can1 = 4
                        j_pen1 = P.scoreGapGCAG
                    elif d1 == 0 and d2 == 3 and a1 == 0 and a2 == 1:
                        j_can1 = 5
                        j_pen1 = P.scoreGapATAC
                    elif d1 == 2 and d2 == 3 and a1 == 0 and a2 == 3:
                        j_can1 = 6
                        j_pen1 = P.scoreGapATAC
                    else:
                        j_can1 = 0
                        j_pen1 = P.scoreGapNoncan
                    score2 += j_pen1
                if max_score2 < score2:
                    max_score2 = score2
                    jR = jR1
                    j_can = j_can1
                    j_pen = j_pen1
                jR1 += 1
                if jR1 >= r_b_end - r_a_end:
                    break

            # repeat (micro-homology) length around the junction
            jjL = 0
            jjR = 0
            while (g_a_end + jR >= jjL and G[g_a_end - jjL + jR] == G[g_b_start1 - jjL + jR]
                   and G[g_a_end - jjL + jR] < 4 and jjL <= MAX_SJ_REPEAT_SEARCH):
                jjL += 1
            while (g_a_end + jjR + jR + 1 < gi.n_genome
                   and G[g_a_end + jjR + jR + 1] == G[g_b_start1 + jjR + jR + 1]
                   and G[g_a_end + jjR + jR + 1] < 4 and jjR <= MAX_SJ_REPEAT_SEARCH):
                jjR += 1

            if j_can <= 0:
                # flush deletions/non-canonical junctions left
                jR -= jjL
                if tr.exons[last][2] + jR < 1:
                    _pop_junction(tr)
                    return -1000005
                jjR += jjL
                jjL = 0

            for ii in range(min(1, jR + 1), max(r_gap, jR) + 1):
                g1 = (g_a_end + ii) if ii <= jR else (g_b_start1 + ii)
                if G[g1] < 4 and R[r_a_end + ii] < 4:
                    if R[r_a_end + ii] == G[g1]:
                        if 1 <= ii <= r_gap:
                            score += SCORE_MATCH
                            n_match += 1
                    else:
                        score -= SCORE_MATCH
                        n_mm += 1
                        if ii < 1 or ii > r_gap:
                            score -= SCORE_MATCH
                            n_match -= 1

            # gap scoring + sjdb annotation check
            if gi.sjdb_n > 0:
                jS = g_a_end + jR + 1
                jE = g_b_start1 + jR
                sjdb_ind = _sjdb_find(gi, jS, jE)
                if sjdb_ind < 0:
                    if delv >= P.alignIntronMin:
                        score += P.scoreGap + j_pen
                    else:
                        score += delv * P.scoreDelBase + P.scoreDelOpen
                        j_can = -1
                        tr.sjAnnot[-1] = 0
                else:
                    j_can = int(gi.sjdb_motif[sjdb_ind])
                    if gi.sjdb_motif[sjdb_ind] == 0:
                        if (L <= gi.sjdb_shift_left[sjdb_ind]
                                or tr.exons[last][2] <= gi.sjdb_shift_left[sjdb_ind]):
                            _pop_junction(tr)
                            return -1000006
                        jR += int(gi.sjdb_shift_left[sjdb_ind])
                        if r_a_end + jR >= r_b_end:
                            _pop_junction(tr)
                            return -1000006
                        jjL = int(gi.sjdb_shift_left[sjdb_ind])
                        jjR = int(gi.sjdb_shift_right[sjdb_ind])
                    tr.sjAnnot[-1] = 1
                    tr.sjStr[-1] = int(gi.sjdb_strand[sjdb_ind])
                    score += P.sjdbScore
            else:
                if delv >= P.alignIntronMin:
                    score += P.scoreGap + j_pen
                else:
                    score += delv * P.scoreDelBase + P.scoreDelOpen
                    j_can = -1
                    tr.sjAnnot[-1] = 0

            tr.shiftSJ[-1] = [jjL, jjR]
            tr.canonSJ[-1] = j_can
            if tr.sjAnnot[-1] == 0:
                tr.sjStr[-1] = (2 - j_can % 2) if j_can > 0 else 0

        elif r_gap > g_gap:
            insv = r_gap - g_gap
            n_ins = 1
            if g_gap == 0:
                jR = 0
            elif g_gap < 0:
                jR = 0
                score -= SCORE_MATCH * (-g_gap)
            else:
                score1 = 0
                max_score1 = 0
                jR = 0
                for jR1 in range(1, g_gap + 1):
                    if G[g_a_end + jR1] < 4:
                        score1 += SCORE_MATCH if R[r_a_end + jR1] == G[g_a_end + jR1] else -SCORE_MATCH
                        score1 += -SCORE_MATCH if R[r_a_end + insv + jR1] == G[g_a_end + jR1] else SCORE_MATCH
                    if score1 > max_score1 or (score1 == max_score1 and P.alignInsertionFlushRight):
                        max_score1 = score1
                        jR = jR1
                for ii in range(1, g_gap + 1):
                    r1 = r_a_end + ii + (0 if ii <= jR else insv)
                    if G[g_a_end + ii] < 4 and R[r1] < 4:
                        if R[r1] == G[g_a_end + ii]:
                            score += SCORE_MATCH
                            n_match += 1
                        else:
                            score -= SCORE_MATCH
                            n_mm += 1
            if P.alignInsertionFlushRight:
                while jR < r_b_end - r_a_end - insv:
                    if R[r_a_end + jR + 1] != G[g_a_end + jR + 1] or G[g_a_end + jR + 1] == 4:
                        break
                    jR += 1
                if jR == r_b_end - r_a_end - insv:
                    _pop_junction(tr)
                    return -1000009
            score += insv * P.scoreInsBase + P.scoreInsOpen
            j_can = -2

        # accept or reject the stitch; the long-read build accepts on the
        # mismatch budget alone (reference stitchAlignToTranscript.cpp:309-316,
        # COMPILE_FOR_LONG_READS branch)
        if (tr.nMM + n_mm <= n_mm_max_total
                and (P.longReads or j_can < 0
                     or (j_can < 7 and n_mm <= _sj_mm_max(P, j_can)))):
            tr.nMM += n_mm
            tr.nMatch += n_match
            if delv >= P.alignIntronMin:
                tr.nGap += n_del
                tr.lGap += delv
            else:
                tr.nDel += n_del
                tr.lDel += delv
            if delv == 0 and insv == 0:
                tr.exons[last][2] += r_b_end - r_a_end
                _pop_junction(tr)
            elif delv > 0:
                tr.exons[last][2] += jR
                tr.exons.append([r_a_end + jR + 1, g_b_start1 + jR + 1,
                                 r_b_end - r_a_end - jR, i_frag_b, sj_ab])
                tr.nExons += 1
            elif insv > 0:
                tr.nIns += n_ins
                tr.lIns += insv
                tr.exons[last][2] += jR
                tr.exons.append([r_a_end + jR + insv + 1, g_a_end + 1 + jR,
                                 r_b_end - r_a_end - jR - insv, i_frag_b, sj_ab])
                tr.canonSJ[-1] = -2
                tr.sjAnnot[-1] = 0
                tr.nExons += 1
        else:
            _pop_junction(tr)
            return -1000007

    elif (g_b_start + tr.exons[0][0] + P.alignEndsProtrudeMax >= tr.exons[0][1]
          or tr.exons[0][1] < tr.exons[0][0]):
        # mates: different fragments
        if (P.alignMatesGapMax > 0
                and g_b_start > tr.exons[last][1] + tr.exons[last][2] + P.alignMatesGapMax):
            _pop_junction(tr)
            return -1000004
        score += SCORE_MATCH * L
        ext = extend_align(R, G, r_a_end + 1, g_a_end + 1, 1, 1,
                           P.readSeqLengthMax, tr.nMatch, tr.nMM,
                           n_mm_max_total, P.outFilterMismatchNoverLmax,
                           P.alignEndsTypeExt[tr.exons[last][3]][1])
        if ext.ok:
            _add_ext(tr, ext)
            score += ext.maxScore
            tr.exons[last][2] += ext.extendL

        tr.exons.append([r_b_start, g_b_start, L, i_frag_b, sj_ab])
        tr.nMatch += L
        ext = ExtendResult()
        extlen = (P.readSeqLengthMax if P.alignEndsTypeExt[i_frag_b][1]
                  else g_b_start - tr.exons[0][1] + tr.exons[0][0])
        ext = extend_align(R, G, r_b_start - 1, g_b_start - 1, -1, -1,
                           extlen, tr.nMatch, tr.nMM, n_mm_max_total,
                           P.outFilterMismatchNoverLmax,
                           P.alignEndsTypeExt[i_frag_b][1])
        if ext.ok:
            _add_ext(tr, ext)
            score += ext.maxScore
            tr.exons[-1][0] -= ext.extendL
            tr.exons[-1][1] -= ext.extendL
            tr.exons[-1][2] += ext.extendL
        tr.canonSJ[-1] = -3
        tr.sjAnnot[-1] = 0
        tr.nExons += 1
    else:
        _pop_junction(tr)
        return -1000008

    tr.exons[tr.nExons - 1][3] = i_frag_b
    tr.exons[tr.nExons - 1][4] = sj_ab
    return score


def _pop_junction(tr: Transcript):
    tr.canonSJ.pop()
    tr.shiftSJ.pop()
    tr.sjAnnot.pop()
    tr.sjStr.pop()


def _add_ext(tr: Transcript, ext: ExtendResult):
    tr.maxScore += ext.maxScore
    tr.nMatch += ext.nMatch
    tr.nMM += ext.nMM


def _sj_mm_max(P, j_can: int) -> int:
    v = P.alignSJstitchMismatchNmax[(j_can + 1) // 2]
    return v if v >= 0 else 1 << 30


def _sjdb_find(gi, jS: int, jE: int) -> int:
    """find annotated junction with start jS end jE
    (reference: binarySearch2.cpp over sjdbStart/sjdbEnd)."""
    n = gi.sjdb_n
    if n == 0:
        return -1
    lo = int(np.searchsorted(gi.sjdb_start[:n], jS, side="left"))
    for j in range(lo, n):
        if gi.sjdb_start[j] != jS:
            return -1
        if gi.sjdb_end[j] == jE:
            return j
    return -1


# --------------------------------------------------------------- window DP
class WindowStitcher:
    """enumerate include/exclude seed subsets for one window, maintaining the
    per-window transcript top list (reference: stitchWindowAligns.cpp)."""

    def __init__(self, gi, P, read_align):
        self.gi = gi
        self.P = P
        self.ra = read_align  # engine state: maxScoreMate, outFilterMismatchNmaxTotal

    def stitch_window(self, wa: List[list], w_last_anchor: int, tr0: Transcript,
                      Lread: int, R) -> List[Transcript]:
        if w_last_anchor < len(wa):
            wa[w_last_anchor][WA_Anchor] = 2
        self.win_tr: List[Transcript] = []
        self.wa = wa
        self.Lread = Lread
        self.R = R
        self._recurse(0, len(wa), 0, 0, 0, tr0)
        return self.win_tr

    def _recurse(self, iA: int, nA: int, score: int, tR2: int, tG2: int,
                 tr: Transcript):
        if iA >= nA and tr.nExons == 0:
            return
        if iA >= nA:
            self._finalize(score, tR2, tG2, tr.copy())
            return

        wa_row = self.wa[iA]
        # cheap rejection pre-checks before paying for the transcript copy
        # (same outcomes as the corresponding stitch rejection codes)
        if tr.nExons > 0:
            skip = False
            if tr.nExons >= self.P.maxNExons:
                skip = True
            else:
                last_frag = tr.exons[tr.nExons - 1][3]
                r_b = wa_row[WA_rStart]
                g_b = wa_row[WA_gStart]
                L = wa_row[WA_Length]
                annot_path = (wa_row[WA_sjA] != -1
                              and tr.exons[tr.nExons - 1][4] == wa_row[WA_sjA]
                              and last_frag == wa_row[WA_iFrag]
                              and r_b == tR2 + 1 and tG2 + 1 < g_b)
                if not annot_path:
                    if last_frag == wa_row[WA_iFrag]:
                        if r_b + L - 1 <= tR2 or g_b + L - 1 <= tG2:
                            skip = True
                    else:
                        if not (g_b + tr.exons[0][0] + self.P.alignEndsProtrudeMax
                                >= tr.exons[0][1] or tr.exons[0][1] < tr.exons[0][0]):
                            skip = True
                        elif (self.P.alignMatesGapMax > 0
                              and g_b > tr.exons[tr.nExons - 1][1]
                              + tr.exons[tr.nExons - 1][2] + self.P.alignMatesGapMax):
                            skip = True
            if skip:
                if wa_row[WA_Anchor] != 2 or tr.nAnchor > 0:
                    self._recurse(iA + 1, nA, score, tR2, tG2, tr)
                return

        tr_i = tr.copy()
        if tr.nExons > 0:
            d_score = stitch_align_to_transcript(
                tR2, tG2, wa_row[WA_rStart], wa_row[WA_gStart], wa_row[WA_Length],
                wa_row[WA_iFrag], wa_row[WA_sjA], self.P, self.R, self.gi, tr_i,
                self.ra.outFilterMismatchNmaxTotal)
        else:
            tr_i.exons = [[wa_row[WA_rStart], wa_row[WA_gStart], wa_row[WA_Length],
                           wa_row[WA_iFrag], wa_row[WA_sjA]]]
            tr_i.rStart = wa_row[WA_rStart]
            tr_i.gStart = wa_row[WA_gStart]
            tr_i.nExons = 1
            tr_i.nMatch = wa_row[WA_Length]
            d_score = SCORE_MATCH * wa_row[WA_Length]

        if d_score > -1000000:
            if wa_row[WA_Nrep] == 1:
                tr_i.nUnique += 1
            if wa_row[WA_Anchor] > 0:
                tr_i.nAnchor += 1
            self._recurse(iA + 1, nA, score + d_score,
                          wa_row[WA_rStart] + wa_row[WA_Length] - 1,
                          wa_row[WA_gStart] + wa_row[WA_Length] - 1, tr_i)

        if wa_row[WA_Anchor] != 2 or tr.nAnchor > 0:
            self._recurse(iA + 1, nA, score, tR2, tG2, tr)

    # -- transcript finalization ------------------------------------------
    def _finalize(self, score: int, tR2: int, tG2: int, tr: Transcript):
        P, gi, ra = self.P, self.gi, self.ra
        R = self.R
        Lread = self.Lread

        order = (0, 1) if tr.roStr == 0 else (1, 0)
        for which in order:
            if which == 0 and tr.rStart > 0:
                imate = tr.exons[0][3]
                ext = extend_align(R, gi.G_bytes, tr.rStart - 1, tr.gStart - 1, -1, -1,
                                   tr.rStart, tR2 - tr.rStart + 1, tr.nMM,
                                   ra.outFilterMismatchNmaxTotal,
                                   P.outFilterMismatchNoverLmax,
                                   P.alignEndsTypeExt[imate][int(tr.Str != imate)])
                if ext.ok:
                    _add_ext(tr, ext)
                    score += ext.maxScore
                    tr.exons[0][0] -= ext.extendL
                    tr.exons[0][1] -= ext.extendL
                    tr.exons[0][2] += ext.extendL
                    tr.rStart -= ext.extendL
                    tr.gStart -= ext.extendL
            elif which == 1 and tR2 < Lread - 1:
                imate = tr.exons[tr.nExons - 1][3]
                ext = extend_align(R, gi.G_bytes, tR2 + 1, tG2 + 1, 1, 1,
                                   Lread - tR2 - 1, tR2 - tr.rStart + 1, tr.nMM,
                                   ra.outFilterMismatchNmaxTotal,
                                   P.outFilterMismatchNoverLmax,
                                   P.alignEndsTypeExt[imate][int(imate == tr.Str)])
                if ext.ok:
                    _add_ext(tr, ext)
                    score += ext.maxScore
                    tR2 += ext.extendL
                    tG2 += ext.extendL
                    tr.exons[tr.nExons - 1][2] += ext.extendL

        if P.alignSoftClipAtReferenceEnds != "Yes":
            chr_end = gi.chr_start[tr.Chr] + gi.chr_length[tr.Chr]
            if (tr.exons[-1][1] + Lread - tr.exons[-1][0] > chr_end
                    or tr.exons[0][1] < gi.chr_start[tr.Chr] + tr.exons[0][0]):
                return

        tr.rLength = sum(e[2] for e in tr.exons)
        tr.gLength = tG2 + 1 - tr.gStart

        # junction-overhang filters
        for isj in range(tr.nExons - 1):
            if tr.canonSJ[isj] >= 0:
                if tr.sjAnnot[isj] == 1:
                    if ((tr.exons[isj][2] < P.alignSJDBoverhangMin
                         and (isj == 0 or tr.canonSJ[isj - 1] == -3
                              or (tr.sjAnnot[isj - 1] == 0 and tr.canonSJ[isj - 1] >= 0)))
                        or (tr.exons[isj + 1][2] < P.alignSJDBoverhangMin
                            and (isj == tr.nExons - 2 or tr.canonSJ[isj + 1] == -3
                                 or (tr.sjAnnot[isj + 1] == 0 and tr.canonSJ[isj + 1] >= 0)))):
                        return
                else:
                    if (tr.exons[isj][2] < P.alignSJoverhangMin + tr.shiftSJ[isj][0]
                            or tr.exons[isj + 1][2] < P.alignSJoverhangMin + tr.shiftSJ[isj][1]):
                        return
        if (tr.nExons > 1 and tr.sjAnnot[tr.nExons - 2] == 1
                and tr.exons[tr.nExons - 1][2] < P.alignSJDBoverhangMin):
            return

        # strand consistency
        tr.intronMotifs = [0, 0, 0]
        tr.sjYes = False
        sjN = 0
        for iex in range(tr.nExons - 1):
            if tr.canonSJ[iex] >= 0:
                sjN += 1
                tr.intronMotifs[tr.sjStr[iex]] += 1
                tr.sjYes = True
        if tr.intronMotifs[1] > 0 and tr.intronMotifs[2] == 0:
            tr.sjMotifStrand = 1
        elif tr.intronMotifs[1] == 0 and tr.intronMotifs[2] > 0:
            tr.sjMotifStrand = 2
        else:
            tr.sjMotifStrand = 0
        if (tr.intronMotifs[1] > 0 and tr.intronMotifs[2] > 0
                and P.outFilterIntronStrands == "RemoveInconsistentStrands"):
            return
        if sjN > 0 and tr.sjMotifStrand == 0 and P.outSAMstrandField == "intronMotif":
            return
        if P.outFilterIntronMotifs == "RemoveNoncanonical":
            if any(c == 0 for c in tr.canonSJ[:tr.nExons - 1]):
                return
        elif P.outFilterIntronMotifs == "RemoveNoncanonicalUnannotated":
            for iex in range(tr.nExons - 1):
                if tr.canonSJ[iex] == 0 and tr.sjAnnot[iex] == 0:
                    return

        # spliced-mate mapped-length check
        nsj = 0
        exl = 0
        for iex in range(tr.nExons):
            exl += tr.exons[iex][2]
            if iex == tr.nExons - 1 or tr.canonSJ[iex] == -3:
                if nsj > 0 and (exl < P.alignSplicedMateMapLmin
                                or exl < int(P.alignSplicedMateMapLminOverLmate
                                             * ra.readLength[tr.exons[iex][3]])):
                    return
                exl = 0
                nsj = 0
            elif tr.canonSJ[iex] >= 0:
                nsj += 1

        # BySJout stage-2: junctions must be in the filtered junction set
        if P.outFilterBySJoutStage == 2:
            for iex in range(tr.nExons - 1):
                if tr.canonSJ[iex] >= 0 and tr.sjAnnot[iex] == 0:
                    jS = tr.exons[iex][1] + tr.exons[iex][2]
                    jE = tr.exons[iex + 1][1] - 1
                    if not ra.sj_novel_contains(jS, jE):
                        return

        # PE mate overlap consistency
        if tr.exons[0][3] != tr.exons[-1][3]:
            if tr.exons[-1][1] + tr.exons[-1][2] <= tr.exons[0][1]:
                return
            iexM2 = tr.nExons
            for iex in range(tr.nExons - 1):
                if tr.canonSJ[iex] == -3:
                    iexM2 = iex + 1
                    break
            if tr.exons[iexM2 - 1][1] + tr.exons[iexM2 - 1][2] > tr.exons[iexM2][1]:
                if tr.exons[0][1] > tr.exons[iexM2][1] + tr.exons[0][0] + P.alignEndsProtrudeMax:
                    return
                if (tr.exons[iexM2 - 1][1] + tr.exons[iexM2 - 1][2]
                        > tr.exons[-1][1] + Lread - tr.exons[-1][0] + P.alignEndsProtrudeMax):
                    return
                iex1 = 1
                iex2 = iexM2 + 1
                while iex1 < iexM2:
                    if tr.exons[iex1][1] >= tr.exons[iex2 - 1][1] + tr.exons[iex2 - 1][2]:
                        break
                    iex1 += 1
                while iex1 < iexM2 and iex2 < tr.nExons:
                    if tr.canonSJ[iex1 - 1] < 0:
                        iex1 += 1
                        continue
                    if tr.canonSJ[iex2 - 1] < 0:
                        iex2 += 1
                        continue
                    if (tr.exons[iex1][1] != tr.exons[iex2][1]
                            or tr.exons[iex1 - 1][1] + tr.exons[iex1 - 1][2]
                            != tr.exons[iex2 - 1][1] + tr.exons[iex2 - 1][2]):
                        return
                    iex1 += 1
                    iex2 += 1

        if P.scoreGenomicLengthLog2scale != 0:
            import math
            glen = tr.exons[-1][1] + tr.exons[-1][2] - tr.exons[0][1]
            score += int(math.ceil(math.log2(glen) * P.scoreGenomicLengthLog2scale - 0.5))
            score = max(0, score)

        tr.roStart = tr.rStart if tr.roStr == 0 else Lread - tr.rStart - tr.rLength
        tr.maxScore = score

        if tr.exons[0][3] == tr.exons[-1][3]:
            tr.iFrag = tr.exons[0][3]
            ra.maxScoreMate[tr.iFrag] = max(ra.maxScoreMate[tr.iFrag], score)
        else:
            tr.iFrag = -1

        # SNP annotation (stitchWindowAligns.cpp:240; score unchanged with
        # the reference's VAR_noScoreCorrection)
        var = getattr(ra, "var", None)
        if var is not None and var.yes:
            from .variation import variation_adjust
            variation_adjust(var, tr, R, gi.chr_start)

        # record into the window top-list
        if not (score + P.outFilterMultimapScoreRange >= self._win_max_score()
                or (tr.iFrag >= 0 and score + P.outFilterMultimapScoreRange
                    >= ra.maxScoreMate[tr.iFrag])
                or P.chimSegmentMin > 0):
            return

        tr.mappedLength = sum(e[2] for e in tr.exons)
        win_tr = self.win_tr
        iTr = 0
        while iTr < len(win_tr):
            n_overlap = blocks_overlap(tr, win_tr[iTr])
            u_new = tr.mappedLength - n_overlap
            u_old = win_tr[iTr].mappedLength - n_overlap
            if u_new == 0 and score < win_tr[iTr].maxScore:
                break
            elif u_old == 0:
                del win_tr[iTr]
            elif u_old > 0 and (u_new > 0 or score >= win_tr[iTr].maxScore):
                iTr += 1
        if iTr == len(win_tr):
            ins = 0
            while ins < len(win_tr):
                if (score > win_tr[ins].maxScore
                        or (score == win_tr[ins].maxScore and tr.gLength < win_tr[ins].gLength)):
                    break
                ins += 1
            win_tr.insert(ins, tr)
            if len(win_tr) > self.P.alignTranscriptsPerWindowNmax:
                win_tr.pop()

    def _win_max_score(self):
        return self.win_tr[0].maxScore if self.win_tr else 0

    # -- long-read seed-chain DP (STARlong) --------------------------------
    def stitch_window_seeds(self, wa: List[list], w_last_anchor: int,
                            tr0: Transcript, Lread: int, R) -> List[Transcript]:
        """STARlong window stitching: O(n^2) seed-chain DP producing ONE
        transcript per window (two with chimSegmentMin>0), replacing the
        include/exclude recursion (reference: ReadAlign_stitchWindowSeeds.cpp:
        12-278, compiled only under -DCOMPILE_FOR_LONG_READS and invoked from
        ReadAlign_stitchPieces.cpp:299-318)."""
        if w_last_anchor < len(wa):
            wa[w_last_anchor][WA_Anchor] = 2
        wa_incl = [False] * len(wa)
        win_tr: List[Transcript] = []
        tr1 = self._seed_chain_dp(wa, tr0, Lread, R, None, wa_incl)
        if tr1 is not None:
            win_tr.append(tr1)
        if self.P.chimSegmentMin > 0 and tr1 is not None:
            # mark all seeds overlapping the best transcript, then chain the
            # remainder for the chimeric second segment
            # (reference stitchPieces.cpp:301-318)
            for ia in range(len(wa)):
                if wa_incl[ia]:
                    continue
                for ex in tr1.exons:
                    if (wa[ia][WA_rStart] < ex[0] + ex[2]
                            and wa[ia][WA_rStart] + wa[ia][WA_Length] > ex[0]
                            and wa[ia][WA_gStart] < ex[1] + ex[2]
                            and wa[ia][WA_gStart] + wa[ia][WA_Length] > ex[1]):
                        wa_incl[ia] = True
                        break
            tr2 = self._seed_chain_dp(wa, tr0, Lread, R, list(wa_incl), wa_incl)
            if tr2 is not None:
                win_tr.append(tr2)
        return win_tr

    def _seed_chain_dp(self, wa, tr0: Transcript, Lread: int, R,
                       wa_excl, wa_incl) -> Optional[Transcript]:
        P, gi, ra = self.P, self.gi, self.ra
        G = gi.G_bytes
        nA = len(wa)
        nmm_max = ra.outFilterMismatchNmaxTotal
        score_seed = [0] * nA   # scoreSeedBest
        mm_seed = [0] * nA      # scoreSeedBestMM
        ind_seed = [-1] * nA    # scoreSeedBestInd ((uint)-1 in the reference)

        for iS1 in range(nA):
            if wa_excl is not None and wa_excl[iS1]:
                continue
            r1, g1, L1 = wa[iS1][WA_rStart], wa[iS1][WA_gStart], wa[iS1][WA_Length]
            for iS2 in range(iS1 + 1):
                if iS2 < iS1:
                    tr1 = Transcript()
                    tr1.Lread = Lread
                    tr1.nExons = 1
                    tr1.nMM = mm_seed[iS2]
                    tr1.exons = [[wa[iS2][WA_rStart], wa[iS2][WA_gStart],
                                  wa[iS2][WA_Length], wa[iS2][WA_iFrag],
                                  wa[iS2][WA_sjA]]]
                    score2 = stitch_align_to_transcript(
                        wa[iS2][WA_rStart] + wa[iS2][WA_Length] - 1,
                        wa[iS2][WA_gStart] + wa[iS2][WA_Length] - 1,
                        r1, g1, L1, wa[iS1][WA_iFrag], wa[iS1][WA_sjA],
                        P, R, gi, tr1, nmm_max)
                    if P.outFilterBySJoutStage == 2 and tr1.nExons > 1:
                        # only the first junction is checked (reference
                        # stitchWindowSeeds.cpp:47-55 quirk); a novel junction
                        # outside the filtered set aborts the whole window
                        if tr1.canonSJ and tr1.canonSJ[0] >= 0 and tr1.sjAnnot[0] == 0:
                            jS = tr1.exons[0][1] + tr1.exons[0][2]
                            jE = tr1.exons[1][1] - 1
                            if not ra.sj_novel_contains(jS, jE):
                                return None
                    annot0 = tr1.sjAnnot[0] if tr1.sjAnnot else 0
                    long_enough = tr1.exons[0][2] >= (
                        P.alignSJDBoverhangMin if annot0 == 1 else P.alignSJoverhangMin)
                    if (long_enough and score2 > 0
                            and score2 + score_seed[iS2] > score_seed[iS1]):
                        score_seed[iS1] = score2 + score_seed[iS2]
                        mm_seed[iS1] = tr1.nMM
                        ind_seed[iS1] = iS2
                else:
                    # self-case: extend to the left of the seed
                    score2 = L1
                    ext_len = 0
                    if r1 > 0:
                        ext = extend_align(R, G, r1 - 1, g1 - 1, -1, -1, r1,
                                           100000, 0, nmm_max,
                                           P.outFilterMismatchNoverLmax,
                                           P.alignEndsTypeExt[wa[iS1][WA_iFrag]][tr0.Str])
                        if ext.ok:
                            score2 += ext.maxScore
                            ext_len = ext.extendL
                    if ((L1 + ext_len) >= P.alignSJoverhangMin
                            and score2 > score_seed[iS1]):
                        score_seed[iS1] = score2
                        ind_seed[iS1] = iS1
                        # the reference does not record nMM here

        # best chain end: right-extend every seed (no wa_excl check, like the
        # reference) and pick the highest chain score
        score_best = 0
        ind_best = 0
        for iS1 in range(nA):
            tR2 = wa[iS1][WA_rStart] + wa[iS1][WA_Length]
            tG2 = wa[iS1][WA_gStart] + wa[iS1][WA_Length]
            ext_len = 0
            if tR2 < Lread - 1:
                ext = extend_align(R, G, tR2, tG2, 1, 1, Lread - tR2,
                                   100000, mm_seed[iS1], nmm_max,
                                   P.outFilterMismatchNoverLmax,
                                   P.alignEndsTypeExt[wa[iS1][WA_iFrag]][1 - tr0.Str])
                if ext.ok:
                    score_seed[iS1] += ext.maxScore
                    ext_len = ext.extendL
            if ((wa[iS1][WA_Length] + ext_len) >= P.alignSJoverhangMin
                    and score_seed[iS1] > score_best):
                score_best = score_seed[iS1]
                ind_best = iS1

        # reconstruct the chain (read-order: chain[0] is the last seed)
        chain = []
        cur = ind_best
        while True:
            chain.append(cur)
            wa_incl[cur] = True
            if ind_seed[cur] != -1 and cur > ind_seed[cur]:
                cur = ind_seed[cur]
            else:
                break

        # build the final transcript from the chain
        tr = tr0.copy()
        iS1 = chain[-1]
        score = wa[iS1][WA_Length]
        tr.maxScore = score
        tr.nMatch = wa[iS1][WA_Length]
        tr.nMM = 0
        tr.exons = [[wa[iS1][WA_rStart], wa[iS1][WA_gStart], wa[iS1][WA_Length],
                     wa[iS1][WA_iFrag], wa[iS1][WA_sjA]]]
        tr.rStart = wa[iS1][WA_rStart]
        tr.gStart = wa[iS1][WA_gStart]
        tr.nExons = 1
        for iSc in range(len(chain) - 1, 0, -1):
            a, b = chain[iSc], chain[iSc - 1]
            score += stitch_align_to_transcript(
                wa[a][WA_rStart] + wa[a][WA_Length] - 1,
                wa[a][WA_gStart] + wa[a][WA_Length] - 1,
                wa[b][WA_rStart], wa[b][WA_gStart], wa[b][WA_Length],
                wa[b][WA_iFrag], wa[b][WA_sjA], P, R, gi, tr, nmm_max)
        tr.maxScore = score

        # extend the chain ends
        if tr.exons[0][0] > 0:
            ext = extend_align(R, G, tr.exons[0][0] - 1, tr.exons[0][1] - 1,
                               -1, -1, tr.exons[0][0], 100000, 0, nmm_max,
                               P.outFilterMismatchNoverLmax,
                               P.alignEndsTypeExt[tr.exons[0][3]][tr.Str])
            if ext.ok:
                _add_ext(tr, ext)
                tr.exons[0][0] -= ext.extendL
                tr.exons[0][1] -= ext.extendL
                tr.exons[0][2] += ext.extendL
                tr.rStart = tr.exons[0][0]
                tr.gStart = tr.exons[0][1]
        iS1 = chain[0]
        tR2 = wa[iS1][WA_rStart] + wa[iS1][WA_Length]
        tG2 = wa[iS1][WA_gStart] + wa[iS1][WA_Length]
        if tR2 < Lread:
            ext = extend_align(R, G, tR2, tG2, 1, 1, Lread - tR2,
                               100000, mm_seed[iS1], nmm_max,
                               P.outFilterMismatchNoverLmax,
                               P.alignEndsTypeExt[tr.exons[-1][3]][1 - tr.Str])
            if ext.ok:
                _add_ext(tr, ext)
                tr.exons[-1][2] += ext.extendL

        # final values (reference stitchWindowSeeds.cpp:189-271)
        tr.rLength = sum(e[2] for e in tr.exons)
        tr.gLength = tr.exons[-1][1] + 1 - tr.gStart  # reference quirk: start
        tr.roStart = tr.rStart if tr.roStr == 0 else Lread - tr.rStart - tr.rLength
        if tr.exons[0][3] == tr.exons[-1][3]:
            # maxScoreMate is recorded BEFORE the genomic-length score here
            # (opposite order vs stitchWindowAligns)
            tr.iFrag = tr.exons[0][3]
            ra.maxScoreMate[tr.iFrag] = max(ra.maxScoreMate[tr.iFrag], tr.maxScore)
        else:
            tr.iFrag = -1
        if P.scoreGenomicLengthLog2scale != 0:
            import math
            glen = tr.exons[-1][1] + tr.exons[-1][2] - tr.exons[0][1]
            tr.maxScore += int(math.ceil(
                math.log2(glen) * P.scoreGenomicLengthLog2scale - 0.5))
            tr.maxScore = max(0, tr.maxScore)

        # strand consistency + intron motif filters
        tr.intronMotifs = [0, 0, 0]
        sjN = 0
        for iex in range(tr.nExons - 1):
            if tr.canonSJ[iex] >= 0:
                sjN += 1
                tr.intronMotifs[tr.sjStr[iex]] += 1
        tr.sjYes = sjN > 0
        if tr.intronMotifs[1] > 0 and tr.intronMotifs[2] == 0:
            tr.sjMotifStrand = 1
        elif tr.intronMotifs[1] == 0 and tr.intronMotifs[2] > 0:
            tr.sjMotifStrand = 2
        else:
            tr.sjMotifStrand = 0
        if (tr.intronMotifs[1] > 0 and tr.intronMotifs[2] > 0
                and P.outFilterIntronStrands == "RemoveInconsistentStrands"):
            return None
        if sjN > 0 and tr.sjMotifStrand == 0 and P.outSAMstrandField == "intronMotif":
            return None
        if P.outFilterIntronMotifs == "RemoveNoncanonical":
            if any(c == 0 for c in tr.canonSJ[:tr.nExons - 1]):
                return None
        elif P.outFilterIntronMotifs == "RemoveNoncanonicalUnannotated":
            for iex in range(tr.nExons - 1):
                if tr.canonSJ[iex] == 0 and tr.sjAnnot[iex] == 0:
                    return None
        tr.mappedLength = sum(e[2] for e in tr.exons)
        return tr
