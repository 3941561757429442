"""Chimeric (fusion) detection — best-window vs opposite-segment scan.

Reference behavior: source/ReadAlign_chimericDetectionOld.cpp (the default
--chimMultimapNmax 0 path: segment pairing rules, junction-point scan with
GT/AG motif preference, repeat length, filters),
source/ReadAlign_chimericDetectionOldOutput.cpp (Chimeric.out.junction
columns, CIGARp encoding), source/Transcript_alignScore.cpp (score recompute).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..constants import SCORE_MATCH
from .transcript import Transcript, blocks_overlap


def _ro_span(tr: Transcript, lread: int, read_len0: int) -> Tuple[int, int]:
    if tr.Str == 0:
        ro_start = tr.exons[0][0]
        ro_end = tr.exons[-1][0] + tr.exons[-1][2] - 1
    else:
        ro_start = lread - tr.exons[-1][0] - tr.exons[-1][2]
        ro_end = lread - tr.exons[0][0] - 1
    if ro_start > read_len0:
        ro_start -= 1
    if ro_end > read_len0:
        ro_end -= 1
    return ro_start, ro_end


def _chim_str(tr: Transcript) -> int:
    if tr.intronMotifs[1] == 0 and tr.intronMotifs[2] == 0:
        return 0
    if (tr.Str == 0) == (tr.intronMotifs[1] > 0):
        return 1
    return 2


class ChimericResult:
    __slots__ = ("tr", "chim_j0", "chim_j1", "chim_motif",
                 "chim_repeat0", "chim_repeat1", "chim_str")

    def __init__(self):
        self.tr = [None, None]
        self.chim_j0 = 0
        self.chim_j1 = 0
        self.chim_motif = 0
        self.chim_repeat0 = 0
        self.chim_repeat1 = 0
        self.chim_str = 0


def detect_chimeric_old(res, all_win_tr, read1, gi, P) -> Optional[ChimericResult]:
    """returns a ChimericResult or None (reference chimericDetectionOld)"""
    tr_best = res.tr_best
    n_tr = res.n_tr
    lread = res.lread
    read_length = res.read_length
    G = gi.G_bytes

    if n_tr > P.chimMainSegmentMultNmaxEff and n_tr != 2:
        return None
    if not (P.chimSegmentMin > 0 and tr_best.rLength >= P.chimSegmentMin
            and (tr_best.exons[-1][0] + tr_best.exons[-1][2] + P.chimSegmentMin <= lread
                 or tr_best.exons[0][0] >= P.chimSegmentMin)
            and tr_best.intronMotifs[0] == 0
            and (tr_best.intronMotifs[1] == 0 or tr_best.intronMotifs[2] == 0)):
        return None

    chim_score_best = 0
    chim_score_next = 0
    out = ChimericResult()
    out.tr[0] = tr_best.copy()
    tr_chim1_src = None

    ro_start1, ro_end1 = _ro_span(tr_best, lread, read_length[0])
    chim_str = _chim_str(tr_best)
    chim_str_best = 0

    for win_tr in all_win_tr:
        for i_wt, tr in enumerate(win_tr):
            if tr_best is not win_tr[0] and i_wt > 0:
                break
            if tr_best is win_tr[0] and i_wt == 0:
                continue
            if tr.intronMotifs[0] > 0:
                continue
            chim_str1 = _chim_str(tr)
            if chim_str != 0 and chim_str1 != 0 and chim_str != chim_str1:
                continue
            ro_start2, ro_end2 = _ro_span(tr, lread, read_length[0])
            if ro_start2 > ro_start1:
                chim_overlap = 0 if ro_start2 > ro_end1 else ro_end1 - ro_start2 + 1
            else:
                chim_overlap = 0 if ro_end2 < ro_start1 else ro_end2 - ro_start1 + 1
            diff_mates = ((ro_end1 < read_length[0] and ro_start2 >= read_length[0])
                          or (ro_end2 < read_length[0] and ro_start1 >= read_length[0]))
            if not (ro_end1 > P.chimSegmentMin + ro_start1 + chim_overlap
                    and ro_end2 > P.chimSegmentMin + ro_start2 + chim_overlap
                    and (diff_mates
                         or (ro_end1 + P.chimSegmentReadGapMax + 1 >= ro_start2
                             and ro_end2 + P.chimSegmentReadGapMax + 1 >= ro_start1))):
                continue
            chim_score = tr_best.maxScore + tr.maxScore - chim_overlap
            overlap1 = 0
            if i_wt > 0 and chim_score_best > 0:
                overlap1 = blocks_overlap(out.tr[1], tr)
            if chim_score > chim_score_best:
                out.tr[1] = tr.copy()
                tr_chim1_src = tr
                if overlap1 == 0:
                    chim_score_next = chim_score_best
                chim_score_best = chim_score
                out.tr[1].roStart = (out.tr[1].rStart if out.tr[1].roStr == 0
                                     else lread - out.tr[1].rStart - out.tr[1].rLength)
                out.tr[1].cStart = out.tr[1].gStart - int(gi.chr_start[out.tr[1].Chr])
                chim_str_best = chim_str1
            elif chim_score > chim_score_next and overlap1 == 0:
                chim_score_next = chim_score

    if not (chim_score_best >= P.chimScoreMin
            and chim_score_best + P.chimScoreDropMax >= read_length[0] + read_length[1]):
        return None
    if n_tr > P.chimMainSegmentMultNmaxEff:
        if tr_chim1_src is not res.transcripts[0] and tr_chim1_src is not res.transcripts[1]:
            return None
    if chim_str == 0:
        chim_str = chim_str_best
    if chim_score_next + P.chimScoreSeparation >= chim_score_best:
        return None

    tr0, tr1 = out.tr
    if tr0.roStart > tr1.roStart:
        tr0, tr1 = tr1, tr0
        out.tr = [tr0, tr1]

    e0 = 0 if tr0.Str == 1 else tr0.nExons - 1
    e1 = 0 if tr1.Str == 0 else tr1.nExons - 1

    chim_repeat0 = chim_repeat1 = 0
    chim_j0 = chim_j1 = 0
    chim_motif = 0

    if tr0.exons[e0][3] > tr1.exons[e1][3]:
        return None
    elif tr0.exons[e0][3] < tr1.exons[e1][3]:
        chim_motif = -1
        chim_j0 = tr0.exons[e0][1] - 1 if tr0.Str == 1 else tr0.exons[e0][1] + tr0.exons[e0][2]
        chim_j1 = tr1.exons[e1][1] - 1 if tr1.Str == 0 else tr1.exons[e1][1] + tr1.exons[e1][2]
    else:
        if not (tr0.exons[e0][2] >= P.chimJunctionOverhangMin
                and tr1.exons[e1][2] >= P.chimJunctionOverhangMin):
            return None
        ro_s0 = tr0.exons[e0][0] if tr0.Str == 0 else lread - tr0.exons[e0][0] - tr0.exons[e0][2]
        ro_s1 = tr1.exons[e1][0] if tr1.Str == 0 else lread - tr1.exons[e1][0] - tr1.exons[e1][2]

        j_rbest = 0
        j_score = 0
        j_score_best = -999999
        j_rmax = ro_s1 + tr1.exons[e1][2]
        j_rmax = j_rmax - ro_s0 - 1 if j_rmax > ro_s0 else 0
        chim_ok = True
        jR = 0
        while jR < j_rmax:
            if jR == read_length[0]:
                jR += 1
            bR = read1[ro_s0 + jR]
            if tr0.Str == 0:
                b0 = G[tr0.exons[e0][1] + jR]
            else:
                b0 = G[tr0.exons[e0][1] + tr0.exons[e0][2] - 1 - jR]
                if b0 < 4:
                    b0 = 3 - b0
            if tr1.Str == 0:
                b1 = G[tr1.exons[e1][1] - ro_s1 + ro_s0 + jR]
            else:
                b1 = G[tr1.exons[e1][1] + tr1.exons[e1][2] - 1 + ro_s1 - ro_s0 - jR]
                if b1 < 4:
                    b1 = 3 - b1
            if (P.chimFilterGenomicN and (b0 > 3 or b1 > 3)) or bR > 3:
                chim_ok = False
                break
            if tr0.Str == 0:
                b01 = G[tr0.exons[e0][1] + jR + 1]
                b02 = G[tr0.exons[e0][1] + jR + 2]
            else:
                b01 = G[tr0.exons[e0][1] + tr0.exons[e0][2] - 1 - jR - 1]
                if b01 < 4:
                    b01 = 3 - b01
                b02 = G[tr0.exons[e0][1] + tr0.exons[e0][2] - 1 - jR - 2]
                if b02 < 4:
                    b02 = 3 - b02
            if tr1.Str == 0:
                b11 = G[tr1.exons[e1][1] - ro_s1 + ro_s0 + jR - 1]
                b12 = G[tr1.exons[e1][1] - ro_s1 + ro_s0 + jR]
            else:
                b11 = G[tr1.exons[e1][1] + tr1.exons[e1][2] - 1 + ro_s1 - ro_s0 - jR + 1]
                if b11 < 4:
                    b11 = 3 - b11
                b12 = G[tr1.exons[e1][1] + tr1.exons[e1][2] - 1 + ro_s1 - ro_s0 - jR]
                if b12 < 4:
                    b12 = 3 - b12
            j_motif = 0
            if b01 == 2 and b02 == 3 and b11 == 0 and b12 == 2:
                if chim_str != 2:
                    j_motif = 1
            elif b01 == 1 and b02 == 3 and b11 == 0 and b12 == 1:
                if chim_str != 1:
                    j_motif = 2
            if bR == b0 and bR != b1:
                j_score += 1
            elif bR != b0 and bR == b1:
                j_score -= 1
            j_score_j = j_score + P.chimScoreJunctionNonGTAG if j_motif == 0 else j_score
            if j_score_j > j_score_best or (j_score_j == j_score_best and j_motif > 0):
                chim_motif = j_motif
                j_rbest = jR
                j_score_best = j_score_j
            jR += 1
        if not chim_ok:
            return None
        if chim_motif == 0:
            chim_score_best += 1 + P.chimScoreJunctionNonGTAG
            if not (chim_score_best >= P.chimScoreMin
                    and chim_score_best + P.chimScoreDropMax
                    >= read_length[0] + read_length[1]):
                return None
        # shift junction
        if tr0.Str == 1:
            tr0.exons[e0][0] += tr0.exons[e0][2] - j_rbest - 1
            tr0.exons[e0][1] += tr0.exons[e0][2] - j_rbest - 1
            tr0.exons[e0][2] = j_rbest + 1
            chim_j0 = tr0.exons[e0][1] - 1
        else:
            tr0.exons[e0][2] = j_rbest + 1
            chim_j0 = tr0.exons[e0][1] + tr0.exons[e0][2]
        if tr1.Str == 0:
            tr1.exons[e1][0] += ro_s0 + j_rbest + 1 - ro_s1
            tr1.exons[e1][1] += ro_s0 + j_rbest + 1 - ro_s1
            tr1.exons[e1][2] = ro_s1 + tr1.exons[e1][2] - ro_s0 - j_rbest - 1
            chim_j1 = tr1.exons[e1][1] - 1
        else:
            tr1.exons[e1][2] = ro_s1 + tr1.exons[e1][2] - ro_s0 - j_rbest - 1
            chim_j1 = tr1.exons[e1][1] + tr1.exons[e1][2]
        # repeat lengths around the junction
        for jR in range(100):
            b0 = G[chim_j0 + jR] if tr0.Str == 0 else G[chim_j0 - jR]
            if tr0.Str == 1 and b0 < 4:
                b0 = 3 - b0
            b1 = G[chim_j1 + 1 + jR] if tr1.Str == 0 else G[chim_j1 - 1 - jR]
            if tr1.Str == 1 and b1 < 4:
                b1 = 3 - b1
            if b0 != b1:
                break
        chim_repeat1 = jR
        for jR in range(100):
            b0 = G[chim_j0 - 1 - jR] if tr0.Str == 0 else G[chim_j0 + 1 + jR]
            if tr0.Str == 1 and b0 < 4:
                b0 = 3 - b0
            b1 = G[chim_j1 - jR] if tr1.Str == 0 else G[chim_j1 + jR]
            if tr1.Str == 1 and b1 < 4:
                b1 = 3 - b1
            if b0 != b1:
                break
        chim_repeat0 = jR

    out.chim_j0 = chim_j0
    out.chim_j1 = chim_j1
    out.chim_motif = chim_motif
    out.chim_repeat0 = chim_repeat0
    out.chim_repeat1 = chim_repeat1
    out.chim_str = chim_str

    intron_limit = P.alignIntronMax if chim_motif >= 0 else P.alignMatesGapMax
    # uint64 semantics: a "negative" distance wraps to huge and passes the
    # far-away test (reference: chimericDetectionOld.cpp:299 unsigned arith)
    dist = ((chim_j1 - chim_j0 + 1) if tr0.Str == 0 else (chim_j0 - chim_j1 + 1)) % (1 << 64)
    if tr0.Str != tr1.Str or tr0.Chr != tr1.Chr or dist > intron_limit:
        if chim_motif >= 0 and (tr0.exons[e0][2] < P.chimJunctionOverhangMin + chim_repeat0
                                or tr1.exons[e1][2] < P.chimJunctionOverhangMin + chim_repeat1):
            return None
        return out
    return None


def align_score(tr: Transcript, read1, read1rc, gi, P) -> int:
    """recompute score + mismatches from the alignment
    (reference Transcript_alignScore.cpp)"""
    import math
    tr.maxScore = 0
    tr.nMM = 0
    tr.nMatch = 0
    if tr.nExons == 0:
        return 0
    R = read1 if tr.roStr == 0 else read1rc
    G = gi.G_bytes
    for iex in range(tr.nExons):
        r0, g0, ln = tr.exons[iex][0], tr.exons[iex][1], tr.exons[iex][2]
        for ii in range(ln):
            r1 = R[r0 + ii]
            g1 = G[g0 + ii]
            if r1 > 3 or g1 > 3:
                pass
            elif r1 == g1:
                tr.maxScore += 1
                tr.nMatch += 1
            else:
                tr.nMM += 1
                tr.maxScore -= 1
    for iex in range(tr.nExons - 1):
        if tr.sjAnnot[iex] == 1:
            tr.maxScore += P.sjdbScore
        else:
            c = tr.canonSJ[iex]
            if c == -2:
                tr.maxScore += (tr.exons[iex + 1][0] - tr.exons[iex][0]
                                - tr.exons[iex][2]) * P.scoreInsBase + P.scoreInsOpen
            elif c == -1:
                tr.maxScore += (tr.exons[iex + 1][1] - tr.exons[iex][1]
                                - tr.exons[iex][2]) * P.scoreDelBase + P.scoreDelOpen
            elif c == 0:
                tr.maxScore += P.scoreGapNoncan + P.scoreGap
            elif c in (1, 2):
                tr.maxScore += P.scoreGap
            elif c in (3, 4):
                tr.maxScore += P.scoreGapGCAG + P.scoreGap
            elif c in (5, 6):
                tr.maxScore += P.scoreGapATAC + P.scoreGap
    if P.scoreGenomicLengthLog2scale != 0:
        glen = max(1, tr.exons[-1][1] + tr.exons[-1][2] - tr.exons[0][1])
        tr.maxScore += int(math.ceil(
            math.log2(glen) * P.scoreGenomicLengthLog2scale - 0.5))
    return tr.maxScore


def cigar_p(tr: Transcript, res, P) -> str:
    """CIGARp with the inter-mate 'p' operation
    (reference ReadAlign_outputTranscriptCIGARp.cpp)"""
    read_length = res.read_length
    left_mate = tr.Str if len(res.seqs) > 1 else 0
    parts = []
    trim_l = tr.exons[0][0] - (0 if tr.exons[0][0] < read_length[left_mate]
                               else read_length[left_mate] + 1)
    if trim_l > 0:
        parts.append(f"{trim_l}S")
    for ii in range(tr.nExons):
        if ii > 0:
            gap_g = tr.exons[ii][1] - (tr.exons[ii - 1][1] + tr.exons[ii - 1][2])
            if tr.exons[ii][1] >= tr.exons[ii - 1][1] + tr.exons[ii - 1][2]:
                if tr.canonSJ[ii - 1] == -3:
                    s1 = read_length[left_mate] - (tr.exons[ii - 1][0] + tr.exons[ii - 1][2])
                    s2 = tr.exons[ii][0] - (read_length[left_mate] + 1)
                    if s1 > 0:
                        parts.append(f"{s1}S")
                    parts.append(f"{gap_g}p")
                    if s2 > 0:
                        parts.append(f"{s2}S")
                else:
                    gap_r = tr.exons[ii][0] - tr.exons[ii - 1][0] - tr.exons[ii - 1][2]
                    if gap_r > 0:
                        parts.append(f"{gap_r}I")
                    if tr.canonSJ[ii - 1] >= 0 or tr.sjAnnot[ii - 1] == 1:
                        parts.append(f"{gap_g}N")
                    elif gap_g > 0:
                        parts.append(f"{gap_g}D")
            else:
                parts.append(f"-{tr.exons[ii - 1][1] + tr.exons[ii - 1][2] - tr.exons[ii][1]}p")
        parts.append(f"{tr.exons[ii][2]}M")
    trim_r = (read_length[left_mate] if tr.exons[-1][0] < read_length[left_mate]
              else read_length[0] + read_length[1] + 1) \
        - tr.exons[-1][0] - tr.exons[-1][2]
    if trim_r > 0:
        parts.append(f"{trim_r}S")
    return "".join(parts)


def junction_line(chim: ChimericResult, res, gi, P) -> str:
    tr0, tr1 = chim.tr
    c0 = int(gi.chr_start[tr0.Chr])
    c1 = int(gi.chr_start[tr1.Chr])
    return (f"{gi.chr_name[tr0.Chr]}\t{chim.chim_j0 - c0 + 1}\t{'+' if tr0.Str == 0 else '-'}"
            f"\t{gi.chr_name[tr1.Chr]}\t{chim.chim_j1 - c1 + 1}\t{'+' if tr1.Str == 0 else '-'}"
            f"\t{chim.chim_motif}\t{chim.chim_repeat0}\t{chim.chim_repeat1}\t{res.name}"
            f"\t{tr0.exons[0][1] - c0 + 1}\t{cigar_p(tr0, res, P)}"
            f"\t{tr1.exons[0][1] - c1 + 1}\t{cigar_p(tr1, res, P)}")


# ---------------------------------------------------------------- mult path
class ChimericSegmentM:
    """one candidate chimeric segment (reference ChimericSegment.cpp)"""
    __slots__ = ("align", "str_", "roS", "roE")

    def __init__(self, tr: Transcript, lread: int, read_len0: int):
        self.align = tr
        self.str_ = _chim_str(tr)
        if tr.Str == 0:
            self.roS = tr.exons[0][0]
            self.roE = tr.exons[-1][0] + tr.exons[-1][2] - 1
        else:
            self.roS = lread - tr.exons[-1][0] - tr.exons[-1][2]
            self.roE = lread - tr.exons[0][0] - 1
        if self.roS > read_len0:
            self.roS -= 1
        if self.roE > read_len0:
            self.roE -= 1

    def check(self, P) -> bool:
        return (self.align.rLength >= P.chimSegmentMin
                and self.align.intronMotifs[0] == 0)


def _chim_align_score(seg1, seg2, P, read_len0) -> int:
    """(reference chimericAlignScore, ChimericDetection_chimericDetectionMult.cpp:6-21)"""
    if seg2.roS > seg1.roS:
        overlap = 0 if seg2.roS > seg1.roE else seg1.roE - seg2.roS + 1
    else:
        overlap = 0 if seg2.roE < seg1.roS else seg2.roE - seg1.roS + 1
    diff_mates = ((seg1.roE < read_len0 and seg2.roS >= read_len0)
                  or (seg2.roE < read_len0 and seg1.roS >= read_len0))
    if (seg1.roE > P.chimSegmentMin + seg1.roS + overlap
            and seg2.roE > P.chimSegmentMin + seg2.roS + overlap
            and (diff_mates
                 or ((seg1.roE + P.chimSegmentReadGapMax + 1) >= seg2.roS
                     and (seg2.roE + P.chimSegmentReadGapMax + 1) >= seg1.roS))):
        return seg1.align.maxScore + seg2.align.maxScore - overlap
    return 0


class ChimericAlignM:
    """stitched multimapping chimera (reference ChimericAlign.{h,cpp})"""
    __slots__ = ("al1", "al2", "ex1", "ex2", "chimJ1", "chimJ2",
                 "chimRepeat1", "chimRepeat2", "chimMotif", "chimStr",
                 "chimScore", "stitched")

    def __init__(self, seg1, seg2):
        al1, al2 = seg1.align, seg2.align
        s1, s2 = seg1, seg2
        if al1.roStart > al2.roStart:
            al1, al2 = al2, al1
            s1, s2 = s2, s1
        self.al1, self.al2 = al1, al2
        self.ex1 = 0 if al1.Str == 1 else al1.nExons - 1
        self.ex2 = 0 if al2.Str == 0 else al2.nExons - 1
        self.chimStr = max(seg1.str_, seg2.str_)
        self.chimJ1 = self.chimJ2 = 0
        self.chimRepeat1 = self.chimRepeat2 = 0
        self.chimMotif = 0
        self.chimScore = 0
        self.stitched = False

    def check(self, P) -> bool:
        """(reference ChimericAlign::chimericCheck)"""
        a1, a2, e1, e2 = self.al1, self.al2, self.ex1, self.ex2
        if not a1.exons[e1][3] <= a2.exons[e2][3]:
            return False
        return (a1.exons[e1][3] < a2.exons[e2][3]
                or (a1.exons[e1][2] >= P.chimJunctionOverhangMin
                    and a2.exons[e2][2] >= P.chimJunctionOverhangMin))

    def stitch(self, res, read1, read1rc, gi, P):
        """junction micro-optimization + rescoring
        (reference ChimericAlign_chimericStitching.cpp)"""
        if self.stitched:
            return
        self.stitched = True
        G = gi.G_bytes
        lread = res.lread
        read_len0 = res.read_length[0]
        a1 = self.al1 = self.al1.copy()
        a2 = self.al2 = self.al2.copy()
        e1, e2 = self.ex1, self.ex2

        if a1.exons[e1][3] < a2.exons[e2][3]:
            # mates bracket the chimeric junction
            self.chimMotif = -1
            if a1.Str == 1:
                self.chimJ1 = a1.exons[e1][1] - 1
            else:
                self.chimJ1 = a1.exons[e1][1] + a1.exons[e1][2]
            if a2.Str == 0:
                self.chimJ2 = a2.exons[e2][1] - 1
            else:
                self.chimJ2 = a2.exons[e2][1] + a2.exons[e2][2]
        else:
            # junction within a mate: scan for the best junction point
            ro0 = a1.exons[e1][0] if a1.Str == 0 else \
                lread - a1.exons[e1][0] - a1.exons[e1][2]
            ro1 = a2.exons[e2][0] if a2.Str == 0 else \
                lread - a2.exons[e2][0] - a2.exons[e2][2]
            jr_best = 0
            j_score = 0
            j_score_best = -999999
            self.chimMotif = 0
            jr_max = ro1 + a2.exons[e2][2]
            jr_max = jr_max - ro0 - 1 if jr_max > ro0 else 0
            jr = 0
            while jr < jr_max:
                if jr == read_len0:
                    jr += 1
                b_r = read1[ro0 + jr]
                if a1.Str == 0:
                    b0 = G[a1.exons[e1][1] + jr]
                else:
                    b0 = G[a1.exons[e1][1] + a1.exons[e1][2] - 1 - jr]
                    if b0 < 4:
                        b0 = 3 - b0
                if a2.Str == 0:
                    b1 = G[a2.exons[e2][1] - ro1 + ro0 + jr]
                else:
                    b1 = G[a2.exons[e2][1] + a2.exons[e2][2] - 1 + ro1 - ro0 - jr]
                    if b1 < 4:
                        b1 = 3 - b1
                if (P.chimFilterGenomicN and (b0 > 3 or b1 > 3)) or b_r > 3:
                    self.chimScore = 0
                    return
                if a1.Str == 0:
                    b01 = G[a1.exons[e1][1] + jr + 1]
                    b02 = G[a1.exons[e1][1] + jr + 2]
                else:
                    b01 = G[a1.exons[e1][1] + a1.exons[e1][2] - 1 - jr - 1]
                    if b01 < 4:
                        b01 = 3 - b01
                    b02 = G[a1.exons[e1][1] + a1.exons[e1][2] - 1 - jr - 2]
                    if b02 < 4:
                        b02 = 3 - b02
                if a2.Str == 0:
                    b11 = G[a2.exons[e2][1] - ro1 + ro0 + jr - 1]
                    b12 = G[a2.exons[e2][1] - ro1 + ro0 + jr]
                else:
                    b11 = G[a2.exons[e2][1] + a2.exons[e2][2] - 1 + ro1 - ro0 - jr + 1]
                    if b11 < 4:
                        b11 = 3 - b11
                    b12 = G[a2.exons[e2][1] + a2.exons[e2][2] - 1 + ro1 - ro0 - jr]
                    if b12 < 4:
                        b12 = 3 - b12
                j_motif = 0
                if b01 == 2 and b02 == 3 and b11 == 0 and b12 == 2:
                    if self.chimStr != 2:
                        j_motif = 1
                elif b01 == 1 and b02 == 3 and b11 == 0 and b12 == 1:
                    if self.chimStr != 1:
                        j_motif = 2
                if b_r == b0 and b_r != b1:
                    j_score += 1
                elif b_r != b0 and b_r == b1:
                    j_score -= 1
                j_score_j = j_score + P.chimScoreJunctionNonGTAG \
                    if j_motif == 0 else j_score
                if j_score_j > j_score_best or (j_score_j == j_score_best
                                                and j_motif > 0):
                    self.chimMotif = j_motif
                    jr_best = jr
                    j_score_best = j_score_j
                jr += 1

            # shift junction into the transcripts
            if a1.Str == 1:
                a1.exons[e1][0] += a1.exons[e1][2] - jr_best - 1
                a1.exons[e1][1] += a1.exons[e1][2] - jr_best - 1
                a1.exons[e1][2] = jr_best + 1
                self.chimJ1 = a1.exons[e1][1] - 1
            else:
                a1.exons[e1][2] = jr_best + 1
                self.chimJ1 = a1.exons[e1][1] + a1.exons[e1][2]
            if a2.Str == 0:
                a2.exons[e2][0] += ro0 + jr_best + 1 - ro1
                a2.exons[e2][1] += ro0 + jr_best + 1 - ro1
                a2.exons[e2][2] = ro1 + a2.exons[e2][2] - ro0 - jr_best - 1
                self.chimJ2 = a2.exons[e2][1] - 1
            else:
                a2.exons[e2][2] = ro1 + a2.exons[e2][2] - ro0 - jr_best - 1
                self.chimJ2 = a2.exons[e2][1] + a2.exons[e2][2]

            # micro-homology repeat lengths around the junction
            for jr in range(100):
                b0 = G[self.chimJ1 + jr] if a1.Str == 0 else G[self.chimJ1 - jr]
                if a1.Str != 0 and b0 < 4:
                    b0 = 3 - b0
                b1 = G[self.chimJ2 + 1 + jr] if a2.Str == 0 else G[self.chimJ2 - 1 - jr]
                if a2.Str != 0 and b1 < 4:
                    b1 = 3 - b1
                if b0 != b1:
                    break
            self.chimRepeat2 = jr
            for jr in range(100):
                b0 = G[self.chimJ1 - 1 - jr] if a1.Str == 0 else G[self.chimJ1 + 1 + jr]
                if a1.Str != 0 and b0 < 4:
                    b0 = 3 - b0
                b1 = G[self.chimJ2 - jr] if a2.Str == 0 else G[self.chimJ2 + jr]
                if a2.Str != 0 and b1 < 4:
                    b1 = 3 - b1
                if b0 != b1:
                    break
            self.chimRepeat1 = jr

        if self.chimMotif >= 0 and (a1.exons[e1][2] < P.chimJunctionOverhangMin
                                    or a2.exons[e2][2] < P.chimJunctionOverhangMin):
            self.chimScore = 0
            return
        self.chimScore = (align_score(a1, read1, read1rc, gi, P)
                          + align_score(a2, read1, read1rc, gi, P)
                          + (P.chimScoreJunctionNonGTAG
                             if self.chimMotif == 0 else 0))


def detect_chimeric_mult(res, all_win_tr, read1, read1rc, gi, P):
    """--chimMultimapNmax > 0 path: all window-pair segments, stitched and
    kept within chimMultimapScoreRange of the best
    (reference ChimericDetection_chimericDetectionMult.cpp).
    Returns (records, chimN, best_index, min_score) or None."""
    read_length = res.read_length
    lread = res.lread
    max_nonchim = res.tr_best.maxScore
    max_possible = read_length[0] + read_length[1]
    min_score = P.chimScoreMin
    if max_nonchim >= min_score:
        min_score = max_nonchim + 1
    if max_possible - P.chimScoreDropMax > min_score:
        min_score = max_possible - P.chimScoreDropMax

    chim_aligns = []
    best_score = 0
    best_i = 0
    n_w = len(all_win_tr)
    for iw1 in range(n_w):
        for ia1 in range(len(all_win_tr[iw1])):
            seg1 = ChimericSegmentM(all_win_tr[iw1][ia1], lread, read_length[0])
            if not seg1.check(P):
                continue
            for iw2 in range(iw1, n_w):
                for ia2 in range(ia1 + 1 if iw1 == iw2 else 0,
                                 len(all_win_tr[iw2])):
                    seg2 = ChimericSegmentM(all_win_tr[iw2][ia2], lread,
                                            read_length[0])
                    if not seg2.check(P):
                        continue
                    if seg1.str_ != 0 and seg2.str_ != 0 \
                            and seg2.str_ != seg1.str_:
                        continue
                    score = _chim_align_score(seg1, seg2, P, read_length[0])
                    if score >= min_score:
                        ch = ChimericAlignM(seg1, seg2)
                        if not ch.check(P):
                            continue
                        ch.chimScore = score
                        ch.stitch(res, read1, read1rc, gi, P)
                        if ch.chimScore >= min_score:
                            chim_aligns.append(ch)
                            if ch.chimScore > best_score:
                                best_score = ch.chimScore
                                best_i = len(chim_aligns) - 1
                                if best_score - P.chimMultimapScoreRange > min_score:
                                    min_score = best_score - P.chimMultimapScoreRange
    if best_score == 0:
        return None
    chim_n = sum(1 for c in chim_aligns if c.chimScore >= min_score)
    if chim_n > P.chimMultimapNmax:
        return None
    return chim_aligns, chim_n, best_i, min_score


def junction_line_mult(ch: ChimericAlignM, res, gi, P, chim_n, max_nonchim,
                       pe_merged, best_score, max_possible) -> str:
    """(reference ChimericAlign_chimericJunctionOutput.cpp)"""
    a1, a2 = ch.al1, ch.al2
    c1s = int(gi.chr_start[a1.Chr])
    c2s = int(gi.chr_start[a2.Chr])
    f = [gi.chr_name[a1.Chr], str(ch.chimJ1 - c1s + 1),
         "+" if a1.Str == 0 else "-",
         gi.chr_name[a2.Chr], str(ch.chimJ2 - c2s + 1),
         "+" if a2.Str == 0 else "-",
         str(ch.chimMotif), str(ch.chimRepeat1), str(ch.chimRepeat2),
         res.name,
         str(a1.exons[0][1] - c1s + 1), cigar_p(a1, res, P),
         str(a2.exons[0][1] - c2s + 1), cigar_p(a2, res, P),
         str(chim_n), str(max_possible), str(max_nonchim),
         str(ch.chimScore), str(best_score), str(int(pe_merged))]
    return "\t".join(f)
