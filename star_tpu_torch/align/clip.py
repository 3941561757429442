"""Read clipping: fixed 5p/3p clips, Hamming 3p adapter, CellRanger4 TSO/polyA.

Reference behavior: source/ClipMate_clip.cpp (clip order: Nbases -> adapter ->
NafterAd; 5p shifts the sequence), source/SequenceFuns.cpp:293 localSearch
(best mismatch-proportion placement of the adapter), source/ClipCR4.cpp
(polyTail3p scan; 5p TSO via opal overlap-mode Smith-Waterman with +1/-2
scores and linear gap 2 — the OV-mode scoring/end-location semantics
replicated from source/opal/opal.cpp:640-910, incl. the 91-column N-padded
target and the strictly-greater tie rules), source/ClipMate_clipChunk.cpp:
(L0 rejection: S<20 || (S==20&&L>26) || (S==21&&L>30)),
source/ParametersClip_initialize.cpp (defaults: TSO AAGCAGTGGTATCAACGCAGAGTACATGGG,
3p adapter "A" for CellRanger4).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

NEG_INF = -(1 << 30)
CR4_READ_LEN = 91  # ClipCR4.cpp:16 readLen
CR4_TSO = "AAGCAGTGGTATCAACGCAGAGTACATGGG"
# ClipCR4 score matrix: +1 match, -2 mismatch, N(4) vs N = 0
_CR4_SCORE = [[1, -2, -2, -2, -2],
              [-2, 1, -2, -2, -2],
              [-2, -2, 1, -2, -2],
              [-2, -2, -2, 1, -2],
              [-2, -2, -2, -2, 0]]


def local_search(x, nx: int, y, ny: int, p_mm: float) -> int:
    """reference localSearch: best adapter placement, returns start index
    (nx if no acceptable placement)"""
    n_match_best = 0
    n_mm_best = 0
    ix_best = nx
    for ix in range(nx):
        n_match = 0
        n_mm = 0
        for iy in range(min(ny, nx - ix)):
            if x[ix + iy] > 3:
                continue
            if x[ix + iy] == y[iy]:
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


def opal_ov_score_end(query: List[int], target: List[int]):
    """opal OV-mode (SCORE_END): returns (score, end_target, end_query).

    Free leading/trailing gaps in both sequences; best score = max(last
    row over all columns, last column); last column wins ties only when
    strictly greater (opal.cpp:883-905); the recorded last-row column is
    the first column attaining the last-row max (strict-increase updates).
    """
    nq, nt = len(query), len(target)
    prev_h = [0] * nq
    prev_e = [NEG_INF] * nq
    max_last_row = NEG_INF
    best_col = -1
    col_max = NEG_INF
    for c in range(nt):
        prev_max_last = max_last_row
        u_h = ul_h = 0
        u_f = NEG_INF
        col_max = NEG_INF
        row = _CR4_SCORE
        tc = target[c]
        h = 0
        for r in range(nq):
            e = max(prev_h[r] - 2, prev_e[r] - 2)
            f = max(u_h - 2, u_f - 2)
            h = max(f, e, ul_h + row[query[r]][tc])
            if h > col_max:
                col_max = h
            u_f, u_h, ul_h = f, h, prev_h[r]
            prev_e[r], prev_h[r] = e, h
        if h > max_last_row:
            max_last_row = h
        if max_last_row > prev_max_last:
            best_col = c
    score = max(col_max, max_last_row)
    if col_max > max_last_row:
        end_t = nt - 1
        max_score = max_last_row
        end_q = -1
        for r in range(nq):
            if prev_h[r] > max_score:
                end_q = r
                max_score = prev_h[r]
    else:
        end_t = best_col
        end_q = nq - 1
    return score, end_t, end_q


def cr4_clip5p_info(seq_num, lread: int, ad_num: List[int]) -> int:
    """clippedInfo for the CR4 5p TSO clip (ClipMate_clipChunk.cpp:43-52):
    target = first 91 bases, N-padded to 91"""
    target = [int(b) if int(b) <= 4 else 4
              for b in seq_num[:min(lread, CR4_READ_LEN)]]
    target += [4] * (CR4_READ_LEN - len(target))
    s, end_t, _ = opal_ov_score_end(ad_num, target)
    l = end_t + 1
    l0 = s < 20 or (s == 20 and l > 26) or (s == 21 and l > 30)
    return 0 if l0 else l


def cr4_clip5p_info_batch(seqs_num, n5: int, ad_num: List[int]):
    """cr4_clip5p_info of many reads at once, each after a 5p clip of n5
    bases (ClipMate.clip's order), as numpy over the reads: an int array.

    With the +1/-2 scores and a linear gap of 2, opal's E and F of a cell
    are always the H above / to the left minus 2 (H >= E, F), so one
    column of opal_ov_score_end is H[r] = max(Hl[r] - 2, H[r-1] - 2,
    Hl[r-1] + s(q[r], t)), zero above and left of the matrix; the vertical
    chain is a running maximum of g[k] + 2k, less 2r.  Ties and end columns
    follow opal_ov_score_end exactly."""
    import numpy as np
    B = len(seqs_num)
    tgt = np.full((B, CR4_READ_LEN), 4, np.int64)
    for i, m in enumerate(seqs_num):
        off, lread = (0, 0) if 0 < n5 >= len(m) else (n5, len(m) - n5)
        k = min(lread, CR4_READ_LEN)
        tgt[i, :k] = m[off:off + k]
    q = np.asarray(ad_num, np.int64)
    score = np.asarray(_CR4_SCORE, np.int64)[q]        # [nq, 5]
    two_r = 2 * np.arange(len(q), dtype=np.int64)
    h = np.zeros((B, len(q)), np.int64)
    diag = np.zeros_like(h)
    max_last_row = np.full(B, NEG_INF, np.int64)
    best_col = np.full(B, -1, np.int64)
    for c in range(CR4_READ_LEN):
        diag[:, 1:] = h[:, :-1]
        g = np.maximum(h - 2, diag + score[:, tgt[:, c]].T)
        h = np.maximum(np.maximum.accumulate(g + two_r, axis=1), -2) - two_r
        up = h[:, -1] > max_last_row
        best_col[up] = c
        max_last_row[up] = h[up, -1]
    col_max = h.max(axis=1)
    s = np.maximum(col_max, max_last_row)
    l = np.where(col_max > max_last_row, CR4_READ_LEN - 1, best_col) + 1
    l0 = (s < 20) | ((s == 20) & (l > 26)) | ((s == 21) & (l > 30))
    return np.where(l0, 0, l)


def poly_tail_3p(seq_num, seq_len: int) -> int:
    """reference ClipCR4::polyTail3p (polyA clip, hardcoded CR4 thresholds)"""
    if seq_len < 20:
        return 0
    ib1 = seq_len - 1
    score = 0
    score1 = 0
    for ib in range(1, seq_len + 1):
        if seq_num[seq_len - ib] == 0:
            score += 1
            if score * 10 >= ib * 7:
                ib1 = ib
                score1 = score
        else:
            score -= 2
            if ib - score > 27:
                break
    if score1 < 20:
        ib1 = 0
    return ib1


class ClipMate:
    """one clip stage (5p or 3p) for one mate (reference ClipMate)"""

    def __init__(self, type_: int, n: int, ad_seq: str, n_after_ad: int,
                 ad_mmp: float):
        self.type = type_  # 0=5p, 1=3p, 10/11 = CellRanger4 5p/3p
        self.n = n
        self.ad_seq = "" if ad_seq in ("-", "") else ad_seq
        self.ad_num = [{"A": 0, "C": 1, "G": 2, "T": 3}.get(c, 4)
                       for c in self.ad_seq]
        self.n_after_ad = n_after_ad
        self.ad_mmp = ad_mmp
        self.clipped_n = 0
        self.batch_info = {}     # (mate bytes, length) -> clip_batch's info

    def clip_batch(self, seqs: List[str]) -> None:
        """the 5p CellRanger4 TSO clip of a batch of whole mates at once
        (cr4_clip5p_info_batch); clip then takes a mate's info from here
        instead of running its DP.  Other clip types keep nothing."""
        from ..constants import encode_seq
        self.batch_info = {}
        if self.type == 10 and self.ad_seq and seqs:
            seqs_num = [encode_seq(s) for s in seqs]
            info = cr4_clip5p_info_batch(seqs_num, self.n, self.ad_num)
            self.batch_info = {(m.tobytes(), len(m)): int(i)
                               for m, i in zip(seqs_num, info)}

    def clip(self, seq_num, lread: int) -> Tuple[int, int]:
        """returns (new_lread, offset_into_seq); mirrors ClipMate::clip.
        seq_num is the current (already offset) numeric sequence view."""
        self.clipped_n = 0
        if self.type < 0:
            return lread, 0
        lread_old = lread
        off = 0
        if self.n > 0:
            if lread > self.n:
                lread -= self.n
                self.clipped_n += self.n
                if self.type in (0, 10):
                    off += self.n
            else:
                lread = 0
                self.clipped_n = lread_old
        if self.ad_seq:
            clipped_ad = 0
            if self.type == 1:  # 3p Hamming
                clipped_ad = lread - local_search(
                    seq_num[off:off + lread], lread, self.ad_num,
                    len(self.ad_num), self.ad_mmp)
            elif self.type == 10:  # 5p CR4 (TSO)
                info = self.batch_info.get((seq_num.tobytes(), lread_old))
                if info is None:
                    info = cr4_clip5p_info(seq_num[off:], lread, self.ad_num)
                clipped_ad = min(info, lread)
                off += clipped_ad
            elif self.type == 11:  # 3p CR4 (polyA)
                clipped_ad = poly_tail_3p(seq_num[off:off + lread], lread)
            lread -= clipped_ad
            self.clipped_n += clipped_ad
        if self.n_after_ad > 0:
            if lread > self.n_after_ad:
                lread -= self.n_after_ad
                self.clipped_n += self.n_after_ad
                if self.type in (0, 10):
                    off += self.n_after_ad
            else:
                lread = 0
                self.clipped_n = lread_old
        return lread, off


def make_clip_mates(P, n_mates: int) -> Optional[List[List[ClipMate]]]:
    """per-mate [5p, 3p] ClipMate list (reference initializeClipMates);
    None when no clipping is configured"""
    def vals(lst, n, fill):
        out = list(lst)
        while len(out) < n:
            out.append(out[-1] if out else fill)
        return out[:n]

    if P.clipAdapterType[0] not in ("Hamming", "CellRanger4", "None"):
        raise SystemExit(
            "EXITING because of fatal PARAMETER error: --clipAdapterType = "
            + P.clipAdapterType[0] + " is not a valid option\nSOLUTION: use "
            "valid --clipAdapterType options: Hamming OR CellRanger4")
    cr4 = P.clipAdapterType[0] == "CellRanger4"
    none = P.clipAdapterType[0] == "None"
    if not cr4 and any(a != "-" for a in P.clip5pAdapterSeq):
        raise SystemExit(
            "EXITING because of fatal PARAMETER error: --clip5pAdapterSeq is "
            "not supported yet, except for --clipAdapterType CellRanger4.\n"
            "SOLUTION: Do not use --clip5pAdapter* options without "
            "--clipAdapterType CellRanger4.")
    n5 = vals([int(x) for x in P.clip5pNbases], n_mates, 0)
    n3 = vals([int(x) for x in P.clip3pNbases], n_mates, 0)
    a5 = vals(list(P.clip5pAdapterSeq), n_mates, "-")
    a3 = vals(list(P.clip3pAdapterSeq), n_mates, "-")
    m5 = vals([float(x) for x in P.clip5pAdapterMMp], n_mates, 0.1)
    m3 = vals([float(x) for x in P.clip3pAdapterMMp], n_mates, 0.1)
    f5 = vals([int(x) for x in P.clip5pAfterAdapterNbases], n_mates, 0)
    f3 = vals([int(x) for x in P.clip3pAfterAdapterNbases], n_mates, 0)
    if cr4:
        # ParametersClip_initialize.cpp:22-31: fixed polyA 3p; default TSO 5p
        a3 = ["A"] * n_mates
        if a5[0] == "-":
            a5[0] = CR4_TSO
    if none or (not cr4 and all(x == 0 for x in n5 + n3 + f5 + f3)
                and all(a == "-" for a in a3)):
        return None
    mates = []
    for im in range(n_mates):
        t5, t3 = (10, 11) if cr4 else (0, 1)
        mates.append([ClipMate(t5, n5[im], a5[im] if cr4 else "-", f5[im], m5[im]),
                      ClipMate(t3, n3[im], a3[im], f3[im], m3[im])])
    return mates
