"""Window clustering: group seed hits into genomic alignment windows.

Reference behavior: source/ReadAlign_stitchPieces.cpp (window creation and
seed distribution), source/ReadAlign_createExtendWindowsWithAlign.cpp,
source/ReadAlign_assignAlignToWindow.cpp, source/sjAlignSplit.cpp.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..genome.index import GenomeIndex
from .seed import SeedResult, PC_rStart, PC_Length, PC_Dir, PC_Nrep, PC_SAstart, PC_SAend, PC_iFrag
from ..constants import MARKER_TOO_MANY_ANCHORS_PER_WINDOW

UINT_WINBIN_MAX = 0xFFFF
TOO_MANY_WINDOWS = "too_many_windows"

# WA row indices
WA_Length, WA_rStart, WA_gStart, WA_Nrep, WA_Anchor, WA_iFrag, WA_sjA = range(7)


@dataclass
class WindowSet:
    wc: List[list] = field(default_factory=list)   # [Str, Chr, gStartBin, gEndBin]
    wa: List[List[list]] = field(default_factory=list)
    wa_lrec: List[int] = field(default_factory=list)
    w_last_anchor: List[int] = field(default_factory=list)
    n_wap: List[int] = field(default_factory=list)
    map_marker: int = 0


def sj_align_split(gi: GenomeIndex, a1: int, a_length: int):
    """split an alignment inside the junction pseudo-chromosome region into
    donor+acceptor genome pieces; None if it does not cross the junction."""
    sj1 = (a1 - gi.sj_gstart) % gi.sjdb_length
    if sj1 < gi.sjdb_overhang and sj1 + a_length > gi.sjdb_overhang:
        isj = (a1 - gi.sj_gstart) // gi.sjdb_length
        a_length_d = gi.sjdb_overhang - sj1
        a_length_a = a_length - a_length_d
        a1_d = int(gi.sj_dstart[isj]) + sj1
        a1_a = int(gi.sj_astart[isj])
        return a1_d, a_length_d, a1_a, a_length_a, int(isj)
    return None


def _hit_to_plus_strand(gi: GenomeIndex, combined_pos: int, a_dir: int, a_length: int,
                        r_start: int, Lread: int):
    """convert an SA hit to (+)-strand genome coordinates and window strand.

    combined_pos < nGenome: forward-strand hit; otherwise reverse-strand.
    For reverse searches (a_dir==1) the read interval is flipped into the
    reverse-complement read frame (reference: stitchPieces.cpp:143-158)."""
    n = gi.n_genome
    if combined_pos < n:
        a_str = 0
        a1 = combined_pos
    else:
        a_str = 1
        a1 = combined_pos - n
    a_rstart = r_start
    if a_dir == 1 and a_str == 0:
        a_str = 1
        a_rstart = Lread - (a_length + r_start)
    elif a_dir == 0 and a_str == 1:
        a_rstart = Lread - (a_length + r_start)
        a1 = n - (a_length + a1)
    elif a_dir == 1 and a_str == 1:
        a_str = 0
        a1 = n - (a_length + a1)
    return a1, a_str, a_rstart


class WindowBuilder:
    def __init__(self, gi: GenomeIndex, P):
        self.gi = gi
        self.P = P
        self.win_bin_nbits = P.winBinNbits
        self.win_bin_chr_nbits = gi.chr_bin_nbits - P.winBinNbits
        self.win_bin_n = gi.n_genome // (1 << P.winBinNbits) + 1

    def build(self, seeds: SeedResult, Lread: int) -> WindowSet:
        gi, P = self.gi, self.P
        ws = WindowSet()
        win_bin = np.full((2, self.win_bin_n), UINT_WINBIN_MAX, dtype=np.uint32)

        # pass 1: create windows from anchor pieces
        for pc in seeds.pc:
            if pc[PC_Nrep] > P.winAnchorMultimapNmax:
                continue
            a_dir, a_length = pc[PC_Dir], pc[PC_Length]
            stop = False
            for row in range(pc[PC_SAstart], pc[PC_SAend] + 1):
                a1, a_str, _ = _hit_to_plus_strand(
                    gi, int(gi.sa[row]), a_dir, a_length, pc[PC_rStart], Lread)
                if a1 >= gi.sj_gstart:
                    split = sj_align_split(gi, a1, a_length)
                    if split is None:
                        continue
                    a1_d, _, a1_a, _, _ = split
                    for a in (a1_d, a1_a):
                        if self._create_extend_window(ws, win_bin, a, a_str):
                            stop = True
                            break
                    if stop:
                        break
                else:
                    if self._create_extend_window(ws, win_bin, a1, a_str):
                        break

        # extend windows with flanks
        for i_win, wc in enumerate(ws.wc):
            if wc[2] <= wc[3]:
                wb = wc[2]
                for _ in range(P.winFlankNbins):
                    if wb == 0 or gi.chr_bin[(wb - 1) >> self.win_bin_chr_nbits] != wc[1]:
                        break
                    wb -= 1
                    win_bin[wc[0]][wb] = i_win
                wc[2] = wb
                wb = wc[3]
                for _ in range(P.winFlankNbins):
                    if wb + 1 >= self.win_bin_n or gi.chr_bin[(wb + 1) >> self.win_bin_chr_nbits] != wc[1]:
                        break
                    wb += 1
                    win_bin[wc[0]][wb] = i_win
                wc[3] = wb
            ws.wa.append([])
            ws.wa_lrec.append(0)
            # (uint)-1 sentinel: in the reference this comparison is unsigned,
            # so the last-anchor marking never actually fires; replicate that.
            ws.w_last_anchor.append((1 << 64) - 1)

        # pass 2: route all hits of all pieces into windows
        for pc in seeds.pc:
            a_nrep, a_frag = pc[PC_Nrep], pc[PC_iFrag]
            a_length, a_dir = pc[PC_Length], pc[PC_Dir]
            a_anchor = a_nrep <= P.winAnchorMultimapNmax
            ws.n_wap = [0] * len(ws.wc)
            for row in range(pc[PC_SAstart], pc[PC_SAend] + 1):
                a1, a_str, a_rstart = _hit_to_plus_strand(
                    gi, int(gi.sa[row]), a_dir, a_length, pc[PC_rStart], Lread)
                if a1 >= gi.sj_gstart:
                    split = sj_align_split(gi, a1, a_length)
                    if split is None:
                        continue
                    a1_d, ld, a1_a, la, isj = split
                    self._assign(ws, win_bin, a1_d, ld, a_str, a_nrep, a_frag,
                                 a_rstart, a_anchor, isj, Lread)
                    self._assign(ws, win_bin, a1_a, la, a_str, a_nrep, a_frag,
                                 a_rstart + ld, a_anchor, isj, Lread)
                else:
                    self._assign(ws, win_bin, a1, a_length, a_str, a_nrep, a_frag,
                                 a_rstart, a_anchor, -1, Lread)
                if ws.map_marker == MARKER_TOO_MANY_ANCHORS_PER_WINDOW:
                    return ws
        return ws

    # -- createExtendWindowsWithAlign ------------------------------------
    def _create_extend_window(self, ws: WindowSet, win_bin, a1: int, a_str: int) -> bool:
        """returns True if too-many-windows triggered"""
        gi, P = self.gi, self.P
        a_bin = a1 >> self.win_bin_nbits
        wb = win_bin[a_str]
        if wb[a_bin] != UINT_WINBIN_MAX:
            return False
        i_bin_left = i_bin_right = a_bin
        i_win = None
        i_win_right = None

        flag_left = False
        i_bin = a_bin
        if a_bin > 0:
            lo = a_bin - P.winAnchorDistNbins if a_bin > P.winAnchorDistNbins else 0
            i_bin = a_bin - 1
            while True:
                if wb[i_bin] != UINT_WINBIN_MAX:
                    flag_left = True
                    break
                if i_bin == lo or i_bin == 0:
                    break
                i_bin -= 1
            flag_left = flag_left and (
                gi.chr_bin[i_bin >> self.win_bin_chr_nbits] == gi.chr_bin[a_bin >> self.win_bin_chr_nbits])
            if flag_left:
                i_win = int(wb[i_bin])
                i_bin_left = ws.wc[i_win][2]
                wb[i_bin + 1:a_bin + 1] = i_win

        flag_right = False
        if a_bin + 1 < self.win_bin_n:
            hi = min(a_bin + P.winAnchorDistNbins + 1, self.win_bin_n)
            i_bin = a_bin + 1
            while i_bin < hi:
                if wb[i_bin] != UINT_WINBIN_MAX:
                    flag_right = True
                    break
                i_bin += 1
            flag_right = flag_right and (
                gi.chr_bin[i_bin >> self.win_bin_chr_nbits] == gi.chr_bin[a_bin >> self.win_bin_chr_nbits])
            if flag_right:
                while i_bin + 1 < self.win_bin_n and wb[i_bin] == wb[i_bin + 1]:
                    i_bin += 1
                i_bin_right = i_bin
                i_win_right = int(wb[i_bin])
                if not flag_left:
                    i_win = int(wb[i_bin])
                wb[a_bin:i_bin + 1] = i_win

        if not flag_left and not flag_right:
            i_win = len(ws.wc)
            wb[a_bin] = i_win
            chrom = int(gi.chr_bin[a_bin >> self.win_bin_chr_nbits])
            ws.wc.append([a_str, chrom, a_bin, a_bin])
            if len(ws.wc) >= self.P.alignWindowsPerReadNmax:
                del ws.wc[self.P.alignWindowsPerReadNmax - 1:]
                return True
        else:
            ws.wc[i_win][2] = i_bin_left
            ws.wc[i_win][3] = i_bin_right
            if flag_left and flag_right and i_win_right != i_win:
                ws.wc[i_win_right][2] = 1
                ws.wc[i_win_right][3] = 0
        return False

    # -- assignAlignToWindow ---------------------------------------------
    def _assign(self, ws: WindowSet, win_bin, a1: int, a_length: int, a_str: int,
                a_nrep: int, a_frag: int, a_rstart: int, a_anchor: bool,
                sj_a: int, Lread: int):
        P = self.P
        iw = int(win_bin[a_str][a1 >> self.win_bin_nbits])
        if iw == UINT_WINBIN_MAX:
            return
        if (not a_anchor) and a_length < ws.wa_lrec[iw]:
            return
        wa = ws.wa[iw]
        # overlap check: same diagonal, same frag and sjA, r-overlap
        for ia, row in enumerate(wa):
            if (a_frag == row[WA_iFrag] and row[WA_sjA] == sj_a
                    and a1 + row[WA_rStart] == row[WA_gStart] + a_rstart
                    and ((row[WA_rStart] <= a_rstart < row[WA_rStart] + row[WA_Length])
                         or (row[WA_rStart] <= a_rstart + a_length < row[WA_rStart] + row[WA_Length]))):
                if a_length > row[WA_Length]:
                    # replace: remove old, insert new at sorted position
                    ia0 = 0
                    while ia0 < len(wa):
                        if ia0 != ia and a_rstart < wa[ia0][WA_rStart]:
                            break
                        ia0 += 1
                    if ia0 > ia:
                        ia0 -= 1
                    del wa[ia]
                    wa.insert(ia0, [a_length, a_rstart, a1, a_nrep, int(a_anchor), a_frag, sj_a])
                return

        if len(wa) == P.seedPerWindowNmax:
            # evict shortest non-anchor seeds
            lrec = Lread + 1
            for row in wa:
                if row[WA_Anchor] != 1:
                    lrec = min(lrec, row[WA_Length])
            ws.wa_lrec[iw] = lrec
            if lrec == Lread + 1:
                ws.map_marker = MARKER_TOO_MANY_ANCHORS_PER_WINDOW
                return
            if (not a_anchor) and a_length < lrec:
                return
            ws.wa[iw] = [r for r in wa if r[WA_Anchor] == 1 or r[WA_Length] > lrec]
            wa = ws.wa[iw]
            if (not a_anchor) and a_length <= lrec:
                ws.n_wap[iw] = 0

        if a_anchor or a_length > ws.wa_lrec[iw]:
            ia = 0
            while ia < len(wa):
                if a_rstart < wa[ia][WA_rStart]:
                    break
                ia += 1
            wa.insert(ia, [a_length, a_rstart, a1, a_nrep, int(a_anchor), a_frag, sj_a])
            ws.n_wap[iw] += 1
            if a_anchor and ws.w_last_anchor[iw] < ia:
                ws.w_last_anchor[iw] = ia


def long_window_coverage_filter(ws: WindowSet, P):
    """STARlong window selection: drop windows whose read coverage is below
    winReadCoverageRelativeMin of the best window (or winReadCoverageBasesMin),
    then merge seeds adjacent in both read and genome space.
    Reference: ReadAlign_stitchPieces.cpp:202-257 (COMPILE_FOR_LONG_READS)."""
    cov = []
    cov_max = 0
    for wa in ws.wa:
        c = 0
        r_last = 0
        for row in wa:
            L1 = row[WA_Length]
            r1 = row[WA_rStart]
            if r1 + L1 > r_last + 1:
                if r1 > r_last:
                    c += L1
                else:
                    c += r1 + L1 - (r_last + 1)
                r_last = r1 + L1 - 1
        cov.append(c)
        cov_max = max(cov_max, c)
    for iw, wa in enumerate(ws.wa):
        if (cov[iw] < cov_max * P.winReadCoverageRelativeMin
                or cov[iw] < P.winReadCoverageBasesMin):
            ws.wa[iw] = []
        elif wa:
            # merge seeds adjacent in R- and G-space (sjA/Nrep of the first
            # piece are kept unchanged, like the reference)
            ia1 = 0
            for ia in range(1, len(wa)):
                if (wa[ia][WA_rStart] == wa[ia1][WA_rStart] + wa[ia1][WA_Length]
                        and wa[ia][WA_gStart] == wa[ia1][WA_gStart] + wa[ia1][WA_Length]
                        and wa[ia][WA_iFrag] == wa[ia1][WA_iFrag]):
                    wa[ia1][WA_Length] += wa[ia][WA_Length]
                    wa[ia1][WA_Anchor] = max(wa[ia1][WA_Anchor], wa[ia][WA_Anchor])
                else:
                    ia1 += 1
                    if ia1 != ia:
                        wa[ia1] = wa[ia]
            del wa[ia1 + 1:]
