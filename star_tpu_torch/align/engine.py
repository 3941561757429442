"""Per-read alignment pipeline orchestration (host reference path).

Reference behavior: source/ReadAlign_oneRead.cpp (read combination),
source/ReadAlign_stitchPieces.cpp (window->transcripts loop),
source/ReadAlign_multMapSelect.cpp, source/ReadAlign_mappedFilter.cpp.

The device pipeline (ops/) executes the same stages batched; this module is
the semantic reference and the long-tail fallback.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..constants import (COMPLEMENT, MARK_FRAG_SPACER_BASE,
                         MARKER_NO_GOOD_PIECES, MARKER_NO_GOOD_WINDOW,
                         MARKER_READ_TOO_SHORT,
                         MARKER_ALL_PIECES_EXCEED_seedMultimapNmax,
                         UNMAP_NO_WINDOWS, UNMAP_TOO_SHORT, UNMAP_TOO_MANY_MM,
                         UNMAP_MULTIMAP)
from ..genome.index import GenomeIndex
from .seed import search_pieces
from .stitch import WindowStitcher
from .transcript import Transcript
from .windows import WindowBuilder


@dataclass
class ReadResult:
    name: str
    seqs: List[str]          # original sequence strings per mate
    quals: List[str]
    unmap_type: int = -1     # -1 = mapped
    n_tr: int = 0
    transcripts: List[Transcript] = field(default_factory=list)
    tr_best: Optional[Transcript] = None
    map_marker: int = 0
    read_length: List[int] = field(default_factory=list)
    read_length_original: List[int] = field(default_factory=list)
    clips: List[List[int]] = field(default_factory=lambda: [[0, 0], [0, 0]])
    lread: int = 0
    read_file_type: int = 2  # fastq
    all_win_tr: list = field(default_factory=list)
    wasp_type: int = -1  # vW tag class (ReadAlign.h:77); -1 = not output
    read1 = None
    read1rc = None


_COMP_LUT = None


def _comp_lut():
    global _COMP_LUT
    if _COMP_LUT is None:
        lut = np.full(256, 0, dtype=np.int8)
        for i, c in enumerate(COMPLEMENT):
            lut[i] = c
        lut[MARK_FRAG_SPACER_BASE] = MARK_FRAG_SPACER_BASE
        _COMP_LUT = lut
    return _COMP_LUT


class ReadAligner:
    """Aligns one read (or read pair) against a GenomeIndex."""

    def __init__(self, gi: GenomeIndex, P):
        self.gi = gi
        self.P = P
        self.var = getattr(gi, "var", None)
        self.wasp_mode = False
        self.wb = WindowBuilder(gi, P)
        self.readLength = [0, 0]
        self.maxScoreMate = [0, 0]
        self.outFilterMismatchNmaxTotal = 0
        self.sj_novel = None  # (starts, ends) for BySJout stage 2

    def sj_novel_contains(self, jS, jE):
        if self.sj_novel is None:
            return False
        starts, ends = self.sj_novel
        i = np.searchsorted(starts, jS, side="left")
        while i < len(starts) and starts[i] == jS:
            if ends[i] == jE:
                return True
            i += 1
        return False

    # ------------------------------------------------------------- one read
    def _clip_mates(self, n_mates: int):
        """the per-mate [5p, 3p] ClipMates, made on first use (None when no
        clipping is configured)"""
        if not hasattr(self, "clip_mates"):
            from .clip import make_clip_mates
            self.clip_mates = make_clip_mates(self.P, n_mates)
        return self.clip_mates

    def clip_batch(self, batch_seqs) -> None:
        """give each mate's 5p ClipMate a batch's reads at once
        (ClipMate.clip_batch), before prepare_read takes them one by one"""
        cm = self._clip_mates(len(batch_seqs[0])) if batch_seqs else None
        for im, (c5, _) in enumerate(cm or ()):
            c5.clip_batch([s[im] for s in batch_seqs])

    def prepare_read(self, name: str, seqs: List[str], quals: List[str]):
        """encode/combine mates -> (res, (read1, complement, revcomp))"""
        from ..constants import encode_seq
        res = ReadResult(name=name, seqs=seqs, quals=quals)
        n_mates = len(seqs)
        mates = [encode_seq(s) for s in seqs]
        res.read_length_original = [len(m) for m in mates] + [0] * (2 - n_mates)
        res.clips = [[0, 0], [0, 0]]
        if self._clip_mates(n_mates) is not None:
            # clip before alignment (reference readLoad.cpp:60-61); output
            # keeps the original sequence with soft clips added in CIGAR
            for im in range(n_mates):
                m = mates[im]
                lread, off5 = self.clip_mates[im][0].clip(m, len(m))
                lread, _ = self.clip_mates[im][1].clip(m[off5:], lread)
                c5 = self.clip_mates[im][0].clipped_n
                c3 = self.clip_mates[im][1].clipped_n
                res.clips[im] = [c5, c3]
                mates[im] = m[c5:len(m) - c3]
        res.read_length = [len(m) for m in mates] + [0] * (2 - n_mates)

        if n_mates == 2:
            lread = len(mates[0]) + len(mates[1]) + 1
            read1 = np.empty(lread, dtype=np.int8)
            read1[:len(mates[0])] = mates[0]
            read1[len(mates[0])] = MARK_FRAG_SPACER_BASE
            m2 = mates[1]
            comp2 = _comp_lut()[m2]
            read1[len(mates[0]) + 1:] = comp2[::-1]
        else:
            lread = len(mates[0])
            read1 = mates[0].astype(np.int8)
        res.lread = lread

        read1c = _comp_lut()[read1]
        read1rc = read1c[::-1].copy()
        return res, (read1, read1c, read1rc)

    def align_read(self, name: str, seqs: List[str], quals: List[str]) -> ReadResult:
        res, reads = self.prepare_read(name, seqs, quals)
        seeds = search_pieces(self.gi, self.P, reads[0], res.lread)
        return self.finish_read(res, reads, seeds)

    def finish_read(self, res: ReadResult, reads, seeds,
                    precomputed=None) -> ReadResult:
        """windows + stitch + filters, given the seed table.

        precomputed: optional (all_win_tr, maxScoreMate) from the batched
        engine (ops/batch_engine.py) — replaces the per-read window build +
        stitch recursion with the already-assembled window transcript lists."""
        P, gi = self.P, self.gi
        read1 = reads[0]
        lread = res.lread
        self.readLength = list(res.read_length)
        self.maxScoreMate = [0, 0]
        self.outFilterMismatchNmaxTotal = min(
            P.outFilterMismatchNmax,
            int(P.outFilterMismatchNoverReadLmax * (self.readLength[0] + self.readLength[1])))

        tr_init = Transcript()
        tr_init.Lread = lread
        res.tr_best = tr_init

        if lread < P.outFilterMatchNmin:
            res.map_marker = MARKER_READ_TOO_SHORT
            self._finish_unmapped(res)
            return res
        if seeds.n_split == 0:
            res.map_marker = MARKER_NO_GOOD_PIECES
            self._finish_unmapped(res)
            return res
        if seeds.nA == 0:
            res.map_marker = MARKER_ALL_PIECES_EXCEED_seedMultimapNmax
            self._finish_unmapped(res)
            return res

        if precomputed is not None:
            all_win_tr, msm = precomputed
            self.maxScoreMate = list(msm)
            tr_best = tr_init
            for win_tr in all_win_tr:
                if (win_tr[0].maxScore > tr_best.maxScore
                        or (win_tr[0].maxScore == tr_best.maxScore
                            and win_tr[0].gLength < tr_best.gLength)):
                    tr_best = win_tr[0]
        else:
            # ---- windows
            ws = self.wb.build(seeds, lread)
            if ws.map_marker:
                res.map_marker = ws.map_marker
                self._finish_unmapped(res)
                return res

            if P.longReads:
                # STARlong: coverage-based window selection + adjacent-seed
                # merge (reference stitchPieces.cpp:202-257)
                from .windows import long_window_coverage_filter
                long_window_coverage_filter(ws, P)

            # ---- stitch: transcripts per window
            stitcher = WindowStitcher(gi, P, self)
            reads_b = (bytes(reads[0]), bytes(reads[2]))
            all_win_tr = []
            tr_best = tr_init
            n_total = 0
            for iw, wc in enumerate(ws.wc):
                if not ws.wa[iw]:
                    continue
                tr0 = Transcript()
                tr0.Lread = lread
                tr0.Chr = wc[1]
                tr0.Str = wc[0]
                tr0.roStr = tr0.Str
                if n_total + P.alignTranscriptsPerWindowNmax >= P.alignTranscriptsPerReadNmax:
                    break
                if P.longReads:
                    # seed-chain DP: one transcript per window (STARlong)
                    win_tr = stitcher.stitch_window_seeds(
                        ws.wa[iw], ws.w_last_anchor[iw], tr0, lread,
                        reads_b[0] if tr0.roStr == 0 else reads_b[1])
                else:
                    win_tr = stitcher.stitch_window(
                        ws.wa[iw], ws.w_last_anchor[iw], tr0, lread,
                        reads_b[0] if tr0.roStr == 0 else reads_b[1])
                if not win_tr:
                    continue
                if (win_tr[0].maxScore > tr_best.maxScore
                        or (win_tr[0].maxScore == tr_best.maxScore
                            and win_tr[0].gLength < tr_best.gLength)):
                    tr_best = win_tr[0]
                n_total += len(win_tr)
                all_win_tr.append(win_tr)

        if tr_best.maxScore == 0:
            res.map_marker = MARKER_NO_GOOD_WINDOW
            self._finish_unmapped(res)
            return res

        res.tr_best = tr_best
        res.all_win_tr = all_win_tr
        res.read1 = reads[0]
        res.read1rc = reads[2]

        # ---- PE mate-overlap merge-remap (reference peOverlapMergeMap);
        # the WASP remap runs mapOneRead/multMapSelect/mappedFilter only
        if P.peOverlapNbasesMin > 0 and len(res.seqs) == 2 and not self.wasp_mode:
            self._pe_overlap_merge_map(res, reads)
            all_win_tr = res.all_win_tr
            tr_best = res.tr_best

        # ---- multimapper selection (reference multMapSelect)
        max_score = max(w[0].maxScore for w in all_win_tr)
        tr_mult: List[Transcript] = []
        for win_tr in all_win_tr:
            for tr in win_tr:
                if tr.maxScore + P.outFilterMultimapScoreRange >= max_score:
                    tr.Chr = win_tr[0].Chr
                    tr.Str = win_tr[0].Str
                    tr.roStr = win_tr[0].roStr
                    tr_mult.append(tr)
        res.n_tr = len(tr_mult)
        res.transcripts = tr_mult

        if not (res.n_tr > P.outFilterMultimapNmax or res.n_tr == 0):
            for tr in tr_mult:
                tr.roStart = tr.rStart if tr.roStr == 0 else lread - tr.rStart - tr.rLength
                tr.cStart = tr.gStart - gi.chr_start[tr.Chr]
            if res.n_tr == 1:
                tr_mult[0].primaryFlag = True
            else:
                if P.outMultimapperOrderRandom or P.outSAMmultNmax != -1:
                    nbest = 0
                    for i in range(len(tr_mult)):
                        if tr_mult[i].maxScore == max_score:
                            tr_mult[i], tr_mult[nbest] = tr_mult[nbest], tr_mult[i]
                            nbest += 1
                    tr_mult[0].primaryFlag = True
                elif P.outSAMprimaryFlag == "AllBestScore":
                    for tr in tr_mult:
                        if tr.maxScore == max_score:
                            tr.primaryFlag = True
                else:
                    tr_best.primaryFlag = True

        # ---- mapped filter (reference mappedFilter)
        tb = tr_best
        if (tb.maxScore < P.outFilterScoreMin
                or tb.maxScore < int(P.outFilterScoreMinOverLread * (lread - 1))
                or tb.nMatch < P.outFilterMatchNmin
                or tb.nMatch < int(P.outFilterMatchNminOverLread * (lread - 1))):
            res.unmap_type = UNMAP_TOO_SHORT
        elif (tb.nMM > self.outFilterMismatchNmaxTotal
              or (tb.rLength > 0 and tb.nMM / tb.rLength > P.outFilterMismatchNoverLmax)):
            res.unmap_type = UNMAP_TOO_MANY_MM
        elif res.n_tr > P.outFilterMultimapNmax:
            res.unmap_type = UNMAP_MULTIMAP
        else:
            res.unmap_type = -1

        # ---- WASP allele-swap remap filter (reference waspMap, run after
        # chimericDetection in oneRead; vW classes)
        if (getattr(P, "waspYes", False) and not self.wasp_mode
                and self.var is not None):
            from .variation import wasp_map
            res.wasp_type = wasp_map(self, res, reads)
        return res

    def _pe_overlap_merge_map(self, res: ReadResult, reads):
        """merge overlapping mates, remap as SE, convert windows back to PE
        (reference ReadAlign_peOverlapMergeMap.cpp)"""
        from ..constants import NUM_TO_NT, COMPLEMENT, MARK_FRAG_SPACER_BASE
        from .peoverlap import pe_merge_mates, se_to_pe, align_score
        from .seed import search_pieces
        P, gi = self.P, self.gi
        res.pe_ov_yes = False
        len0, len1 = res.read_length[0], res.read_length[1]
        n_ov, mate_start, merged = pe_merge_mates(
            reads[0], len0, len1, P.peOverlapNbasesMin, P.peOverlapMMp)
        if n_ov == 0:
            return
        if not hasattr(self, "_pe_merge_aligner"):
            self._pe_merge_aligner = ReadAligner(gi, P)
            self._pe_merge_aligner.clip_mates = None
        se = self._pe_merge_aligner
        lm = len(merged)
        se_res = ReadResult(name=res.name,
                            seqs=["".join(NUM_TO_NT[b] for b in merged)],
                            quals=["I" * lm])
        se_res.read_length = [lm, 0]
        se_res.read_length_original = [lm, 0]
        se_res.lread = lm
        comp_lut = np.full(256, 0, dtype=np.int8)
        for i, c in enumerate(COMPLEMENT):
            comp_lut[i] = c
        comp_lut[MARK_FRAG_SPACER_BASE] = MARK_FRAG_SPACER_BASE
        mc = comp_lut[merged]
        se_reads = (merged, mc, mc[::-1].copy())
        seeds = search_pieces(gi, P, merged, lm)
        se.finish_read(se_res, se_reads, seeds)
        # restore this aligner's per-read state clobbered by the SE pass
        self.readLength = list(res.read_length)
        self.outFilterMismatchNmaxTotal = min(
            P.outFilterMismatchNmax,
            int(P.outFilterMismatchNoverReadLmax * (self.readLength[0] + self.readLength[1])))
        if not se_res.all_win_tr:
            return  # no windows for the merged read (peMergeRA->nW==0)
        pe_score = res.tr_best.maxScore
        new_wins = []
        best = None
        for win in se_res.all_win_tr:
            conv = []
            for t in win:
                t.Lread = lm
                nt = se_to_pe(t, mate_start, res.read_length, res.lread)
                if nt is None or nt.nExons == 0:
                    continue
                align_score(nt, reads[0], reads[2], gi.G, P)
                if conv and nt.maxScore > conv[0].maxScore:
                    conv.append(conv[0])
                    conv[0] = nt
                else:
                    conv.append(nt)
            if conv:
                new_wins.append(conv)
                if best is None or conv[0].maxScore > best.maxScore:
                    best = conv[0]
        if best is None:
            return
        res.all_win_tr = new_wins
        res.tr_best = best
        if pe_score <= best.maxScore:
            res.pe_ov_yes = True

    def _finish_unmapped(self, res: ReadResult):
        # no-window reads always classify as unmapped-other (reference
        # mappedFilter: nW==0 -> unmapType=0 regardless of the map marker)
        res.unmap_type = UNMAP_NO_WINDOWS
        res.n_tr = 0
