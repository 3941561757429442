"""STARsolo orchestrator: barcode matching + multi-feature counting.

Reference behavior: source/SoloReadBarcode_getCBandUMI.cpp (CB extraction,
whitelist exact/1MM matching, UMI checks), source/Solo.cpp (feature loop,
Barcodes.stats, pseudocounts), source/ParametersSolo.cpp (readInfo/readIndex
wiring), source/SoloFeature_processRecords.cpp (per-feature driver).

This is the host implementation; the counting kernels (WL binary search, UMI
collapse via segmented sort) are batched on device in later rounds.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .annotate import (FEATURE_NAMES, FEATURE_DIRNAMES, FT_GENE, FT_GENEFULL,
                       FT_GENEFULL_EXONOVERINTRON, FT_GENEFULL_EX50PAS, FT_SJ,
                       FT_TRANSCRIPT3P, FT_VELOCYTO, ReadAnnot,
                       align_exon_overlap, classify_align,
                       gene_full_exon_over_intron, gene_full_overlap)
from .collapse import DedupConf
from .feature import (GENEISH, SoloFeatureProc, SoloReadFeature, FEAT_STATS,
                      FLAG_NAMES, N_BITS, fmt_g)


def encode_bc(seq: str) -> Optional[Tuple[int, int]]:
    """(value, posN): posN=-1 no Ns, >=0 single N position, -2 multiple Ns"""
    v = 0
    pos_n = -1
    for i, c in enumerate(seq):
        v <<= 2
        if c == "A":
            pass
        elif c == "C":
            v += 1
        elif c == "G":
            v += 2
        elif c == "T":
            v += 3
        else:
            if pos_n >= 0:
                return v, -2
            pos_n = i
    return v, pos_n


def nt_str(v: int, L: int) -> str:
    """convertNuclInt64toString (SequenceFuns.cpp)"""
    return "".join("ACGT"[(v >> (2 * (L - 1 - i))) & 3] for i in range(L))


def local_align_hamming(text: str, query: str) -> Tuple[int, int]:
    """(bestDist, pos) sliding Hamming distance; N in query is a free match
    (reference SequenceFuns.cpp:341 localAlignHammingDist)."""
    if len(text) < len(query):
        return len(text) + 1, 0
    best, pos = len(query), 0
    for ii in range(len(text) - len(query) + 1):
        d = sum(1 for jj in range(len(query))
                if query[jj] != "N" and text[ii + jj] != query[jj])
        if d < best:
            best, pos = d, ii
    return best, pos


def _wl_find(wl: np.ndarray, v: int) -> int:
    i = int(np.searchsorted(wl, np.uint64(v)))
    if i < len(wl) and wl[i] == np.uint64(v):
        return i
    return -1


def match_cb_to_wl(cb_seq: str, cb_qual: str, wl: np.ndarray,
                   mm1: bool, mm1_multi: bool, mm1_nbase: bool):
    """whitelist exact/1MM matching against a sorted 2-bit WL array
    (reference SoloReadBarcode_getCBandUMI.cpp:9-91 matchCBtoWL);
    returns (cbMatch, matches[(wl_index, qual_char)])."""
    v, pos_n = encode_bc(cb_seq)
    if pos_n == -2:
        return -2, []
    if pos_n == -1:
        i = _wl_find(wl, v)
        if i >= 0:
            return 0, [(i, "")]
    if not mm1:
        return -1, []
    matches = []
    if pos_n >= 0:
        shift = 2 * (len(cb_seq) - 1 - pos_n)
        for jj in range(4):
            i = _wl_find(wl, v ^ (jj << shift))
            if i >= 0:
                if matches and not mm1_nbase:
                    return -3, []
                matches.append((i, cb_qual[pos_n]))
    else:
        for ii in range(len(cb_seq)):
            for jj in range(1, 4):
                i = _wl_find(wl, v ^ (jj << (ii * 2)))
                if i >= 0:
                    matches.append((i, cb_qual[len(cb_seq) - 1 - ii]))
    if not matches:
        return -1, []
    if len(matches) == 1:
        return 1, matches
    if not mm1_multi:
        return -3, []
    return len(matches), matches


class SoloBarcodes:
    """whitelist matching (reference SoloReadBarcode_getCBandUMI.cpp)"""

    def __init__(self, P):
        self.P = P
        self.cb_s = P.soloCBstart[0] - 1
        self.cb_l = P.soloCBlen[0]
        self.umi_s = P.soloUMIstart[0] - 1
        self.umi_l = P.soloUMIlen[0]
        self.wl_yes = P.soloCBwhitelist[0] not in ("-", "None")
        mm = P.soloCBmatchWLtype
        self.mm1 = mm.startswith("1MM")
        self.mm1_multi = "multi" in mm
        self.mm1_multi_pc = "pseudocounts" in mm
        self.mm1_nbase = "Nbase" in mm
        self.one_exact = mm in ("Exact", "1MM", "1MM_multi")
        if self.wl_yes:
            strs = []
            with open(P.soloCBwhitelist[0]) as f:
                for line in f:
                    s = line.strip()
                    if s:
                        strs.append(s)
            vals = np.array([encode_bc(s)[0] for s in strs], dtype=np.uint64)
            order = np.argsort(vals, kind="stable")
            self.wl = vals[order]
            self.wl_str = [strs[i] for i in order]
        else:
            self.wl = np.zeros(0, dtype=np.uint64)
            self.wl_str = []
        self.homopolymers = set()
        for b in range(4):
            v = 0
            for _ in range(self.umi_l):
                v = (v << 2) + b
            self.homopolymers.add(v)
        self.cb_read_count_exact = np.zeros(len(self.wl), dtype=np.int64)
        self.wl_size = len(self.wl)
        self.qual_whole = False  # qualHist basis: CB+UMI quals (simple type)

    def match(self, cb_seq: str, cb_qual: str):
        """returns (cbMatch, matchList); matchList entries are (wl_index, qual)"""
        if not self.wl_yes:
            v, pos_n = encode_bc(cb_seq)
            if pos_n != -1:
                return -2, []
            return 0, [(v, "")]
        return match_cb_to_wl(cb_seq, cb_qual, self.wl,
                              self.mm1, self.mm1_multi, self.mm1_nbase)

    def get_cb_umi(self, b_seq: str, b_qual: str, skip_umi: bool = False):
        """-> (cbMatch, matches, umi, (cbSeq, cbQual, umiSeq, umiQual)).
        skip_umi: CB_samTagOut extracts but never validates the UMI
        (reference getCBandUMI.cpp:311-328)."""
        cb_seq = b_seq[self.cb_s:self.cb_s + self.cb_l]
        umi_seq = b_seq[self.umi_s:self.umi_s + self.umi_l]
        cb_qual = b_qual[self.cb_s:self.cb_s + self.cb_l]
        umi_qual = b_qual[self.umi_s:self.umi_s + self.umi_l]
        parts = (cb_seq, cb_qual, umi_seq, umi_qual)
        cb_match, matches = self.match(cb_seq, cb_qual)
        if skip_umi:
            return cb_match, matches, 0, parts
        umi_v, umi_pos_n = encode_bc(umi_seq)
        if umi_pos_n != -1:
            return -23, [], 0, parts
        if umi_v in self.homopolymers:
            return -24, [], 0, parts
        if cb_match == 0:
            self.cb_read_count_exact[matches[0][0]] += 1
        return cb_match, matches, umi_v, parts


def _wl_add_mismatches(n_mm: int, cb_len: int, wl: np.ndarray):
    """enumerate all <=n_mm-edit variants of each WL barcode, keep only
    unambiguous ones (reference SoloBarcode.cpp wlAddMismatches); returns
    (wlEd sorted np.uint64, wlEdInd np.uint32). ins+del variants are added
    at the mm=2 level only, as edit-distance-2 combinations."""
    recs = [(int(wl[i]), i, 0) for i in range(len(wl))]  # (cb, ind, mm)
    mask_cb = (1 << (2 * cb_len)) - 1
    ind1, ind2 = 0, len(recs)
    for mm in range(1, n_mm + 1):
        for ii in range(ind1, ind2):
            cb0, ind0, _ = recs[ii]
            for ll in range(0, cb_len * 2, 2):
                for jj in range(1, 4):
                    recs.append((cb0 ^ (jj << ll), ind0, mm))
        if mm == 2:  # ins+del only added at mm=ed=2, to original barcodes
            for ii in range(len(wl)):
                cbmm = recs[ii][0]
                for ld in range(0, cb_len * 2, 2):
                    maskd = (1 << ld) - 1
                    cbmmd = (cbmm & maskd) | ((cbmm >> (ld + 2)) << ld)
                    for ll in range(0, cb_len * 2, 2):
                        cbmm1 = cbmmd << 2
                        mask = (1 << ll) - 1
                        cbmm2 = ((cbmmd & mask)
                                 | (cbmm1 & (((1 << 64) - 1) << (ll + 2))))
                        cbmm2 &= mask_cb  # uintCB stays < 4^cbLen (see text)
                        for jj in range(4):
                            recs.append((cbmm2 | (jj << ll), recs[ii][1], 2))
        ind1, ind2 = ind2, len(recs)
    recs.sort(key=lambda r: (r[0], r[2], r[1]))  # (cb, mm, ind)
    keep = []
    prev_cb = None
    for ii, (cb, ind, mm) in enumerate(recs):
        nxt = recs[ii + 1] if ii + 1 < len(recs) else None
        if nxt is not None and (cb, ind, mm) == (nxt[0], nxt[1], nxt[2]):
            continue  # identical records collapse (prevCB not updated)
        if (cb == prev_cb
                or (nxt is not None and cb == nxt[0] and mm == nxt[2])):
            pass  # ambiguous: matches >1 original at the same edit level
        else:
            keep.append((cb, ind))
        prev_cb = cb
    return (np.array([k[0] for k in keep], dtype=np.uint64),
            np.array([k[1] for k in keep], dtype=np.uint32))


class ComplexBarcodeSegment:
    """one CB (or the UMI) of a complex barcode: anchored position + multi-
    length whitelist (reference SoloBarcode.{h,cpp})."""

    def __init__(self, position_str: str, adapter_length: int):
        p = position_str.split("_")
        self.anchor_type = (int(p[0]), int(p[2]))
        self.anchor_dist = (int(p[1]), int(p[3]))
        self.adapter_length = adapter_length
        self.wl: List[np.ndarray] = []   # per length, sorted unique uint64
        self.wl_ed: List[np.ndarray] = []
        self.wl_ed_ind: List[np.ndarray] = []
        self.wl_add: List[int] = []
        self.min_len = 0
        self.total_size = 0
        self.wl_factor = 1

    def load_whitelist(self, path: str, edit_dist_2: bool, log) -> None:
        by_len: Dict[int, List[int]] = {}
        max_len = 0
        with open(path) as f:
            for tok in f.read().split():
                v, pos_n = encode_bc(tok)
                if pos_n != -1:
                    log.append("WARNING: CB whitelist sequence contains "
                               "non-ACGT base and is ignored: " + tok)
                    continue
                by_len.setdefault(len(tok), []).append(v)
                max_len = max(max_len, len(tok))
        self.wl = [np.zeros(0, dtype=np.uint64)] * (max_len + 1)
        self.wl_ed = [np.zeros(0, dtype=np.uint64)] * (max_len + 1)
        self.wl_ed_ind = [np.zeros(0, dtype=np.uint32)] * (max_len + 1)
        self.wl_add = [0] * (max_len + 1)
        self.total_size = 0
        self.min_len = (1 << 32) - 1
        for ilen in range(1, max_len + 1):  # sortWhiteList
            self.wl_add[ilen] = self.total_size
            if ilen in by_len:
                self.min_len = min(self.min_len, ilen)
                self.wl[ilen] = np.unique(
                    np.array(by_len[ilen], dtype=np.uint64))
                self.total_size += len(self.wl[ilen])
                if edit_dist_2:
                    self.wl_ed[ilen], self.wl_ed_ind[ilen] = \
                        _wl_add_mismatches(2, ilen, self.wl[ilen])

    def extract(self, b_seq: str, b_qual: str, adapter_start: int):
        """(seq, qual) or None (reference SoloBarcode_extractBarcode.cpp)"""
        pos = [0, 0]
        for ii in range(2):
            a = self.anchor_type[ii]
            if a == 0:
                pos[ii] = 0
            elif a == 1:
                pos[ii] = len(b_seq) - 1
            elif a == 2:
                pos[ii] = adapter_start
            elif a == 3:
                pos[ii] = adapter_start + self.adapter_length - 1
            pos[ii] += self.anchor_dist[ii]
        if pos[0] < 0 or pos[1] > len(b_seq) or pos[0] > pos[1]:
            return None
        return b_seq[pos[0]:pos[1] + 1], b_qual[pos[0]:pos[1] + 1]


class SoloBarcodesComplex:
    """CB_UMI_Complex: anchored multi-segment barcodes with per-length
    whitelists and optional adapter (reference ParametersSolo.cpp:349-396,
    SoloReadBarcode_getCBandUMI.cpp:331-426). Exposes the same interface as
    SoloBarcodes; cbMatchInd is the single global WL-product index."""

    def __init__(self, P):
        self.P = P
        mm = P.soloCBmatchWLtype
        if mm not in ("Exact", "1MM", "EditDist_2"):
            raise SystemExit(
                "EXITING because of fatal PARAMETERS error: "
                f"--soloCBmatchWLtype {mm} does not work with --soloType "
                "CB_UMI_Complex\nSOLUTION: use allowed option: use "
                "--soloCBmatchWLtype Exact (exact matches only) OR 1MM "
                "(one match with 1 mismatched base)")
        self.mm1 = mm == "1MM"
        self.edit_dist_2 = mm == "EditDist_2"
        self.one_exact = mm in ("Exact", "1MM")
        self.mm1_multi = False
        self.mm1_multi_pc = False
        self.mm1_nbase = False
        self.wl_yes = True
        self.qual_whole = True  # qualHist covers the whole barcode read
        self.adapter_seq = P.soloAdapterSequence
        self.adapter_yes = self.adapter_seq != "-"
        self.adapter_mm_max = P.soloAdapterMismatchesNmax
        if len(P.soloCBposition) != len(P.soloCBwhitelist) \
                or P.soloCBposition[0] == "-":
            raise SystemExit(
                "EXITING because of fatal PARAMETER error: number of "
                f"barcodes in --soloCBposition : {len(P.soloCBposition)} is "
                "not equal to the number of WhiteLists in --soloCBwhitelist "
                f": {len(P.soloCBwhitelist)}\nSOLUTION: make sure that the "
                "number of CB whitelists and CB positions are the same")
        adapter_len = len(self.adapter_seq)
        self.log: List[str] = []
        self.cbv = [ComplexBarcodeSegment(s, adapter_len)
                    for s in P.soloCBposition]
        self.umi_v = ComplexBarcodeSegment(P.soloUMIposition, adapter_len)
        self.wl_size = 1
        for icb, cb in enumerate(self.cbv):
            cb.load_whitelist(P.soloCBwhitelist[icb], self.edit_dist_2,
                              self.log)
            cb.wl_factor = self.wl_size
            self.wl_size *= cb.total_size
        self.wl_str = self._complex_wl_strings()
        self.umi_l = 0  # defined by the first read (getCBandUMI:353-354)
        # homoPolymer values are precomputed per thread while umiL is still 0
        # (SoloReadBarcode.cpp:16-21) => only the all-A UMI (==0) is caught
        self.homopolymers = {0}
        self.cb_read_count_exact = np.zeros(self.wl_size, dtype=np.int64)

    def _complex_wl_strings(self) -> List[str]:
        """ParametersSolo::complexWLstrings — enumerate the WL product in
        global-index order (cbV[0] fastest; lengths ascending)."""
        strs = []
        n = len(self.cbv)
        i_cb = [0] * n
        i_len = [cb.min_len for cb in self.cbv]
        for _ in range(self.wl_size):
            for i in range(n):
                cb = self.cbv[i]
                if i_cb[i] == len(cb.wl[i_len[i]]):
                    i_len[i] += 1
                    i_cb[i] = 0
                if i_len[i] == len(cb.wl):
                    if i + 1 < n:
                        i_cb[i + 1] += 1
                    i_len[i] = cb.min_len
            strs.append("_".join(
                nt_str(int(cb.wl[i_len[i]][i_cb[i]]), i_len[i])
                for i, cb in enumerate(self.cbv)))
            i_cb[0] += 1
        return strs

    def get_cb_umi(self, b_seq: str, b_qual: str):
        """-> (cbMatch, matches, umi, (cbSeq, cbQual, umiSeq, umiQual))"""
        adapter_start = 0
        if self.adapter_yes:
            dist, adapter_start = local_align_hamming(b_seq, self.adapter_seq)
            if dist > self.adapter_mm_max:
                return -21, [], 0, ("", "", "", "")

        umi = self.umi_v.extract(b_seq, b_qual, adapter_start)
        if umi is None:
            return -22, [], 0, ("", "", "", "")
        umi_seq, umi_qual = umi
        if self.umi_l == 0:
            self.umi_l = len(umi_seq)

        cb_match = -1
        umi_v, umi_pos_n = encode_bc(umi_seq)
        cb_match_good = True
        if umi_pos_n != -1:
            cb_match_good = False
            cb_match = -23
        elif umi_v in self.homopolymers:
            cb_match_good = False
            cb_match = -24

        g_ind = 0
        cb_seq, cb_qual = "", ""
        for cb in self.cbv:
            ext = cb.extract(b_seq, b_qual, adapter_start)
            cb_seq1, cb_qual1 = ext if ext is not None else ("", "")
            if (ext is None or len(cb_seq1) < cb.min_len
                    or len(cb_seq1) >= len(cb.wl)
                    or len(cb.wl[len(cb_seq1)]) == 0):
                if cb_match_good:
                    cb_match = -11
                    cb_match_good = False
            cb_seq += cb_seq1 + "_"
            cb_qual += cb_qual1 + "_"
            if not cb_match_good:
                continue
            cb_len1 = len(cb_seq1)
            if self.edit_dist_2:
                cb_match = 0
                v, pos_n = encode_bc(cb_seq1)
                if pos_n != -1:
                    cb_match = -2
                    cb_match_good = False
                else:
                    i = _wl_find(cb.wl[cb_len1], v)
                    if i >= 0:
                        g_ind += cb.wl_factor * (i + cb.wl_add[cb_len1])
                    else:
                        i = _wl_find(cb.wl_ed[cb_len1], v)
                        if i >= 0:
                            cb_match = 1
                            i = int(cb.wl_ed_ind[cb_len1][i])
                            g_ind += cb.wl_factor * (i + cb.wl_add[cb_len1])
                        else:
                            cb_match = -1
                            cb_match_good = False
            else:  # Exact or 1MM
                cb_match1, matches1 = match_cb_to_wl(
                    cb_seq1, cb_qual1, cb.wl[cb_len1],
                    self.mm1, False, False)
                if cb_match1 < 0:
                    cb_match_good = False
                    cb_match = cb_match1
                elif cb_match1 > 0 and cb_match > 0:
                    cb_match_good = False
                    cb_match = -12  # mismatches in multiple barcodes
                else:
                    g_ind += cb.wl_factor * (matches1[0][0]
                                             + cb.wl_add[cb_len1])
                    cb_match = max(cb_match, cb_match1)
        cb_seq = cb_seq[:-1]
        cb_qual = cb_qual[:-1]

        parts = (cb_seq, cb_qual, umi_seq, umi_qual)
        if not cb_match_good:
            return cb_match, [], 0, parts
        if cb_match == 0:
            self.cb_read_count_exact[g_ind] += 1
        return cb_match, [(g_ind, "")], umi_v, parts


def solo_cell_filtering(P):
    """--runMode soloCellFiltering <rawDir> <outPrefix>: re-filter a raw
    matrix without remapping (reference Solo.cpp:23-44 +
    SoloFeature_loadRawMatrix.cpp)."""
    import shutil
    from .feature import SoloFeatureProc, c_round
    if len(P.runMode) < 3:
        raise SystemExit(
            "Exiting because of fatal PARAMETER error: --runMode "
            "soloCellFiltering should contain paths to count matrix input "
            "directorry and output prefix.\nSOLUTION: re-run with --runMode "
            "soloCellFiltering </path/to/raw/count/dir/> </path/to/output/prefix>")
    input_prefix = P.runMode[1] + "/"
    out_prefix = P.runMode[2]

    if not os.path.exists(input_prefix + "matrix.mtx"):
        raise SystemExit(
            "EXITING because of fatal input ERROR: could not open input file "
            + input_prefix + "matrix.mtx" + "\nSOLUTION: check path and "
            "permission for the matrix file " + input_prefix + "matrix.mtx")
    entries = []  # (gene0, cell0, count)
    with open(input_prefix + "matrix.mtx") as f:
        for line in f:
            if line.startswith("%"):
                continue
            features_number, n_cb1, n_tot = (int(x) for x in line.split())
            break
        for line in f:
            p = line.split()
            entries.append((int(p[0]) - 1, int(p[1]) - 1,
                            c_round(float(p[2]))))
    if not entries:
        raise SystemExit("Exiting because of fatal INPUT FILE error: no "
                         "counts detected in " + input_prefix + "matrix.mtx"
                         + "\nSOLUTION: check the formatting of the matrix file.")
    entries.sort(key=lambda e: (e[1], e[0]))  # funCompareTypeSecondFirst

    proc = SoloFeatureProc.__new__(SoloFeatureProc)
    proc.ft = -1
    proc.P = P
    proc.device = "cpu"     # no mapping job: the host runs the null
    proc.features_number = features_number
    proc.conf = DedupConf(["1MM_All"], "-", ["Unique"], 1)
    proc.trm = None
    cells = sorted({e[1] for e in entries})
    cell_idx = {c: i for i, c in enumerate(cells)}
    # reference quirk: loadRawMatrix's second counting loop leaves nCB at
    # nCells-1 (SoloFeature_loadRawMatrix.cpp:110-119), so cellFiltering
    # silently drops the highest-indexed cell; arrays keep full length
    # (nUMIperCBsorted still includes it) — replicated for byte-identity
    proc.n_cb = len(cells) - 1
    proc.ind_cb = np.array(cells, dtype=np.int64)
    proc.ind_cb_wl = np.full(n_cb1, -1, dtype=np.int64)
    proc.ind_cb_wl[proc.ind_cb] = np.arange(len(cells))
    proc.rows_per_cb = [[] for _ in range(len(cells))]
    proc.n_umi_per_cb = np.zeros(len(cells), dtype=np.int64)
    proc.n_gene_per_cb = np.zeros(len(cells), dtype=np.int64)
    for (g, c, n) in entries:
        icb = cell_idx[c]
        proc.rows_per_cb[icb].append([g, n])
        proc.n_umi_per_cb[icb] += n
        proc.n_gene_per_cb[icb] += 1

    class _BC:
        pass
    proc.bc = _BC()
    with open(input_prefix + "barcodes.tsv") as f:
        proc.bc.wl_str = [l.rstrip("\n") for l in f][:n_cb1]

    os.makedirs(os.path.dirname(out_prefix + "x") or ".", exist_ok=True)
    shutil.copyfile(input_prefix + "features.tsv", out_prefix + "features.tsv")
    proc.count_mat_stride = 2  # [gene, count] rows; only iCol=1 is written
    proc.cell_filtering(P, out_prefix, None)


BAR_STATS = ["noNoAdapter", "noNoUMI", "noNoCB", "noNinCB", "noNinUMI",
             "noUMIhomopolymer", "noNoWLmatch", "noTooManyMM",
             "noTooManyWLmatches", "yesWLmatchExact", "yesOneWLmatchWithMM",
             "yesMultWLmatchWithMM"]


class SoloBarcodesSmartSeq:
    """SmartSeq "barcodes": one well per input file, labelled by the RG IDs
    (reference ParametersSolo.cpp:344-347 cbWLstr=outSAMattrRG;
    SoloReadBarcode_getCBandUMI.cpp:152-160 cbMatch=0, ind=readFilesIndex)."""

    def __init__(self, P):
        if not P.outSAMattrRG:
            raise SystemExit(
                "EXITING because of fatal PARAMETERS error: --soloType "
                "SmartSeq requires read-group IDs for the wells\nSOLUTION: "
                "supply reads via --readFilesManifest with ID:xxx read groups "
                "(or --outSAMattrRGline)")
        self.wl_str = list(P.outSAMattrRG)
        self.wl_size = len(self.wl_str)
        self.umi_l = 0
        self.qual_whole = True
        self.one_exact = False
        self.mm1_multi_pc = False
        self.cb_read_count_exact = np.zeros(self.wl_size, dtype=np.int64)


class Solo:
    """multi-feature STARsolo driver (reference Solo + SoloFeature)"""

    def __init__(self, gi, P, trm, device="cpu"):
        """device: the job's, where EmptyDrops_CR's Monte-Carlo null runs
        (its CUDA kernel is loaded here, in the job's set-up)"""
        self.gi = gi
        self.P = P
        self.trm = trm
        self.device = torch.device(device)
        if self.device.type == "cuda" \
                and P.soloCellFilter[0] == "EmptyDrops_CR":
            from . import mc_null
            mc_null.load()
        self.smart_seq = P.soloType[0] == "SmartSeq"
        if self.smart_seq:
            bad = [t for t in P.soloUMIdedup if t not in ("NoDedup", "Exact")]
            if bad:
                raise SystemExit(
                    f"EXITING because of fatal PARAMETERS error: --soloUMIdedup "
                    f"= {bad[0]} is not allowed for --soloType SmartSeq\n"
                    "SOLUTION: use --soloUMIdedup Exact and/or NoDedup")
            if "Velocyto" in P.soloFeatures:
                raise SystemExit(
                    "EXITING because of fatal PARAMETERS error: --soloFeatures "
                    "Velocyto is presently not compatible with --soloType "
                    "SmartSeq .\nSOLUTION: remove Velocyto from --soloFeatures")
            self.bc = SoloBarcodesSmartSeq(P)
        elif P.soloType[0] == "CB_UMI_Complex":
            self.bc = SoloBarcodesComplex(P)
        else:
            self.bc = SoloBarcodes(P)
        self.features = [FEATURE_NAMES[f] for f in P.soloFeatures]
        # umiMaskLow is fixed from --soloUMIlen BEFORE the CB_UMI_Complex
        # section zeroes umiL (ParametersSolo.cpp:291 vs :370); the swap
        # shift uses the live umiL — refreshed in process() for complex
        self.conf = DedupConf(P.soloUMIdedup, P.soloUMIfiltering[0],
                              P.soloMultiMappers, P.soloUMIlen[0])
        self.strand = {"Unstranded": -1, "Forward": 0, "Reverse": 1}[P.soloStrand]
        # readInfo/readIndex wiring (ParametersSolo.cpp:418-448,486-491)
        self.read_info_yes = {ft: False for ft in self.features}
        if FT_VELOCYTO in self.features:
            self.read_info_yes[FT_GENE] = True
        self.sam_attr_feature = self.features[0]
        if getattr(P, "outSAMattrCBUB", False):
            if self.sam_attr_feature not in (FT_GENE, FT_GENEFULL,
                                             FT_GENEFULL_EXONOVERINTRON,
                                             FT_GENEFULL_EX50PAS):
                raise SystemExit(
                    "EXITING because of fatal PARAMETERS error: CB and/or UB "
                    "attributes in --outSAMattributes require --soloFeatures "
                    "Gene OR/AND GeneFull OR/AND GeneFull_Ex50pAS.\nSOLUTION: "
                    "re-run STAR adding Gene AND/OR GeneFull OR/AND "
                    "GeneFull_Ex50pAS OR/AND GeneFull_ExonOverIntron to "
                    "--soloFeatures")
            self.read_info_yes[self.sam_attr_feature] = True
        read_stats_all = getattr(P, "soloCellReadStats", "None") == "Standard"
        self.read_stats_yes = {ft: (read_stats_all and ft not in (FT_SJ, FT_VELOCYTO))
                               for ft in self.features}
        read_index_yes = {ft: (self.read_info_yes[ft] or self.read_stats_yes[ft])
                          for ft in self.features}
        if self.conf.multi_yes:
            for ft in self.features:
                if ft in GENEISH:
                    read_index_yes[ft] = True
        self.recorders = {ft: SoloReadFeature(
            ft, P, self.bc.wl_size, read_index_yes[ft],
            self.read_stats_yes[ft], self.read_info_yes[ft],
            smart_seq=self.smart_seq)
            for ft in self.features}
        self.bar_stats = dict.fromkeys(BAR_STATS, 0)
        self.n_reads = 0
        self.q30_bc = [0, 0]
        self.q30_rna = [0, 0]
        self.need_gene_annot = any(ft in (FT_GENE, FT_GENEFULL_EXONOVERINTRON,
                                          FT_TRANSCRIPT3P, FT_VELOCYTO)
                                   for ft in self.features)
        self.velocyto_yes = FT_VELOCYTO in self.features
        self.procs: Dict[int, SoloFeatureProc] = {}

    # -------------------------------------------------------------- mapping
    def add_read(self, res, b_seq: str, b_qual: str, i_read: int):
        self.n_reads += 1
        if self.smart_seq:
            # well index = input file index; pseudo-UMI computed per feature
            # in SoloReadFeature.record (getCBandUMI.cpp:152-160)
            cb_match = 0
            matches = [(getattr(res, "read_file_index", 0), "")]
            umi = None
            parts = ("", "", "", "")
        else:
            cb_match, matches, umi, parts = self.bc.get_cb_umi(b_seq, b_qual)
        # raw barcode attrs for SAM CR/CY/UR/UY (alignBAM ATTR_CR etc.)
        res.solo_bar = parts
        # qualHist basis: CB+UMI quals for CB_UMI_Simple, whole barcode read
        # otherwise (getCBandUMI:243-247 vs :261-266)
        q = b_qual if self.bc.qual_whole else parts[1] + parts[3]
        self.q30_bc[1] += len(q)
        self.q30_bc[0] += sum(1 for c in q if ord(c) >= 33 + 30)
        for qs in res.quals:
            self.q30_rna[1] += len(qs)
            self.q30_rna[0] += sum(1 for c in qs if ord(c) >= 33 + 30)
        key = {0: "yesWLmatchExact", 1: "yesOneWLmatchWithMM",
               -1: "noNoWLmatch", -2: "noNinCB", -3: "noTooManyWLmatches",
               -11: "noNoCB", -12: "noTooManyMM", -21: "noNoAdapter",
               -22: "noNoUMI", -23: "noNinUMI",
               -24: "noUMIhomopolymer"}.get(cb_match, "yesMultWLmatchWithMM")
        self.bar_stats[key] += 1

        n_tr = 0 if res.unmap_type >= 0 else res.n_tr
        annot = ReadAnnot()
        if n_tr > 0:
            if self.need_gene_annot:
                classify_align(self.trm, res.transcripts, n_tr, self.strand,
                               self.velocyto_yes, annot)
            if FT_GENEFULL in self.features:
                gene_full_overlap(self.trm, res.transcripts, n_tr,
                                  self.strand, annot)
            if FT_GENEFULL_EXONOVERINTRON in self.features:
                gene_full_exon_over_intron(self.trm, res.transcripts, n_tr,
                                           self.strand, annot)
            if FT_GENEFULL_EX50PAS in self.features:
                align_exon_overlap(self.trm, res.transcripts, n_tr,
                                   self.strand, annot)
        chr_names = None
        if n_tr > 0 and any(self.read_stats_yes.values()):
            gi = self.gi
            chr_names = [gi.chr_name[int(gi.chr_bin[res.transcripts[i].exons[0][1]
                                                    >> gi.chr_bin_nbits])]
                         for i in range(n_tr)]
        res.solo_falign = annot.falign.get(self.sam_attr_feature)
        res.solo_fset = annot.fset.get(self.sam_attr_feature)
        for ft in self.features:
            self.recorders[ft].record(annot, n_tr, res.transcripts, i_read,
                                      cb_match, matches, umi, chr_names)

    # ---------------------------------------------------------------- output
    def process(self, out_dir: str, run_stats: Dict[str, int],
                sj_all: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        """the Solo.out files of every feature.  Under pipeline.TIMING its
        parts are spans inside run.py's solo_process: solo_collapse (the
        UMI collapse), solo_raw_out (Features.stats and the raw matrices),
        solo_filter (cell filtering and the filtered matrices, with
        EmptyDrops_CR's Monte-Carlo null in solo_mc inside it) and
        solo_stats (Summary.csv, UMIperCellSorted, CellReads.stats)"""
        from ..ops.pipeline import _tick
        P = self.P
        # the swapped-halves shift reads the live umiL (umiSwapHalves,
        # ParametersSolo.cpp:497-498) — for CB_UMI_Complex that is the length
        # of the first read's UMI, while umi_mask_low stays stale (see ctor)
        self.conf.umi_l_bits = self.bc.umi_l
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "Barcodes.stats"), "w") as f:
            f.write("".join(f"{k:>50}{v:>15}\n" for k, v in self.bar_stats.items()))
        if self.bc.mm1_multi_pc:
            self.bc.cb_read_count_exact += 1

        bar_inval = sum(self.bar_stats[k] for k in BAR_STATS[:9])
        for ft in self.features:
            proc = SoloFeatureProc(ft, P, self.conf, self.trm, self.bc,
                                   self.recorders[ft], self.read_info_yes[ft],
                                   self.device)
            self.procs[ft] = proc
            prefix = os.path.join(out_dir, FEATURE_DIRNAMES[ft]) + "/"
            os.makedirs(prefix, exist_ok=True)
            if ft == FT_SJ:
                proc.sj_all = sj_all
            proc.sum_threads()
            if ft == FT_TRANSCRIPT3P:
                # Transcript3p: EM quantification only, no stats/raw/filtered
                # outputs (reference SoloFeature_processRecords.cpp:47-49)
                proc.quant_transcript(prefix, P)
                continue
            with _tick("solo_collapse"):
                if ft == FT_VELOCYTO:
                    proc.count_velocyto(self.procs[FT_GENE])
                elif self.smart_seq:
                    proc.count_smart_seq()
                else:
                    proc.count_cb_gene_umi()
            with _tick("solo_raw_out"):
                with open(prefix + "Features.stats", "w") as f:
                    f.write("".join(f"{k:>50}{v:>15}\n"
                                    for k, v in proc.rf.stats.items()))
                proc.output_results(False, prefix + "raw/", P)
            with _tick("solo_filter"):
                proc.cell_filtering(P, prefix + "filtered/",
                                    self.procs.get(FT_GENE))
            with _tick("solo_stats"):
                proc.stats_output(prefix, P, run_stats, bar_inval,
                                  self.q30_bc, self.q30_rna)
                if proc.rf.read_stats_yes:
                    self._cell_reads_stats(proc, prefix)

    def _cell_reads_stats(self, proc: SoloFeatureProc, prefix: str):
        """CellReads.stats (reference SoloFeature_statsOutput.cpp:88-121);
        reference iterates a libstdc++ unordered_map — see utils.stdhash"""
        from ..utils.stdhash import UnorderedMap
        um = UnorderedMap(reserve=proc.n_cb * 3 // 2)
        for cb, arr in proc.flag_counts.items():
            um.insert(cb, arr)
        with open(prefix + "CellReads.stats", "w") as f:
            f.write("CB\t" + "\t".join(FLAG_NAMES)
                    + "\tnUMIunique\tnGenesUnique\tnUMImulti\tnGenesMulti\n")
            f.write("CBnotInPasslist\t"
                    + "\t".join(str(x) for x in proc.rf.flag_counts_no_cb)
                    + "\t0\t0\t0\t0\n")
            multi = getattr(proc, "n_umi_per_cb_multi", None)
            for cb, arr in um.items():
                f.write(self.bc.wl_str[cb])
                for v in arr:
                    f.write(f"\t{v}")
                icb = int(proc.ind_cb_wl[cb])
                if icb == -1:
                    f.write("\t0\t0\t0\t0")
                else:
                    f.write(f"\t{proc.n_umi_per_cb[icb]}\t{proc.n_gene_per_cb[icb]}")
                    if multi is None:
                        f.write("\t0\t0")
                    else:
                        f.write(f"\t{fmt_g(multi[icb])}\t{proc.n_gene_per_cb_multi[icb]}")
                f.write("\n")
