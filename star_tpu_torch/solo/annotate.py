"""Read annotation for STARsolo features.

Reference behavior: source/Transcriptome_classifyAlign.cpp (Gene feature:
alignToTranscript concordance + velocyto per-transcript types via
alignToTranscriptMinOverlap), source/Transcriptome_geneFullAlignOverlap.cpp
(GeneFull: gene-span overlap), source/Transcriptome_geneFullAlignOverlap_ExonOverIntron.cpp,
source/Transcriptome_alignExonOverlap.cpp (GeneFull_Ex50pAS prioritized
overlap types), source/Transcript.cpp:38 (extractSpliceJunctions),
source/ReadAnnotations.h (ReadAnnotFeature).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

# AlignVsTranscript.h
AVT_INTRON, AVT_EXON_INTRON, AVT_SPAN, AVT_CONCORDANT = 0, 1, 2, 3

# ReadAnnotFeature::overlapTypes
OV_NONE, OV_EXONIC, OV_EXONIC_AS, OV_EXONIC50P, OV_EXONIC50P_AS, \
    OV_INTRONIC, OV_INTRONIC_AS, OV_INTERGENIC = range(8)

# feature type ids (SoloFeatureTypes.h)
FT_GENE, FT_GENEFULL, FT_GENEFULL_EXONOVERINTRON, FT_GENEFULL_EX50PAS, \
    FT_SJ, FT_TRANSCRIPT3P, FT_VELOCYTO_SIMPLE, FT_VELOCYTO = range(8)
FEATURE_NAMES = {"Gene": FT_GENE, "GeneFull": FT_GENEFULL,
                 "GeneFull_ExonOverIntron": FT_GENEFULL_EXONOVERINTRON,
                 "GeneFull_Ex50pAS": FT_GENEFULL_EX50PAS,
                 "SJ": FT_SJ, "Transcript3p": FT_TRANSCRIPT3P,
                 "VelocytoSimple": FT_VELOCYTO_SIMPLE, "Velocyto": FT_VELOCYTO}
FEATURE_DIRNAMES = {FT_GENE: "Gene", FT_GENEFULL: "GeneFull",
                    FT_GENEFULL_EXONOVERINTRON: "GeneFull_ExonOverIntron",
                    FT_GENEFULL_EX50PAS: "GeneFull_Ex50pAS",
                    FT_SJ: "SJ", FT_TRANSCRIPT3P: "Transcript3p",
                    FT_VELOCYTO_SIMPLE: "VelocytoSimple", FT_VELOCYTO: "Velocyto"}


class ReadAnnot:
    """per-read annotation across the requested features"""

    def __init__(self):
        self.fset: Dict[int, Set[int]] = {}
        self.falign: Dict[int, List[Set[int]]] = {}  # per-alignment gene sets
        self.ov_type: Dict[int, int] = {}
        self.transcript_concordant: List[Tuple[int, int]] = []
        self.tr_velocyto: List[Tuple[int, int]] = []  # (tr, type bits)


def _le_index(arr, x) -> int:
    """binarySearch1a: largest i with arr[i] <= x, or -1"""
    return int(np.searchsorted(arr, x, side="right")) - 1


def _binary_search_le_left(x: int, arr, n: int) -> Optional[int]:
    """binarySearch_leLeft: index of element <= x, leftmost among equals"""
    if n == 0 or x > arr[n - 1] or x < arr[0]:
        return None
    i = int(np.searchsorted(arr[:n], x, side="left"))
    if i < n and arr[i] == x:
        return i
    return i - 1


def align_to_transcript(a, tr_s1: int, ex_n1: int, ex_se, ex_len_cum):
    """reference alignToTranscript (Transcriptome_classifyAlign.cpp:8-91);
    returns (status, dist_tr_ends) with status -1 for inconsistent."""
    intronic = exonic = span = False
    concordant = True
    ex1 = 0
    e_e = en_s = 0
    b_e = 0
    dist = [0, 0]
    for iab in range(a.nExons):
        b_e_prev = b_e
        if a.exons[iab][1] < tr_s1:
            return -1, dist
        b_s = a.exons[iab][1] - tr_s1
        b_e = b_s + a.exons[iab][2] - 1
        if iab == 0 or a.canonSJ[iab - 1] == -3:
            r = _binary_search_le_left(b_s, ex_se, 2 * ex_n1)
            if r is None:
                return -1, dist
            ex1 = r // 2
        elif a.canonSJ[iab - 1] >= 0:
            if b_e_prev == e_e and b_s == en_s:
                ex1 += 1
            else:
                concordant = False
                r = _binary_search_le_left(b_s, ex_se, 2 * ex_n1)
                if r is None:
                    return -1, dist
                ex1 = r // 2
        e_e = int(ex_se[2 * ex1 + 1])
        en_s = int(ex_se[2 * (ex1 + 1)]) if ex1 + 1 < ex_n1 else 0
        if b_s <= e_e:
            if b_e > e_e:
                span = True
            exonic = True
            if iab == 0:
                dist[0] = int(ex_len_cum[ex1]) + b_s - int(ex_se[2 * ex1])
            dist[1] = e_e - b_e + (0 if ex1 == ex_n1 - 1 else
                                   int(ex_se[2 * ex_n1 - 1]) - int(ex_se[2 * ex_n1 - 2]) + 1
                                   + int(ex_len_cum[ex_n1 - 1]) - int(ex_len_cum[ex1 + 1]))
        else:
            if b_e >= en_s:
                span = True
            intronic = True
    if not concordant:
        return -1, dist
    if span:
        return AVT_SPAN, dist
    if not intronic:
        return AVT_CONCORDANT, dist
    return (AVT_EXON_INTRON if exonic else AVT_INTRON), dist


def align_to_transcript_min_overlap(a, tr_s1: int, ex_se, ex_n1: int,
                                    min_overlap_m1: int) -> int:
    """reference alignToTranscriptMinOverlap (velocyto, MIN_FLANK=5 => 6)"""
    intronic = exonic = span = False
    sj_concordant = True
    iab = 0
    while iab < a.nExons:
        b_s = a.exons[iab][1] - tr_s1
        ex1 = (int(np.searchsorted(ex_se[:2 * ex_n1], b_s, side="right")) - 1) // 2
        if ex1 == ex_n1 - 1:
            exonic = True
            break
        while iab < a.nExons - 1 and -3 < a.canonSJ[iab] < 0:
            iab += 1
        b_e = a.exons[iab][1] - tr_s1 + a.exons[iab][2] - 1
        if b_e - b_s >= min_overlap_m1:
            e_e = int(ex_se[2 * ex1 + 1])
            en_s = int(ex_se[2 * ex1 + 2])
            en_e = int(ex_se[2 * ex1 + 3])
            if b_s + min_overlap_m1 <= e_e:
                if b_e <= e_e + min_overlap_m1:
                    exonic = True
                else:
                    span = True
            elif b_s + min_overlap_m1 < en_s:
                if b_e >= en_s + min_overlap_m1:
                    span = True
                elif b_e > e_e + min_overlap_m1:
                    if en_s - e_e > 1000000:
                        return -1
                    intronic = True
            else:
                if b_e > en_e + min_overlap_m1:
                    span = True
                elif b_e >= en_s + min_overlap_m1:
                    exonic = True
            if getattr(a, "sjYes", any(c >= 0 for c in a.canonSJ[:a.nExons - 1])) \
                    and (intronic or span):
                sj_concordant = False
                break
        iab += 1
    if not sj_concordant:
        return -1
    if span:
        return AVT_SPAN
    if not intronic:
        return AVT_CONCORDANT
    return AVT_EXON_INTRON if exonic else AVT_INTRON


def classify_align(trm, transcripts, n_tr: int, strand: int,
                   velocyto_yes: bool, annot: ReadAnnot):
    """reference Transcriptome::classifyAlign: Gene fset + transcriptConcordant
    + per-transcript velocyto types."""
    fset: Set[int] = set()
    falign: List[Set[int]] = [set() for _ in range(n_tr)]
    re_ge = -2
    re_ann = 0
    for iag in range(n_tr):
        a = transcripts[iag]
        tr1 = _le_index(trm.tr_s, a.exons[0][1])
        if tr1 < 0:
            continue
        a_gend = a.exons[a.nExons - 1][1] + a.exons[a.nExons - 1][2] - 1
        tr1 += 1
        while True:
            tr1 -= 1
            ok = a_gend <= trm.tr_e[tr1]
            if ok and strand >= 0:
                a_str = a.Str if trm.tr_str[tr1] == 1 else 1 - a.Str
                ok = (a_str == strand)
            if ok:
                i0 = int(trm.tr_ex_i[tr1])
                ex_n = int(trm.tr_ex_n[tr1])
                ex_se = trm.ex_se[2 * i0:2 * (i0 + ex_n)]
                ex_len_cum = trm.ex_len_cum[i0:i0 + ex_n]
                status, dist = align_to_transcript(
                    a, int(trm.tr_s[tr1]), ex_n, ex_se, ex_len_cum)
                if status == AVT_CONCORDANT:
                    dist_tts = dist[1] if trm.tr_str[tr1] == 1 else dist[0]
                    annot.transcript_concordant.append((tr1, dist_tts))
                    fset.add(int(trm.tr_gene[tr1]))
                    falign[iag].add(int(trm.tr_gene[tr1]))
                if velocyto_yes and n_tr == 1:
                    status = align_to_transcript_min_overlap(
                        a, int(trm.tr_s[tr1]), ex_se, ex_n, 6)
                    if status >= 0:
                        if re_ge != -1:
                            if re_ge == -2:
                                re_ge = int(trm.tr_gene[tr1])
                            if re_ge != int(trm.tr_gene[tr1]):
                                re_ge = -1
                            elif status != AVT_SPAN:
                                re_ann |= (1 << AVT_SPAN)  # means NoSpan
                                re_ann |= (1 << status)
                        re_ann1 = 1 << status
                        if status == AVT_SPAN:
                            re_ann1 |= (1 << AVT_INTRON) | (1 << AVT_CONCORDANT)
                        annot.tr_velocyto.append((tr1, re_ann1))
            if not (trm.tr_emax[tr1] >= a_gend and tr1 > 0):
                break
    annot.fset[FT_GENE] = fset
    annot.falign[FT_GENE] = falign
    annot.ov_type[FT_GENE] = OV_EXONIC if fset else OV_NONE


def gene_full_overlap(trm, transcripts, n_tr: int, strand: int,
                      annot: ReadAnnot):
    """reference Transcriptome::geneFullAlignOverlap (gene-span block overlap)"""
    fset: Set[int] = set()
    falign: List[Set[int]] = [set() for _ in range(n_tr)]
    for ia in range(n_tr):
        a = transcripts[ia]
        for ib in range(a.nExons - 1, -1, -1):
            be1 = a.exons[ib][1] + a.exons[ib][2] - 1
            gi1 = _le_index(trm.gf_s, be1)
            while gi1 >= 0 and trm.gf_emax[gi1] >= a.exons[ib][1]:
                if trm.gf_e[gi1] >= a.exons[ib][1]:
                    str1 = a.Str if trm.gf_str[gi1] == 1 else 1 - a.Str
                    if strand == -1 or strand == str1:
                        fset.add(int(trm.gf_g[gi1]))
                        falign[ia].add(int(trm.gf_g[gi1]))
                gi1 -= 1
    annot.fset[FT_GENEFULL] = fset
    annot.falign[FT_GENEFULL] = falign
    # geneFullAlignOverlap does NOT set ovType ("exonic/intronic
    # determination is not done", Transcriptome_geneFullAlignOverlap.cpp:7)
    annot.ov_type[FT_GENEFULL] = OV_NONE


def gene_full_exon_over_intron(trm, transcripts, n_tr: int, strand: int,
                               annot: ReadAnnot):
    """reference geneFullAlignOverlap_ExonOverIntron: concordant genes first,
    else whole-align containment in gene spans (intronic)."""
    gene_fset = annot.fset.get(FT_GENE, set())
    if gene_fset:
        annot.fset[FT_GENEFULL_EXONOVERINTRON] = set(gene_fset)
        annot.falign[FT_GENEFULL_EXONOVERINTRON] = [
            set(s) for s in annot.falign.get(FT_GENE, [])]
        annot.ov_type[FT_GENEFULL_EXONOVERINTRON] = OV_EXONIC
        return
    fset: Set[int] = set()
    falign: List[Set[int]] = [set() for _ in range(n_tr)]
    for ia in range(n_tr):
        a = transcripts[ia]
        a_s = a.exons[0][1]
        a_e = a.exons[a.nExons - 1][1] + a.exons[a.nExons - 1][2] - 1
        gi1 = _le_index(trm.gf_s, a_s)
        while gi1 >= 0 and trm.gf_emax[gi1] >= a_e:
            if trm.gf_e[gi1] >= a_e:
                str1 = a.Str if trm.gf_str[gi1] == 1 else 1 - a.Str
                if strand == -1 or strand == str1:
                    fset.add(int(trm.gf_g[gi1]))
                    falign[ia].add(int(trm.gf_g[gi1]))
            gi1 -= 1
    annot.fset[FT_GENEFULL_EXONOVERINTRON] = fset
    annot.falign[FT_GENEFULL_EXONOVERINTRON] = falign
    annot.ov_type[FT_GENEFULL_EXONOVERINTRON] = OV_INTRONIC if fset else OV_NONE


def _align_blocks_overlap_exons(a, ex_n1: int, ex_se, tr_start1: int):
    """reference alignBlocksOverlapExons: (nOverlap, sjConcord)"""
    i1 = i2 = 0
    n_overlap = 0
    sj_concord = True
    tr_end1 = tr_start1 + int(ex_se[2 * ex_n1 - 1]) + 1
    while i1 < a.nExons and i2 < ex_n1:
        rs1 = a.exons[i1][1]
        re1 = a.exons[i1][1] + a.exons[i1][2]
        rs2 = tr_start1 + int(ex_se[2 * i2])
        re2 = tr_start1 + int(ex_se[2 * i2 + 1]) + 1
        if rs1 < tr_start1 or re1 > tr_end1:
            return -1, sj_concord
        if rs1 >= re2:
            i2 += 1
            if i1 > 0 and a.canonSJ[i1 - 1] >= 0:
                sj_concord = False
        elif rs2 >= re1:
            i1 += 1
            sj_concord = False
        else:
            n_overlap += min(re1, re2) - max(rs1, rs2)
            if i1 > 0 and rs1 != rs2 and a.canonSJ[i1 - 1] >= 0:
                sj_concord = False
            if i1 < a.nExons - 1 and re1 != re2 and a.canonSJ[i1] >= 0:
                sj_concord = False
            if re1 >= re2:
                i2 += 1
            if re2 >= re1:
                i1 += 1
    return n_overlap, sj_concord


def align_exon_overlap(trm, transcripts, n_tr: int, strand: int,
                       annot: ReadAnnot):
    """reference Transcriptome::alignExonOverlap (GeneFull_Ex50pAS):
    prioritized overlap classes; antisense classes are not counted."""
    infos = []  # (gene, iag, overlap-type bools[6])
    ot_as = [False, True, False, True, False, True]
    for iag in range(n_tr):
        a = transcripts[iag]
        a_gstart = a.exons[0][1]
        a_gend = a.exons[a.nExons - 1][1] + a.exons[a.nExons - 1][2] - 1
        tr1 = _le_index(trm.tr_s, a_gstart)
        if tr1 < 0:
            continue
        tr1 += 1
        while True:
            tr1 -= 1
            if a_gend <= trm.tr_e[tr1]:
                str1 = (int(a.Str if strand == 0 else 1 - a.Str)
                        == int(trm.tr_str[tr1]) - 1)
                str1 = str1 or (strand == -1)
                i0 = int(trm.tr_ex_i[tr1])
                ex_n = int(trm.tr_ex_n[tr1])
                n_ov, sjc = _align_blocks_overlap_exons(
                    a, ex_n, trm.ex_se[2 * i0:2 * (i0 + ex_n)], int(trm.tr_s[tr1]))
                if n_ov >= 0:
                    exl = sum(a.exons[iex][2] for iex in range(a.nExons))
                    infos.append((int(trm.tr_gene[tr1]), iag,
                                  [str1 and n_ov == exl and sjc,
                                   (not str1) and n_ov == exl and sjc,
                                   str1 and n_ov > exl // 2,
                                   (not str1) and n_ov > exl // 2,
                                   str1,
                                   not str1]))
            if not (trm.tr_emax[tr1] >= a_gend and tr1 > 0):
                break
    ot_final = [False] * 6
    for (g, ia, ot) in infos:
        for it in range(6):
            if ot[it]:
                ot_final[it] = True
                break
    ov_map = [OV_EXONIC, OV_EXONIC_AS, OV_EXONIC50P, OV_EXONIC50P_AS,
              OV_INTRONIC, OV_INTRONIC_AS]
    ov = OV_INTERGENIC
    for it in range(6):
        if ot_final[it]:
            ov = ov_map[it]
            break
    annot.ov_type[FT_GENEFULL_EX50PAS] = ov
    fset: Set[int] = set()
    falign: List[Set[int]] = [set() for _ in range(n_tr)]
    for it in range(6):
        if ot_final[it]:
            if ot_as[it]:
                break  # antisense reads are not counted
            for (g, ia, ot) in infos:
                if ot[it]:
                    fset.add(g)
                    falign[ia].add(g)
            break
    annot.fset[FT_GENEFULL_EX50PAS] = fset
    annot.falign[FT_GENEFULL_EX50PAS] = falign


def extract_splice_junctions(a) -> Tuple[List[Tuple[int, int]], bool]:
    """reference Transcript::extractSpliceJunctions: (start, gap) pairs"""
    sj = []
    annot_yes = True
    for iex in range(a.nExons - 1):
        if a.canonSJ[iex] >= 0:
            s = a.exons[iex][1] + a.exons[iex][2]
            sj.append((s, a.exons[iex + 1][1] - s))
            if a.sjAnnot[iex] == 0:
                annot_yes = False
    return sj, annot_yes
