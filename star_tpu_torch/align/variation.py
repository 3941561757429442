"""Variation (VCF SNVs) + WASP allele-specific mapping filter.

Replicates reference STAR semantics:
- VCF loading: source/Variation.cpp scanVCF (SNV-only, genotype parsing,
  hetero-only filtering under WASP, coordinate sort).
- per-transcript SNP annotation: source/Transcript_variationAdjust.cpp —
  populates varInd/varGenCoord/varReadCoord/varAllele on each candidate
  transcript during stitching (stitchWindowAligns.cpp:240); with the
  reference's VAR_noScoreCorrection set, the score is NOT adjusted.
- WASP remapping filter: source/ReadAlign_waspMap.cpp — enumerate all
  allele-swap combinations of the read's het SNPs, remap each, and require
  the identical unique alignment; vW tag classes 1..7.
"""
from __future__ import annotations

from typing import List

import numpy as np

_NT01234 = {"A": 0, "C": 1, "G": 2, "T": 3, "a": 0, "c": 1, "g": 2, "t": 3}


class Variation:
    """Sorted het/any SNV table in global genome coordinates
    (reference Variation::loadVCF + scanVCF)."""

    def __init__(self, P, chr_start, chr_name_index):
        self.loci = np.zeros(0, dtype=np.uint64)
        self.nt = np.zeros((0, 3), dtype=np.int8)  # [ref, allele1, allele2]
        self.yes = P.varVCFfile != "-"
        if self.yes:
            self._load_vcf(P, chr_start, chr_name_index)

    def _load_vcf(self, P, chr_start, chr_name_index):
        hetero_only = P.waspOutputMode == "SAMtag"  # Parameters.cpp:866
        loci: List[int] = []
        nts: List[List[int]] = []
        with open(P.varVCFfile) as fh:
            for line in fh:
                fields = line.split()
                if not fields or fields[0].startswith("#"):
                    continue
                if len(fields) < 10:
                    continue
                chrom, pos, _id, ref, alt = fields[0], fields[1], fields[2], \
                    fields[3], fields[4]
                sample = fields[9]
                alt_v = alt.split(",")
                # only SNVs: 1-char ref and all alts 1-char (scanVCF)
                if len(ref) != 1 or max(len(a) for a in alt_v) != 1 \
                        or len(alt_v) > 3:
                    continue
                alleles = [ref] + alt_v
                if chrom not in chr_name_index:
                    continue  # warning only in reference
                if len(sample) < 3:
                    continue  # undefined genotype
                if len(sample) > 3 and sample[3] != ":":
                    continue  # >2 alleles per sample (warning)
                # atoi(&sample.at(k)): leading-digit parse, 0 if non-digit
                a0 = int(sample[0]) if sample[0].isdigit() else 0
                a2 = int(sample[2]) if sample[2].isdigit() else 0
                if sample[0] == "0" and sample[2] == "0":
                    continue
                if a0 >= len(alleles) or a2 >= len(alleles):
                    continue  # reference would throw; skip malformed
                if alleles[a0][0] == ref and alleles[a2][0] == ref:
                    continue  # both effectively reference
                if hetero_only and sample[0] == sample[2]:
                    continue  # homozygous, not used under WASP
                nt1 = [_NT01234.get(ref, 4),
                       _NT01234.get(alleles[a0][0], 4),
                       _NT01234.get(alleles[a2][0], 4)]
                if max(nt1) < 4:
                    loci.append(int(pos) - 1 + int(chr_start[chr_name_index[chrom]]))
                    nts.append(nt1)
        if not loci:
            raise SystemExit(
                "EXITING because of FATAL INPUT FILE ERROR: could not find "
                "any SNPs in VCF file: " + P.varVCFfile +
                "\nSOLUTION: check formatting of the VCF file; unzip VCF "
                "file or use process substitution.")
        order = np.argsort(np.asarray(loci, dtype=np.uint64), kind="stable")
        self.loci = np.asarray(loci, dtype=np.uint64)[order]
        self.nt = np.asarray(nts, dtype=np.int8)[order]


def variation_adjust(var: Variation, tr, R, chr_start) -> int:
    """Annotate transcript with overlapping SNPs
    (Transcript_variationAdjust.cpp). R is the roStr-oriented read
    (Read1[0] or Read1[2]). Score unchanged (VAR_noScoreCorrection)."""
    if var is None or not var.yes:
        return 0
    loci = var.loci
    N = len(loci)
    for ie in range(tr.nExons):
        gS = tr.exons[ie][1]
        gE = gS + tr.exons[ie][2]
        isnp = int(np.searchsorted(loci, np.uint64(gS), side="left"))
        while isnp < N and int(loci[isnp]) < gE:
            if tr.varInd is None:
                tr.varInd, tr.varGenCoord = [], []
                tr.varReadCoord, tr.varAllele = [], []
            g = int(loci[isnp])
            tr.varInd.append(isnp)
            tr.varGenCoord.append(g - int(chr_start[tr.Chr]))
            vr = tr.exons[ie][0] + g - gS
            tr.varReadCoord.append(vr)
            ntR = R[vr]
            if ntR > 3:
                igt = 4
            elif var.nt[isnp][1] == ntR:
                igt = 1
            elif var.nt[isnp][2] == ntR:
                igt = 2
            else:
                igt = 3
            tr.varAllele.append(igt)
            isnp += 1
    return 0


def wasp_map(aligner, res, reads) -> int:
    """WASP allele-swap remapping classification (ReadAlign_waspMap.cpp).
    Returns waspType: -1 no variants / not applicable, 1 passed, 2 multimap,
    3 variant-N in read, 4 remap unmapped, 5 remap multimap, 6 remap moved,
    7 too many variants."""
    tr1 = res.tr_best
    var = aligner.var
    vA = tr1.varAllele or []
    if len(vA) == 0:
        return -1
    if res.n_tr > 1:
        return 2
    if len(vA) > 10:
        return 7
    if any(a > 3 for a in vA):
        return 3

    from .seed import search_pieces
    from ..constants import COMPLEMENT, MARK_FRAG_SPACER_BASE
    P, gi = aligner.P, aligner.gi
    lread = res.lread
    comp_lut = np.full(256, 0, dtype=np.int8)
    for i, c in enumerate(COMPLEMENT):
        comp_lut[i] = c
    comp_lut[MARK_FRAG_SPACER_BASE] = MARK_FRAG_SPACER_BASE

    wasp_ra = getattr(aligner, "_wasp_ra", None)
    if wasp_ra is None:
        wasp_ra = type(aligner)(gi, P)
        wasp_ra.clip_mates = None
        wasp_ra.wasp_mode = True
        aligner._wasp_ra = wasp_ra

    # all combinations of {1,2}^n in the reference's enumeration order
    n = len(vA)
    combos = [[]]
    for _ in range(n):
        combos = [x + [y] for x in combos for y in (1, 2)]

    for vA1 in combos:
        if vA1 == list(vA):
            continue  # the real read, already mapped
        read1 = np.array(reads[0], dtype=np.int8, copy=True)
        for iv in range(n):
            nt2 = int(var.nt[tr1.varInd[iv]][vA1[iv]])
            vr = tr1.varReadCoord[iv]
            if tr1.Str == 1:
                nt2 = 3 - nt2
                vr = lread - 1 - vr
            read1[vr] = nt2
        r1c = comp_lut[read1]
        w_reads = (read1, r1c, r1c[::-1].copy())
        from .engine import ReadResult
        w_res = ReadResult(name=res.name, seqs=res.seqs, quals=res.quals)
        w_res.read_length = list(res.read_length)
        w_res.read_length_original = list(res.read_length_original)
        w_res.lread = lread
        seeds = search_pieces(gi, P, read1, lread)
        wasp_ra.finish_read(w_res, w_reads, seeds)
        tr2 = w_res.tr_best
        if w_res.unmap_type != -1:
            return 4
        if w_res.n_tr > 1:
            return 5
        if tr2.nExons != tr1.nExons:
            return 6
        for ii in range(tr1.nExons):
            for jj in range(3):
                if tr1.exons[ii][jj] != tr2.exons[ii][jj]:
                    return 6
    return 1
