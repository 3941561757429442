"""Genome transformation (STARconsensus): apply VCF variants to the genome at
generate time and convert alignments back to original coordinates at output.

Reference behavior: source/Genome_transformGenome.cpp (VCF load, per-
haplotype sequence splicing, conversion blocks, exon loci transformation),
source/Transcript_transformGenome.cpp (alignment back-conversion),
source/ReadAlign_transformGenome.cpp (per-read conversion + diploid dedup),
source/Genome_genomeOutLoad.cpp (conversion-block file), docs/STARconsensus.md.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..constants import encode_seq

SPACER = 5


def load_transform_vcf(path: str, chr_names, ttype: int):
    """VCF -> per-haplotype {chr: [(pos1based, ref, alt)]}.
    Haploid (type 1): first ALT allele, genotype ignored; diploid (type 2):
    genotype characters 0 and 2 of the first sample column select the allele
    per haplotype (reference: Genome_transformGenome.cpp:40-88)."""
    known = set(chr_names)
    out = [dict() for _ in range(ttype)]
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            parts = line.split()
            chrom = parts[0]
            if chrom.startswith("#"):
                continue
            if chrom not in known:
                continue
            if len(parts) < 5:
                continue
            pos = int(parts[1])
            ref = parts[3]
            alts = parts[4].split(",")
            if ttype == 1:
                out[0].setdefault(chrom, []).append((pos, ref, alts[0]))
            else:
                sample = parts[9] if len(parts) > 9 else "0|0"
                for ih in range(2):
                    gt_c = sample[ih * 2] if len(sample) > ih * 2 else "0"
                    gt = int(gt_c) if gt_c.isdigit() else 0
                    if gt == 0:
                        continue
                    out[ih].setdefault(chrom, []).append(
                        (pos, ref, alts[gt - 1]))
    return out


def _filter_sort(variants):
    """sort by pos, drop variants overlapping a previous variant's REF span
    (reference: Genome_transformGenome.cpp:188-199)"""
    variants.sort(key=lambda v: v[0])
    keep = []
    g0 = 0
    for v in variants:
        if v[0] >= g0:
            keep.append(v)
        g0 = max(g0, v[0] + len(v[1]))
    return keep


def transform_chr_len_start(vcf_h: Dict, chr_name, chr_start, chr_length,
                            chr_bin_nbases: int):
    """recompute per-chr lengths/starts after applying variants; also
    filters/sorts the variant lists in place (returns the filtered dict)"""
    chr_length1 = [int(x) for x in chr_length]
    filtered = {}
    for ichr, name in enumerate(chr_name):
        if name not in vcf_h:
            continue
        vv = _filter_sort(list(vcf_h[name]))
        filtered[name] = vv
        for (pos, ref, alt) in vv:
            chr_length1[ichr] += len(alt) - len(ref)
    chr_start1 = [0] * (len(chr_name) + 1)
    for ichr in range(len(chr_name)):
        chr_start1[ichr + 1] = chr_start1[ichr] + \
            ((chr_length1[ichr] + 1) // chr_bin_nbases + 1) * chr_bin_nbases
    return filtered, chr_start1, chr_length1


def transform_g_and_blocks(vcf_h, chr_name, chr_start, chr_length,
                           chr_start1, G, Gnew, blocks: List[List[int]],
                           g_offset1: int = 0):
    """splice alt alleles into Gnew and record conversion blocks
    [old_start, len, new_start] (reference transformGandBlocks)"""
    for ichr, name in enumerate(chr_name):
        cs0 = int(chr_start[ichr])
        cl0 = int(chr_length[ichr])
        cs1 = int(chr_start1[ichr]) + g_offset1
        if name not in vcf_h:
            Gnew[cs1:cs1 + cl0] = G[cs0:cs0 + cl0]
            blocks.append([cs0, cl0, cs1])
            continue
        vv = vcf_h[name]
        iv = 0
        g0, g1 = cs0, cs1
        blocks.append([g0, 0, g1])
        end0 = cs0 + cl0
        while g0 < end0:
            if g0 == vv[iv][0] - 1 + cs0:
                pos, ref, alt = vv[iv]
                a = encode_seq(alt)
                Gnew[g1:g1 + len(a)] = a
                g0 += len(ref)
                g1 += len(alt)
                if len(alt) != len(ref):
                    blocks[-1][1] = (g0 - len(ref) + min(len(ref), len(alt))
                                     - blocks[-1][0])
                    blocks.append([g0, 0, g1])
                if iv < len(vv) - 1:
                    iv += 1
            else:
                Gnew[g1] = G[g0]
                g0 += 1
                g1 += 1
        if blocks[-1][1] == 0:
            blocks[-1][1] = g0 - blocks[-1][0]


def transform_exon_loci(exon_loci: np.ndarray, blocks) -> np.ndarray:
    """point-transform exon start/end through the conversion blocks; a start
    inside a gap moves right, an end inside a gap moves left; exons that
    collapse are dropped (reference transformExonLoci).
    exon_loci columns: (trID, exS, exE, geID)."""
    starts = np.array([b[0] for b in blocks], dtype=np.int64)
    out = []
    for row in exon_loci:
        tr, exS, exE, ge = (int(x) for x in row)
        i = int(np.searchsorted(starts, exS, side="right")) - 1
        b = blocks[i]
        if exS < b[0] + b[1]:
            newS = b[2] + exS - b[0]
        else:
            newS = blocks[i + 1][2]
        while exE > blocks[i][0] + blocks[i][1]:
            i += 1
        b = blocks[i]
        if exE >= b[0]:
            newE = b[2] + exE - b[0]
        else:
            newE = blocks[i - 1][2] + blocks[i - 1][1] - 1
        if newS <= newE:
            out.append((tr, newS, newE, ge))
    return np.array(out, dtype=np.int64).reshape(-1, 4)


def write_blocks_tsv(path: str, blocks):
    """transformGenomeBlocks.tsv: maps transformed->original, so columns are
    written reversed (reference transformBlocksWrite)"""
    with open(path, "w") as f:
        f.write(f"{len(blocks)}\t-1\n")
        for b in blocks:
            f.write(f"{b[2]}\t{b[1]}\t{b[0]}\n")


# ------------------------------------------------------------- mapping side
@dataclass
class GenomeOut:
    """the output (original) genome + conversion blocks, loaded at mapping
    time when --genomeTransformOutput is requested"""
    gi: object                   # GenomeIndex of the original genome
    conv: np.ndarray             # [n+1, 3] (tr_start, len, orig_start)
    ttype: int                   # 1 haploid / 2 diploid
    n_chr_real_main: int         # chromosome count of the TRANSFORMED genome

    @classmethod
    def load(cls, genome_dir: str, ttype: int, n_chr_main: int):
        from .index import GenomeIndex
        gi = GenomeIndex.load(os.path.join(genome_dir, "OriginalGenome"))
        rows = []
        with open(os.path.join(genome_dir, "transformGenomeBlocks.tsv")) as f:
            n, _minus = f.readline().split()
            for _ in range(int(n)):
                a, b, c = f.readline().split()
                rows.append([int(a), int(b), int(c)])
        rows[-1][1] += 1  # never reach the last base (genomeOutLoad)
        rows.append([np.iinfo(np.int64).max, 0, 0])
        return cls(gi=gi, conv=np.array(rows, dtype=np.int64), ttype=ttype,
                   n_chr_real_main=n_chr_main)


def transcript_transform(tr, gen_out: GenomeOut, P):
    """convert one transcript to original-genome coordinates; returns the
    converted Transcript or None (reference Transcript::transformGenome)"""
    from ..align.stitch import _sjdb_find
    coBl = gen_out.conv
    starts = coBl[:, 0]
    gi_out = gen_out.gi

    exo = []  # (r, g, len, frag)
    for (r1, g1, length, ifrag, _sj) in tr.exons:
        g2 = g1 + length - 1
        i = int(np.searchsorted(starts, g1, side="right")) - 1
        b1, bl, b1o = (int(x) for x in coBl[i])
        b2 = b1 + bl - 1
        if g1 <= b2:
            L = length if g2 <= b2 else b2 - g1 + 1
            exo.append([r1, b1o + g1 - b1, L, ifrag])
        i += 1
        while g2 >= int(coBl[i][0]):
            c0, c1, c2 = (int(x) for x in coBl[i])
            L = g2 - c0 + 1 if g2 < c0 + c1 else c1
            exo.append([r1 + c0 - g1, c2, L, ifrag])
            i += 1

    if not exo:
        return None

    # merge blocks without R/G gaps; flush unequal gaps left
    merged = [exo[0]]
    for e in exo[1:]:
        p = merged[-1]
        if e[3] != p[3]:
            merged.append(list(e))
            continue
        gapR = e[0] - p[0] - p[2]
        gapG = e[1] - p[1] - p[2]
        if gapR == gapG:
            p[2] += e[2] + gapR
        else:
            mg = min(gapR, gapG)
            e = list(e)
            if mg > 0:
                e[2] += mg
                e[1] -= mg
                e[0] -= mg
            merged.append(e)

    A = tr.copy()
    A.exons = [[e[0], e[1], e[2], e[3], -1] for e in merged]
    A.nExons = len(merged)
    A.Str = tr.Str
    A.Chr = int(gi_out.chr_bin[merged[0][1] >> gi_out.chr_bin_nbits])

    # recompute canonSJ / sjAnnot against the original genome
    G = gi_out.G_bytes
    A.canonSJ = []
    A.sjAnnot = []
    A.shiftSJ = [[0, 0] for _ in range(max(A.nExons - 1, 0))]
    A.sjStr = [0] * max(A.nExons - 1, 0)
    for ia in range(A.nExons - 1):
        A.canonSJ.append(0)
        A.sjAnnot.append(0)
        if A.exons[ia + 1][3] != A.exons[ia][3]:
            A.canonSJ[ia] = -3
            continue
        jS = A.exons[ia][1] + A.exons[ia][2]
        jE = A.exons[ia + 1][1] - 1
        ind = _sjdb_find(gi_out, jS, jE)
        if ind >= 0:
            A.sjAnnot[ia] = 1
            A.canonSJ[ia] = int(gi_out.sjdb_motif[ind])
            if gi_out.sjdb_motif[ind] == 0:
                sh = int(gi_out.sjdb_shift_left[ind])
                if A.exons[ia][2] <= sh:
                    return None
                A.exons[ia][2] -= sh
                A.exons[ia + 1][1] -= sh
        else:
            gapG = jE - jS + 1
            gapR = A.exons[ia + 1][0] - A.exons[ia][0] - A.exons[ia][2]
            if gapR > 0:
                A.canonSJ[ia] = -2
            elif gapG >= P.alignIntronMin:
                c = 0
                d1, d2, a1, a2 = G[jS], G[jS + 1], G[jE - 1], G[jE]
                if d1 == 2 and d2 == 3 and a1 == 0 and a2 == 2:
                    c = 1
                elif d1 == 1 and d2 == 3 and a1 == 0 and a2 == 1:
                    c = 2
                elif d1 == 2 and d2 == 1 and a1 == 0 and a2 == 2:
                    c = 3
                elif d1 == 1 and d2 == 3 and a1 == 2 and a2 == 1:
                    c = 4
                elif d1 == 0 and d2 == 3 and a1 == 0 and a2 == 1:
                    c = 5
                elif d1 == 2 and d2 == 3 and a1 == 0 and a2 == 3:
                    c = 6
                A.canonSJ[ia] = c
            else:
                A.canonSJ[ia] = -1

    A.rStart = A.exons[0][0]
    A.gStart = A.exons[0][1]
    A.cStart = A.gStart - int(gi_out.chr_start[A.Chr])
    A.rLength = sum(e[2] for e in A.exons)
    A.gLength = A.exons[-1][1] + A.exons[-1][2] - A.exons[0][1]
    return A


def read_transform(res, gen_out: GenomeOut, P):
    """per-read conversion of the selected multimapper set
    (reference ReadAlign::transformGenome): haploType tagging, diploid
    duplicate removal, primary re-marking.  Sets res.transcripts_out /
    res.n_tr_out / res.tr_best_out."""
    res.transcripts_out = res.transcripts
    res.n_tr_out = res.n_tr
    res.tr_best_out = res.tr_best
    if res.n_tr > P.outFilterMultimapNmax or res.n_tr == 0:
        return
    conv = []
    best_slot = -1
    for tr in res.transcripts:
        tr.haploType = 1 if tr.Chr < gen_out.n_chr_real_main // 2 else 2
        a = transcript_transform(tr, gen_out, P)
        if a is not None:
            a.haploType = tr.haploType
            a.maxScore = tr.maxScore
            a.primaryFlag = False
            if tr is res.tr_best:
                best_slot = len(conv)
            conv.append(a)
    if gen_out.ttype == 2 and conv:
        # remove duplicate transcripts mapping to the same original locus
        # from both haplotypes.  NOTE the reference's alBest is a SLOT
        # pointer into the preallocated alMult array: after the keep-
        # compaction it reads whatever transcript landed in its slot
        # (ReadAlign_transformGenome.cpp:57-76) — replicated below.
        keep = [True] * len(conv)
        for i1 in range(len(conv)):
            if not keep[i1]:
                continue
            for i2 in range(i1 + 1, len(conv)):
                if not keep[i1]:
                    continue
                a1, a2 = conv[i1], conv[i2]
                if (a1.Chr == a2.Chr and a1.Str == a2.Str
                        and a1.exons[0][1] - a1.exons[0][0]
                        == a2.exons[0][1] - a2.exons[0][0]
                        and a1.exons[-1][1] + a1.exons[-1][2] - a1.exons[-1][0]
                        == a2.exons[-1][1] + a2.exons[-1][2] - a2.exons[-1][0]):
                    a1.haploType = 0
                    a2.haploType = 0
                    if a1.maxScore > a2.maxScore:
                        keep[i2] = False
                    else:
                        keep[i1] = False
        kept = [c for c, k in zip(conv, keep) if k]
        if best_slot >= 0:
            best = kept[best_slot] if best_slot < len(kept) else conv[best_slot]
        else:
            best = None
        conv = kept
    else:
        best = conv[best_slot] if best_slot >= 0 else None
    res.transcripts_out = conv
    res.n_tr_out = len(conv)
    res.tr_best_out = best if best is not None else (conv[0] if conv else None)
    # primary re-marking (funPrimaryAlignMark, default order)
    if conv:
        conv[0].primaryFlag = True
        if P.outSAMprimaryFlag == "AllBestScore":
            mx = max(c.maxScore for c in conv)
            for c in conv:
                if c.maxScore == mx:
                    c.primaryFlag = True
