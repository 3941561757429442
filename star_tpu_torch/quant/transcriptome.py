"""Transcriptome model + quantification.

Reference behavior: source/Transcriptome.cpp (annotation model load),
source/Transcriptome_geneCountsAddAlign.cpp (GeneCounts: htseq-style 3
strandedness columns), source/Transcriptome_quantAlign.cpp (project genomic
alignments onto transcript coordinates for TranscriptomeSAM),
source/Transcriptome.cpp quantsOutput (ReadsPerGene.out.tab).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..align.transcript import Transcript


@dataclass
class Transcriptome:
    # gene-exon structure (for GeneCounts): sorted by (start, end, ...)
    ex_s: np.ndarray
    ex_e: np.ndarray
    ex_emax: np.ndarray
    ex_str: np.ndarray
    ex_g: np.ndarray
    gene_id: List[str]
    gene_name: List[str]
    # transcript structure (for TranscriptomeSAM)
    tr_id: List[str] = field(default_factory=list)
    tr_s: np.ndarray = None
    tr_e: np.ndarray = None
    tr_emax: np.ndarray = None
    tr_str: np.ndarray = None
    tr_ex_n: np.ndarray = None
    tr_ex_i: np.ndarray = None
    ex_se: np.ndarray = None       # [2*nExTot] exon starts/ends (tr-local)
    ex_len_cum: np.ndarray = None  # [nExTot]

    @classmethod
    def load(cls, tr_info_dir: str) -> "Transcriptome":
        with open(os.path.join(tr_info_dir, "exonGeTrInfo.tab")) as f:
            n_ex = int(f.readline())
            rows = np.loadtxt(f, dtype=np.int64, max_rows=n_ex, ndmin=2)
        ex_s, ex_e = rows[:, 0], rows[:, 1]
        ex_emax = np.maximum.accumulate(ex_e)
        gene_id, gene_name = [], []
        with open(os.path.join(tr_info_dir, "geneInfo.tab")) as f:
            n_ge = int(f.readline())
            for line in f:
                p = line.rstrip("\n").split("\t")
                gene_id.append(p[0])
                gene_name.append(p[1] if len(p) > 1 else p[0])
        t = cls(ex_s=ex_s, ex_e=ex_e, ex_emax=ex_emax,
                ex_str=rows[:, 2].astype(np.int8), ex_g=rows[:, 3].astype(np.int32),
                gene_id=gene_id, gene_name=gene_name)
        # geneFull spans (reference Transcriptome.cpp:100-140): per-gene
        # min-start/max-end over exons, sorted by (start, end)
        n_ge = len(gene_id)
        gf = np.zeros((n_ge, 4), dtype=np.int64)
        gf[:, 0] = np.iinfo(np.int64).max
        for i in range(len(ex_s)):
            g1 = int(rows[i, 3])
            gf[g1, 0] = min(gf[g1, 0], int(rows[i, 0]))
            gf[g1, 1] = max(gf[g1, 1], int(rows[i, 1]))
            gf[g1, 2] = int(rows[i, 2])
        gf[:, 3] = np.arange(n_ge)
        order = np.lexsort((gf[:, 1], gf[:, 0]))
        gf = gf[order]
        t.gf_s, t.gf_e = gf[:, 0].copy(), gf[:, 1].copy()
        t.gf_str, t.gf_g = gf[:, 2].copy(), gf[:, 3].copy()
        t.gf_emax = np.maximum.accumulate(t.gf_e)
        # transcripts
        tr_path = os.path.join(tr_info_dir, "transcriptInfo.tab")
        if os.path.exists(tr_path):
            with open(tr_path) as f:
                n_tr = int(f.readline())
                tr_rows = [l.split() for l in f][:n_tr]
            t.tr_id = [r[0] for r in tr_rows]
            arr = np.array([[int(x) for x in r[1:]] for r in tr_rows], dtype=np.int64)
            t.tr_s, t.tr_e, t.tr_emax = arr[:, 0], arr[:, 1], arr[:, 2]
            t.tr_str = arr[:, 3].astype(np.int8)
            t.tr_ex_n = arr[:, 4].astype(np.int32)
            t.tr_ex_i = arr[:, 5].astype(np.int32)
            t.tr_gene = arr[:, 6].astype(np.int32) if arr.shape[1] > 6 else np.zeros(len(arr), np.int32)
            with open(os.path.join(tr_info_dir, "exonInfo.tab")) as f:
                n_ex2 = int(f.readline())
                er = np.loadtxt(f, dtype=np.int64, max_rows=n_ex2, ndmin=2)
            ex_se = np.empty(2 * n_ex2, dtype=np.int64)
            ex_se[0::2] = er[:, 0]
            ex_se[1::2] = er[:, 1]
            t.ex_se = ex_se
            t.ex_len_cum = er[:, 2]
            # transcript lengths (sum of exon lengths)
            t.tr_length = np.zeros(len(t.tr_id), dtype=np.int64)
            for i in range(len(t.tr_id)):
                i0 = int(t.tr_ex_i[i])
                n1 = int(t.tr_ex_n[i])
                last = i0 + n1 - 1
                t.tr_length[i] = int(t.ex_len_cum[last]
                                     + er[last, 1] - er[last, 0] + 1)
        return t

    @property
    def n_genes(self) -> int:
        return len(self.gene_id)

    @property
    def n_tr(self) -> int:
        return len(self.tr_id)


class GeneCounts:
    """htseq-count-equivalent counting with 3 strandedness columns
    (unstranded / same-strand / reverse-strand)."""

    N_TYPE = 3

    def __init__(self, tr: Transcriptome):
        self.tr = tr
        self.counts = np.zeros((self.N_TYPE, tr.n_genes), dtype=np.int64)
        self.c_none = np.zeros(self.N_TYPE, dtype=np.int64)
        self.c_ambig = np.zeros(self.N_TYPE, dtype=np.int64)
        self.c_multi = 0

    def add_read(self, transcripts: List[Transcript], n_tr: int):
        tr = self.tr
        gene1 = [-1] * self.N_TYPE
        if n_tr > 1:
            self.c_multi += 1
            return gene1
        a = transcripts[0]
        for ib in range(a.nExons - 1, -1, -1):
            g_end = a.exons[ib][1] + a.exons[ib][2] - 1
            g_start = a.exons[ib][1]
            e1 = int(np.searchsorted(tr.ex_s, g_end, side="right")) - 1
            while e1 >= 0 and tr.ex_emax[e1] >= g_start:
                if tr.ex_e[e1] >= g_start:
                    str1 = int(tr.ex_str[e1]) - 1
                    for itype in range(self.N_TYPE):
                        if itype == 1 and a.Str != str1 and 0 <= str1 < 2:
                            continue
                        if itype == 2 and a.Str == str1 and 0 <= str1 < 2:
                            continue
                        g = int(tr.ex_g[e1])
                        if gene1[itype] == -1:
                            gene1[itype] = g
                        elif gene1[itype] == -2:
                            continue
                        elif gene1[itype] != g:
                            gene1[itype] = -2
                e1 -= 1
        for itype in range(self.N_TYPE):
            if gene1[itype] == -1:
                self.c_none[itype] += 1
            elif gene1[itype] == -2:
                self.c_ambig[itype] += 1
            else:
                self.counts[itype][gene1[itype]] += 1
        return gene1

    def write(self, path: str, n_unmapped: int):
        with open(path, "w") as f:
            f.write("N_unmapped" + f"\t{n_unmapped}" * self.N_TYPE + "\n")
            f.write("N_multimapping" + f"\t{self.c_multi}" * self.N_TYPE + "\n")
            f.write("N_noFeature" + "".join(f"\t{x}" for x in self.c_none) + "\n")
            f.write("N_ambiguous" + "".join(f"\t{x}" for x in self.c_ambig) + "\n")
            for ig in range(self.tr.n_genes):
                f.write(self.tr.gene_id[ig]
                        + "".join(f"\t{self.counts[t][ig]}" for t in range(self.N_TYPE))
                        + "\n")


class ShardedGeneCounts:
    """gene counting over a mesh of index shards: reads are routed
    round-robin to dp partial counters; the final merge is psum_merge, a
    sum over the dp rows and an all_reduce across ranks (the analog of the
    reference's thread-0 count reduction, source/STAR.cpp:258-265)."""

    def __init__(self, tr: Transcriptome, mesh):
        self.mesh = mesh
        self.dp = mesh.dp
        self.parts = [GeneCounts(tr) for _ in range(self.dp)]
        self._i = 0

    def add_read(self, transcripts, n_tr: int):
        out = self.parts[self._i % self.dp].add_read(transcripts, n_tr)
        self._i += 1
        return out

    def write(self, path: str, n_unmapped: int):
        from ..parallel.mesh import psum_merge
        merged = self.parts[0]
        stacked = np.stack([p.counts for p in self.parts])
        merged.counts = psum_merge(stacked, self.mesh)
        merged.c_none = psum_merge(np.stack([p.c_none for p in self.parts]),
                                   self.mesh)
        merged.c_ambig = psum_merge(np.stack([p.c_ambig for p in self.parts]),
                                    self.mesh)
        merged.c_multi = int(psum_merge(
            np.array([p.c_multi for p in self.parts], dtype=np.int64),
            self.mesh))
        merged.write(path, n_unmapped)


# ------------------------------------------------------- TranscriptomeSAM
def align_to_transcript(aG: Transcript, tr_s1: int, tr_str1: int,
                        ex_se, ex_len_cum, ex_n: int, lread: int) -> Optional[Transcript]:
    """project a genomic alignment onto one transcript's coordinates;
    None if inconsistent (reference: alignToTranscript)."""
    g1 = aG.exons[0][1] - tr_s1
    ex1 = int(np.searchsorted(ex_se[:2 * ex_n], g1, side="right")) - 1
    if ex1 < 0 or ex1 >= 2 * ex_n:
        return None
    if ex1 % 2 == 1:
        if ex_se[ex1] == g1:
            ex1 -= 1
        else:
            return None
    ex1 //= 2

    aT = Transcript()
    canon = list(aG.canonSJ[:aG.nExons - 1]) + [-999]
    for iab in range(aG.nExons):
        if aG.exons[iab][1] + aG.exons[iab][2] > ex_se[2 * ex1 + 1] + tr_s1 + 1:
            return None
        if iab == 0 or canon[iab - 1] < 0:
            aT.exons.append([aG.exons[iab][0],
                             aG.exons[iab][1] - tr_s1 - int(ex_se[2 * ex1]) + int(ex_len_cum[ex1]),
                             aG.exons[iab][2], aG.exons[iab][3], -1])
            if aT.nExons > 0:
                aT.canonSJ.append(canon[iab - 1])
            aT.nExons += 1
        else:
            aT.exons[-1][2] += aG.exons[iab][2]
        c = canon[iab]
        if c == -999:
            if tr_str1 == 2:
                trlength = int(ex_len_cum[ex_n - 1] + ex_se[2 * ex_n - 1] - ex_se[2 * ex_n - 2] + 1)
                for iex in range(aT.nExons):
                    aT.exons[iex][0] = lread - (aT.exons[iex][0] + aT.exons[iex][2])
                    aT.exons[iex][1] = trlength - (aT.exons[iex][1] + aT.exons[iex][2])
                aT.exons.reverse()
                aT.canonSJ.reverse()
            aT.sjAnnot = [0] * max(aT.nExons - 1, 0)
            aT.shiftSJ = [[0, 0]] * max(aT.nExons - 1, 0)
            aT.sjStr = [0] * max(aT.nExons - 1, 0)
            while len(aT.canonSJ) < max(aT.nExons - 1, 0):
                aT.canonSJ.append(-1)
            return aT
        elif c == -3:
            nx = int(np.searchsorted(ex_se[:2 * ex_n], aG.exons[iab + 1][1] - tr_s1,
                                     side="right")) - 1
            if nx % 2 == 1:
                return None
            ex1 = nx // 2
        elif c in (-2, -1):
            pass
        else:
            if (aG.exons[iab][1] + aG.exons[iab][2] == ex_se[2 * ex1 + 1] + tr_s1 + 1
                    and aG.exons[iab + 1][1] == ex_se[2 * (ex1 + 1)] + tr_s1):
                ex1 += 1
            else:
                return None
    return None


def quant_align(tr: Transcriptome, aG: Transcript, lread: int) -> List[Transcript]:
    """all consistent transcript projections of one genomic alignment"""
    out = []
    tr1 = int(np.searchsorted(tr.tr_s, aG.exons[0][1], side="right")) - 1
    if tr1 < 0:
        return out
    a_gend = aG.exons[aG.nExons - 1][1]
    tr1 += 1
    while True:
        tr1 -= 1
        if a_gend <= tr.tr_e[tr1]:
            i0 = int(tr.tr_ex_i[tr1])
            n1 = int(tr.tr_ex_n[tr1])
            aT = align_to_transcript(aG, int(tr.tr_s[tr1]), int(tr.tr_str[tr1]),
                                     tr.ex_se[2 * i0:2 * (i0 + n1)],
                                     tr.ex_len_cum[i0:i0 + n1], n1, lread)
            if aT is not None:
                aT.Chr = tr1
                aT.Str = aG.Str if tr.tr_str[tr1] == 1 else 1 - aG.Str
                out.append(aT)
        if not (tr.tr_emax[tr1] >= a_gend and tr1 > 0):
            break
    return out
