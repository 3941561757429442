"""GTF annotation parsing and transcript/gene/junction model building.

Reference behavior: source/GTF.cpp (attribute extraction, ID numbering),
source/GTF_transcriptGeneSJ.cpp (metadata files exonGeTrInfo.tab/geneInfo.tab/
transcriptInfo.tab/exonInfo.tab, junction collapse, sjdbList.fromGTF.out.tab).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import numpy as np


@dataclass
class SjdbLoci:
    """collected junctions (1-based intron start/end, chr-name coordinates)"""
    chr: List[str] = field(default_factory=list)
    start: List[int] = field(default_factory=list)
    end: List[int] = field(default_factory=list)
    str_: List[str] = field(default_factory=list)
    gene: List[Set[int]] = field(default_factory=list)
    priority: List[int] = field(default_factory=list)


@dataclass
class Annotation:
    transcript_id: List[str]
    transcript_strand: List[int]
    gene_id: List[str]
    gene_attr: List[Tuple[str, str]]
    exon_loci: np.ndarray  # [N,4] (trID, exS, exE, geID) genome coords 0-based


def parse_gtf(path: str, gi, P) -> Annotation:
    feature = P.sjdbGTFfeatureExon
    prefix = P.sjdbGTFchrPrefix
    tag_tr = [P.sjdbGTFtagExonParentTranscript]
    tag_ge = [P.sjdbGTFtagExonParentGene]
    tag_gn = list(P.sjdbGTFtagExonParentGeneName)
    tag_gt = list(P.sjdbGTFtagExonParentGeneType)
    chr_index = {n: i for i, n in enumerate(gi.chr_name)}

    tr_num: Dict[str, int] = {}
    ge_num: Dict[str, int] = {}
    transcript_id: List[str] = []
    transcript_strand: List[int] = []
    gene_id: List[str] = []
    gene_attr: List[Tuple[str, str]] = []
    rows = []

    with open(path) as f:
        for line_no, line in enumerate(f):
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9 or parts[2] != feature:
                continue
            chrom = parts[0] if prefix == "-" else prefix + parts[0]
            if chrom not in chr_index:
                continue
            ci = chr_index[chrom]
            ex1, ex2 = int(parts[3]), int(parts[4])
            if ex2 > gi.chr_length[ci]:
                continue
            strand = {"+": 1, "-": 2}.get(parts[6], 0)
            attrs = parts[8].replace(";", " ").replace("=", " ").replace('"', " ")
            toks = attrs.split()
            kv = {}
            for i in range(len(toks) - 1):
                kv.setdefault(toks[i], toks[i + 1])

            def get(names, default):
                for n in names:
                    if n in kv:
                        return kv[n]
                return default

            tid = get(tag_tr, f"tr_{chrom}_{ex1}_{ex2}_{len(rows)}")
            gid = get(tag_ge, "MissingGeneID")
            gname = get(tag_gn, gid)
            gtype = get(tag_gt, "MissingGeneType")

            if tid not in tr_num:
                tr_num[tid] = len(tr_num)
                transcript_id.append(tid)
                transcript_strand.append(strand)
            if gid not in ge_num:
                ge_num[gid] = len(ge_num)
                gene_id.append(gid)
                gene_attr.append((gname, gtype))

            cs = int(gi.chr_start[ci])
            rows.append((tr_num[tid], ex1 + cs - 1, ex2 + cs - 1, ge_num[gid]))

    if not rows:
        raise ValueError(f"no '{feature}' lines usable in GTF {path}")
    exon_loci = np.array(rows, dtype=np.int64)
    return Annotation(transcript_id, transcript_strand, gene_id, gene_attr, exon_loci)


def transcript_gene_sj(ann: Annotation, gi, out_dir: str, sjdb: SjdbLoci):
    """sort exons, emit metadata files, extract collapsed junctions
    (priority 20, GTF)"""
    os.makedirs(out_dir, exist_ok=True)
    ex = ann.exon_loci
    order = np.lexsort((ex[:, 3], ex[:, 2], ex[:, 1], ex[:, 0]))
    ex = ex[order]
    n_ex = len(ex)

    # exonGeTrInfo.tab: exons sorted by (start,end,strand,gene,tr)
    strand_arr = np.array(ann.transcript_strand, dtype=np.int64)[ex[:, 0]]
    exge = np.stack([ex[:, 1], ex[:, 2], strand_arr, ex[:, 3], ex[:, 0]], axis=1)
    exge = exge[np.lexsort(tuple(exge[:, i] for i in (4, 3, 2, 1, 0)))]
    with open(os.path.join(out_dir, "exonGeTrInfo.tab"), "w") as f:
        f.write(f"{n_ex}\n")
        for r in exge:
            f.write("\t".join(str(int(x)) for x in r) + "\n")

    with open(os.path.join(out_dir, "geneInfo.tab"), "w") as f:
        f.write(f"{len(ann.gene_id)}\n")
        for g, (gn, gt) in zip(ann.gene_id, ann.gene_attr):
            f.write(f"{g}\t{gn}\t{gt}\n")

    # transcript spans
    tr_start = {}
    tr_end = {}
    for t, s, e, g in ex:
        t = int(t)
        tr_start.setdefault(t, int(s))
        tr_end[t] = max(tr_end.get(t, 0), int(e))
    # extr records sorted by (trStart, trEnd, trID, exStart, exEnd)
    extr = np.stack([
        np.array([tr_start[int(t)] for t in ex[:, 0]], dtype=np.int64),
        np.array([tr_end[int(t)] for t in ex[:, 0]], dtype=np.int64),
        ex[:, 0], ex[:, 1], ex[:, 2], ex[:, 3]], axis=1)
    extr = extr[np.lexsort(tuple(extr[:, i] for i in (4, 3, 2, 1, 0)))]

    with open(os.path.join(out_dir, "transcriptInfo.tab"), "w") as ftr, \
         open(os.path.join(out_dir, "exonInfo.tab"), "w") as fex:
        ftr.write(f"{len(ann.transcript_id)}\n")
        fex.write(f"{n_ex}\n")
        trid = int(extr[0, 2])
        trex = 0
        trstart = int(extr[0, 0])
        trend_max = int(extr[0, 1])
        exlen = 0
        for iex in range(n_ex + 1):
            if iex == n_ex or int(extr[iex, 2]) != trid:
                ftr.write(f"{ann.transcript_id[trid]}\t{int(extr[iex-1,0])}\t"
                          f"{int(extr[iex-1,1])}\t{trend_max}\t"
                          f"{ann.transcript_strand[trid]}\t{iex-trex}\t{trex}\t"
                          f"{int(extr[iex-1,5])}\n")
                if iex == n_ex:
                    break
                trid = int(extr[iex, 2])
                trstart = int(extr[iex, 0])
                trex = iex
                trend_max = max(trend_max, int(extr[iex - 1, 1]))
                exlen = 0
            fex.write(f"{int(extr[iex,3])-trstart}\t{int(extr[iex,4])-trstart}\t{exlen}\n")
            exlen += int(extr[iex, 4]) - int(extr[iex, 3]) + 1

    # junctions between consecutive exons of each transcript
    sj_rows = []
    for iex in range(1, n_ex):
        if ex[iex, 0] != ex[iex - 1, 0]:
            continue
        if ex[iex, 1] <= ex[iex - 1, 2] + 1:
            continue  # touching/overlapping
        sj_rows.append((int(ex[iex - 1, 2]) + 1, int(ex[iex, 1]) - 1,
                        int(strand_arr[iex]), int(ex[iex, 3]) + 1))
    sj_rows.sort()

    strand_char = ".+-"
    n0 = len(sjdb.chr)
    for i, (s, e, st, g) in enumerate(sj_rows):
        if i > 0 and (s, e, st) == sj_rows[i - 1][:3]:
            sjdb.gene[-1].add(g)
            continue
        ci = int(gi.chr_bin[s >> gi.chr_bin_nbits])
        cs = int(gi.chr_start[ci])
        sjdb.chr.append(gi.chr_name[ci])
        sjdb.start.append(s + 1 - cs)
        sjdb.end.append(e + 1 - cs)
        sjdb.str_.append(strand_char[st])
        sjdb.gene.append({g})

    with open(os.path.join(out_dir, "sjdbList.fromGTF.out.tab"), "w") as f:
        for i in range(n0, len(sjdb.chr)):
            genes = ",".join(str(g) for g in sorted(sjdb.gene[i]))
            f.write(f"{sjdb.chr[i]}\t{sjdb.start[i]}\t{sjdb.end[i]}\t{sjdb.str_[i]}\t{genes}\n")

    sjdb.priority += [20] * (len(sjdb.chr) - len(sjdb.priority))
    return sjdb
