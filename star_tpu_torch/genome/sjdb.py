"""Junction database preparation and insertion.

Reference behavior: source/sjdbPrepare.cpp (motif detection, repeat shifts,
left-shift collapse, priority dedup, strand-collision resolution, pseudo-
sequence construction, sjdbInfo.txt/sjdbList.out.tab), source/
sjdbInsertJunctions.cpp (orchestration).

Insertion is incremental like the reference (sjdbBuildIndex.cpp/
insertSeqSA.cpp): the new junction-region suffixes are comparator-sorted and
rank-merged into the pristine index's SA by parallel binary search
(native/sa_sort.cpp sa_insert_ranks), avoiding a full re-sort; the SAi is
rebuilt by the vectorized chunked scan.  A full re-sort remains as the
fallback (no native lib, or a chromosome ending flush on a bin boundary).
The resulting SA/SAi are bit-identical to the reference's insertion
(validated against the reference's own GTF index in tests).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from .gtf import SjdbLoci, parse_gtf, transcript_gene_sj
from .fasta import build_t2
from .generate import sort_suffixes, build_sai

MAX_SHIFT = 255


def sjdb_prepare(sjdb: SjdbLoci, gi, n_genome_real: int, out_dir: str = None):
    """collapse/dedup junctions, compute motifs + shifts; returns dict of
    per-junction arrays (sorted by (start, end))."""
    G = gi.G
    n = len(sjdb.chr)
    chr_index = {nm: i for i, nm in enumerate(gi.chr_name)}
    S = np.empty(n, dtype=np.int64)
    E = np.empty(n, dtype=np.int64)
    motif = np.zeros(n, dtype=np.int64)
    shift_l = np.zeros(n, dtype=np.int64)
    shift_r = np.zeros(n, dtype=np.int64)

    for ii in range(n):
        ic = chr_index[sjdb.chr[ii]]
        s = sjdb.start[ii] + int(gi.chr_start[ic]) - 1
        e = sjdb.end[ii] + int(gi.chr_start[ic]) - 1
        S[ii], E[ii] = s, e
        d1, d2, a1, a2 = G[s], G[s + 1], G[e - 1], G[e]
        if (d1, d2, a1, a2) == (2, 3, 0, 2):
            motif[ii] = 1
        elif (d1, d2, a1, a2) == (1, 3, 0, 1):
            motif[ii] = 2
        elif (d1, d2, a1, a2) == (2, 1, 0, 2):
            motif[ii] = 3
        elif (d1, d2, a1, a2) == (1, 3, 2, 1):
            motif[ii] = 4
        elif (d1, d2, a1, a2) == (0, 3, 0, 1):
            motif[ii] = 5
        elif (d1, d2, a1, a2) == (2, 3, 0, 3):
            motif[ii] = 6
        jjl = 0
        while jjl <= s - 1 and G[s - 1 - jjl] == G[e - jjl] and G[s - 1 - jjl] < 4 and jjl < MAX_SHIFT:
            jjl += 1
        jjr = 0
        while s + jjr < n_genome_real and G[s + jjr] == G[e + 1 + jjr] and G[s + jjr] < 4 and jjr < MAX_SHIFT:
            jjr += 1
        shift_l[ii], shift_r[ii] = jjl, jjr
        S[ii] -= jjl
        E[ii] -= jjl

    # dedup at left-shifted coordinates (strand-separated sort)
    strand_shift = np.array([{"+": 0, "-": 1}.get(c, 2) * n_genome_real
                             for c in sjdb.str_], dtype=np.int64)
    order = np.lexsort((np.arange(n), E + strand_shift, S + strand_shift))
    prio = np.array(sjdb.priority, dtype=np.int64)
    kept: List[int] = []
    for ii in order:
        if kept and S[ii] == S[kept[-1]] and E[ii] == E[kept[-1]] \
                and strand_shift[ii] == strand_shift[kept[-1]]:
            i0 = kept[-1]
            if prio[ii] < prio[i0]:
                continue
            if prio[ii] > prio[i0]:
                kept[-1] = ii
            elif (motif[ii] > 0 and motif[i0] == 0) or \
                    ((motif[ii] > 0) == (motif[i0] > 0) and shift_l[ii] < shift_l[i0]):
                kept[-1] = ii
            continue
        kept.append(ii)

    # return canonical junctions to original loci, re-sort by (start,end)
    kept = np.array(kept, dtype=np.int64)
    s2 = S[kept] + np.where(motif[kept] == 0, 0, shift_l[kept])
    e2 = E[kept] + np.where(motif[kept] == 0, 0, shift_l[kept])
    order2 = np.lexsort((np.arange(len(kept)), e2, s2))

    # resolve same-locus opposite-strand collisions
    out_idx: List[int] = []
    out_s: List[int] = []
    out_e: List[int] = []
    out_strand: List[int] = []
    for oi in order2:
        ii = int(kept[oi])
        s, e = int(s2[oi]), int(e2[oi])
        str_c = sjdb.str_[ii]
        if out_s and out_s[-1] == s and out_e[-1] == e:
            i0 = out_idx[-1]
            if prio[ii] < prio[i0]:
                continue
            elif prio[ii] > prio[i0]:
                out_idx.pop(); out_s.pop(); out_e.pop(); out_strand.pop()
            elif out_strand[-1] > 0 and str_c == ".":
                continue
            elif out_strand[-1] == 0 and str_c != ".":
                out_idx.pop(); out_s.pop(); out_e.pop(); out_strand.pop()
            elif motif[out_idx[-1]] == 0 and motif[ii] == 0:
                out_strand[-1] = 0
                continue
            elif (motif[out_idx[-1]] > 0 and motif[ii] == 0) or \
                    (motif[out_idx[-1]] % 2 == 2 - out_strand[-1]):
                continue
            else:
                out_idx.pop(); out_s.pop(); out_e.pop(); out_strand.pop()
        if str_c == "+":
            strand = 1
        elif str_c == "-":
            strand = 2
        else:
            strand = 0 if motif[ii] == 0 else 2 - int(motif[ii]) % 2
        out_idx.append(ii)
        out_s.append(s)
        out_e.append(e)
        out_strand.append(strand)

    idx = np.array(out_idx, dtype=np.int64)
    res = {
        "start": np.array(out_s, dtype=np.int64),
        "end": np.array(out_e, dtype=np.int64),
        "motif": motif[idx].astype(np.int8),
        "shift_left": shift_l[idx].astype(np.int8),
        "shift_right": shift_r[idx].astype(np.int8),
        "strand": np.array(out_strand, dtype=np.int8),
    }
    # donor/acceptor template coordinates (non-canonical shifted back)
    overhang = gi.sjdb_overhang
    d = res["start"] - overhang
    a = res["end"] + 1
    nc = res["motif"] == 0
    d = d + np.where(nc, res["shift_left"], 0)
    a = a + np.where(nc, res["shift_left"], 0)
    res["dstart"] = d
    res["astart"] = a
    return res


def write_sjdb_files(res, gi, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    overhang = gi.sjdb_overhang
    strand_char = ".+-"
    with open(os.path.join(out_dir, "sjdbInfo.txt"), "w") as f:
        f.write(f"{len(res['start'])}\t{overhang}\n")
        for i in range(len(res["start"])):
            f.write(f"{res['start'][i]}\t{res['end'][i]}\t{res['motif'][i]}\t"
                    f"{res['shift_left'][i]}\t{res['shift_right'][i]}\t{res['strand'][i]}\n")
    with open(os.path.join(out_dir, "sjdbList.out.tab"), "w") as f:
        for i in range(len(res["start"])):
            s, e = int(res["start"][i]), int(res["end"][i])
            sh = int(res["shift_left"][i]) if res["motif"][i] == 0 else 0
            ci = int(gi.chr_bin[s >> gi.chr_bin_nbits])
            cs = int(gi.chr_start[ci])
            f.write(f"{gi.chr_name[ci]}\t{s - cs + 1 + sh}\t{e - cs + 1 + sh}\t"
                    f"{strand_char[res['strand'][i]]}\n")


def _insert_or_rebuild_sa(gi, t2_new, n_real):
    """SA over the junction-extended text: incremental rank-merge of the new
    sj-region suffixes into the pristine index's SA when possible (reference
    sjdbBuildIndex.cpp:52-88), full re-sort otherwise.

    Old rows stay validly ordered in the new text because (a) forward
    positions < n_real are unchanged, (b) revcomp(G) positions shift by
    2*L_sj but keep identical suffix content (revcomp(G) remains the final
    text segment), and (c) suffixes never read across region boundaries —
    chromosome-bin spacer padding terminates comparison first.  The one
    unguarded corner is a chromosome ending flush on a bin boundary (no
    padding spacer), where forward suffixes near the genome end could read
    into the (changed) following region: fall back to the full re-sort."""
    from .native import sa_insert_positions
    n0 = len(gi.t2) // 2 if gi.sjdb_n == 0 else -1
    bin_n = np.int64(1) << gi.chr_bin_nbits
    flush = bool((np.asarray(gi.chr_length) % bin_n == 0).any())
    n1 = len(t2_new) // 2
    if (n0 == n_real and not flush and len(gi.sa) and n1 > n0):
        l_sj = n1 - n0
        # new suffixes: forward sj region [n0, n1) + revcomp(sj) [n1, n1+L)
        cand = np.concatenate([np.arange(n0, n1), np.arange(n1, n1 + l_sj)])
        cand = cand[t2_new[cand] < 4]
        # the old SA is consumed as-is (memmap-safe): positions >= n0 are
        # shifted into new-text coordinates inside the native comparator
        # and during the streamed rank merge
        old = gi.sa if isinstance(gi.sa, np.memmap) \
            else np.ascontiguousarray(gi.sa, dtype=np.int64)
        sa = sa_insert_positions(t2_new, old, cand, thresh=n0,
                                 shift=2 * l_sj)
        if sa is not None:
            return sa
    return sort_suffixes(t2_new)


def insert_junctions(gi, sjdb: SjdbLoci, P, out_dir: str = None):
    """prepare junctions + rebuild index on the junction-extended genome;
    returns a new GenomeIndex."""
    from .index import GenomeIndex
    if gi.sa_sparse_d > 1:
        raise SystemExit(
            "EXITING because of fatal PARAMETERS error: on-the-fly junction "
            "insertion into a sparse suffix array (--genomeSAsparseD > 1) is "
            "not supported\n"
            "SOLUTION: generate the genome index with --sjdbGTFfile / "
            "--sjdbFileChrStartEnd at genomeGenerate time with "
            "--genomeSAsparseD 1, or map without mapping-time sjdb options")
    n_real = int(gi.chr_start[-1])
    res = sjdb_prepare(sjdb, gi, n_real, out_dir)
    if out_dir:
        write_sjdb_files(res, gi, out_dir)

    overhang = gi.sjdb_overhang
    sj_len = 2 * overhang + 1
    n_sj = len(res["start"])
    G2 = np.full(n_real + n_sj * sj_len, 5, dtype=np.int8)
    G2[:n_real] = gi.G[:n_real]
    for i in range(n_sj):
        base = n_real + i * sj_len
        G2[base:base + overhang] = gi.G[res["dstart"][i]:res["dstart"][i] + overhang]
        G2[base + overhang:base + 2 * overhang] = gi.G[res["astart"][i]:res["astart"][i] + overhang]
        # position base+2*overhang stays the spacer separator

    t2 = build_t2(G2)
    sa = _insert_or_rebuild_sa(gi, t2, n_real)
    sai = build_sai(t2, sa, gi.sa_index_nbases)
    return GenomeIndex(
        G=G2, t2=t2, sa=sa,
        sai_level_start=sai["level_start"], sai_val=sai["val"],
        sai_absent=sai["absent"], sai_nbit=sai["nbit"],
        chr_name=list(gi.chr_name), chr_start=gi.chr_start.copy(),
        chr_length=gi.chr_length.copy(), chr_bin_nbits=gi.chr_bin_nbits,
        sa_index_nbases=gi.sa_index_nbases, sa_sparse_d=gi.sa_sparse_d,
        sjdb_n=n_sj, sj_gstart=n_real, sjdb_overhang=overhang,
        sj_dstart=res["dstart"], sj_astart=res["astart"],
        sjdb_start=res["start"], sjdb_end=res["end"], sjdb_motif=res["motif"],
        sjdb_shift_left=res["shift_left"], sjdb_shift_right=res["shift_right"],
        sjdb_strand=res["strand"])


def insert_junctions_from_annotations(gi, P, out_dir: str = None, ann=None):
    """genomeGenerate-time sjdb insertion from GTF and/or tab files.
    `ann` overrides GTF parsing with pre-built (e.g. genome-transformed)
    annotation loci (reference: Genome_transformGenome.cpp transformExonLoci)."""
    gi.sjdb_overhang = P.sjdbOverhang
    sjdb = SjdbLoci()
    if P.sjdbFileChrStartEnd[0] != "-":
        for path in P.sjdbFileChrStartEnd:
            load_sjdb_file(path, sjdb, priority=10)
    if ann is not None:
        transcript_gene_sj(ann, gi, out_dir or P.genomeDir, sjdb)
    elif P.sjdbGTFfile != "-":
        ann = parse_gtf(P.sjdbGTFfile, gi, P)
        transcript_gene_sj(ann, gi, out_dir or P.genomeDir, sjdb)
    return insert_junctions(gi, sjdb, P, out_dir or P.genomeDir)


def load_sjdb_file(path: str, sjdb: SjdbLoci, priority: int = 0):
    """--sjdbFileChrStartEnd / pass-1 SJ.out.tab format: chr start end [strand]
    (reference: sjdbLoadFromStream.cpp)"""
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            sjdb.chr.append(parts[0])
            sjdb.start.append(int(parts[1]))
            sjdb.end.append(int(parts[2]))
            st = parts[3] if len(parts) > 3 else "."
            if st in ("+", "-"):
                sjdb.str_.append(st)
            elif st in ("1",):
                sjdb.str_.append("+")
            elif st in ("2",):
                sjdb.str_.append("-")
            else:
                sjdb.str_.append(".")
            sjdb.gene.append(set())
            sjdb.priority.append(priority)
    return sjdb
