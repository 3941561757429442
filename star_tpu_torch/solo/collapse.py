"""Per-CB UMI collapse: all dedup types, UMI filtering, multimappers.

Reference behavior: source/SoloFeature_collapseUMIall.cpp (per-gene exact
collapse + dedup dispatch + MultiGeneUMI filters + multi-gene read
distribution Uniform/Rescue/PropUnique/EM), source/SoloFeature_collapseUMI_Graph.cpp
(1MM_All two-pass low/high-half graph coloring), umiArrayCorrect_CR /
umiArrayCorrect_Directional (SoloFeature_collapseUMIall.cpp:580-657).

The reference mutates one umiArray through a fixed call sequence (CR, then
Directional, then Directional_UMItools, then All); each call re-sorts the
array with glibc qsort (mergesort, stable).  We replicate that statefully so
tie orders are bit-identical.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

GENE_MULT_MARK = 1 << 31  # SoloCommon.h:24
UMI_MARK_NO = (1 << 32) - 1

# UMIdedup type ids (ParametersSolo.h:19-20)
DEDUP_NAMES = ["NoDedup", "Exact", "1MM_All", "1MM_Directional", "1MM_CR",
               "1MM_Directional_UMItools"]
D_NODEDUP, D_EXACT, D_ALL, D_DIRECTIONAL, D_CR, D_DIR_UMITOOLS = range(6)

# MultiMappers type ids (ParametersSolo.h:48-49)
MULTI_NAMES = ["Unique", "Uniform", "Rescue", "PropUnique", "EM"]
M_UNIQUE, M_UNIFORM, M_RESCUE, M_PROPUNIQUE, M_EM = range(5)


def _is_1mm(x: int) -> bool:
    """xor confined to a single 2-bit base slot (reference __builtin_ctz idiom)"""
    return (x >> ((((x & -x).bit_length() - 1) >> 1) << 1)) <= 3


class DedupConf:
    """mirror of pSolo.umiDedup + umiFiltering + multiMap configuration"""

    def __init__(self, dedup_in: List[str], umi_filtering: str,
                 multimappers: List[str], umi_len: int):
        for t in dedup_in:
            if t not in DEDUP_NAMES:
                raise SystemExit(
                    f"EXITING because of fatal PARAMETERS error: unrecognized "
                    f"option --soloUMIdedup = {t}\nSOLUTION: use allowed "
                    f"values: {' '.join(DEDUP_NAMES)}")
        for t in multimappers:
            if t not in MULTI_NAMES:
                raise SystemExit(
                    f"EXITING because of fatal PARAMETERS error: unrecognized "
                    f"option --soloMultiMappers = {t}\nSOLUTION: use allowed "
                    f"values: {' '.join(MULTI_NAMES)}")
        if umi_filtering not in ("-", "MultiGeneUMI", "MultiGeneUMI_All",
                                 "MultiGeneUMI_CR"):
            raise SystemExit(
                "EXITING because of fatal PARAMETERS error: unrecognized "
                f"option --soloUMIfiltering = {umi_filtering}\nSOLUTION: use "
                "allowed options: - or MultiGeneUMI or MultiGeneUMI_All or "
                "MultiGeneUMI_CR")
        if umi_filtering == "MultiGeneUMI_CR" and dedup_in != ["1MM_CR"]:
            raise SystemExit(
                "EXITING because of fatal PARAMETERS error: --soloUMIfiltering "
                "MultiGeneUMI_CR only works with --soloUMIdedup 1MM_CR\n"
                "SOLUTION: rerun with --soloUMIfiltering MultiGeneUMI_CR "
                "--soloUMIdedup 1MM_CR")
        self.types = [DEDUP_NAMES.index(t) for t in dedup_in]
        self.yes = [False] * 6
        self.count_ind = [0] * 6
        for i, t in enumerate(self.types):
            self.yes[t] = True
            self.count_ind[t] = i + 1
        self.n_dedup = len(self.types)
        self.type_main = self.types[0]
        self.count_ind_main = 1
        self.mg_umi = umi_filtering == "MultiGeneUMI"
        self.mg_umi_all = umi_filtering == "MultiGeneUMI_All"
        self.mg_umi_cr = umi_filtering == "MultiGeneUMI_CR"
        self.multi_types = [MULTI_NAMES.index(t) for t in multimappers
                            if t != "Unique"]
        self.multi_yes = len(self.multi_types) > 0
        self.multi_count_ind = [0] * 5
        ind1 = 1
        for t in self.multi_types:
            self.multi_count_ind[t] = ind1
            ind1 += self.n_dedup
        # countMatMult stride (SoloFeature_countCBgeneUMI.cpp:97)
        self.mult_stride = 1 + len(self.multi_types) * self.n_dedup
        self.umi_l_bits = umi_len  # low-half mask bits (ParametersSolo.cpp:291)
        self.umi_mask_low = (1 << umi_len) - 1


class _UmiArray:
    """stateful umiArray: entries [umi, count, corrected]; the reference
    re-sorts the same array per dedup call with stable qsort."""

    def __init__(self, entries: List[List[int]]):
        self.a = entries  # after exact collapse: sorted by umi ascending

    def correct_cr(self, record_corr: bool, n_umi_yes: bool,
                   corr: Dict[int, int]) -> int:
        a = self.a
        a.sort(key=lambda e: (e[1], e[0]))  # funCompareSolo1: count, then umi
        n = len(a)
        for i in range(n):
            a[i][2] = a[i][0]
            for j in range(n - 1, i, -1):
                x = a[i][0] ^ a[j][0]
                if _is_1mm(x):
                    a[i][2] = a[j][0]
                    break
        if record_corr:
            for e in a:
                if e[0] != e[2]:
                    corr[e[0]] = e[2]
        if not n_umi_yes:
            return 0
        return len({e[2] for e in a})

    def correct_directional(self, record_corr: bool, corr: Dict[int, int],
                            dir_count_add: int) -> int:
        a = self.a
        a.sort(key=lambda e: -e[1])  # count descending, stable
        for e in a:
            e[2] = e[0]
        for i in range(1, len(a)):
            for j in range(i):
                x = a[i][0] ^ a[j][0]
                if _is_1mm(x) and a[j][1] >= 2 * a[i][1] + dir_count_add:
                    a[i][2] = a[j][2]  # chained correction
                    break
        if record_corr:
            for e in a:
                if e[0] != e[2]:
                    corr[e[0]] = e[2]
        return len({e[2] for e in a})

    def correct_graph(self, record_corr: bool, corr: Dict[int, int],
                      conf: DedupConf) -> int:
        """1MM_All: two-pass (low-half, then swapped-halves) adjacency scan
        with graph coloring (collapseUMI_Graph.cpp)."""
        a = self.a
        n_u0 = len(a)
        n_u1 = n_u0
        n_c = 0
        graph_conn: List[Tuple[int, int]] = []
        for e in a:
            e[2] = UMI_MARK_NO  # color slot
        bit_top = 1 << 31
        mask = bit_top - 1

        def scan():
            nonlocal n_u1, n_c
            for i in range(len(a)):
                for j in range(i + 1, len(a)):
                    x = a[i][0] ^ a[j][0]
                    if x > conf.umi_mask_low:
                        break
                    if not _is_1mm(x):
                        continue
                    ci, cj = a[i][2], a[j][2]
                    if ci == UMI_MARK_NO and cj == UMI_MARK_NO:
                        a[i][2] = a[j][2] = n_c
                        n_c += 1
                        n_u1 -= 2
                    elif ci == UMI_MARK_NO:
                        a[i][2] = cj
                        n_u1 -= 1
                    elif cj == UMI_MARK_NO:
                        a[j][2] = ci
                        n_u1 -= 1
                    elif ci != cj:
                        graph_conn.append((ci, cj))
                    # UMI-tools directional marks (mutate counts' top bit)
                    if (a[j][1] & bit_top) == 0 and (a[i][1] & mask) > 2 * (a[j][1] & mask) - 1:
                        a[j][1] |= bit_top
                    elif (a[i][1] & bit_top) == 0 and (a[j][1] & mask) > 2 * (a[i][1] & mask) - 1:
                        a[i][1] |= bit_top

        a.sort(key=lambda e: e[0])
        scan()
        shift = conf.umi_l_bits
        low = conf.umi_mask_low
        for e in a:
            e[0] = ((e[0] & low) << shift) | (e[0] >> shift)
        a.sort(key=lambda e: e[0])
        scan()

        # connected components over colors (graphNumberOfConnectedComponents)
        comp = [UMI_MARK_NO] * n_c
        edges: List[List[int]] = [[] for _ in range(n_c)]
        for (u, v) in graph_conn:
            edges[u].append(v)
            edges[v].append(u)
        n_comp = 0
        for ii in range(n_c):
            if not edges[ii]:
                n_comp += 1
            elif comp[ii] == UMI_MARK_NO:
                n_comp += 1
                comp[ii] = ii
                stack = [ii]
                while stack:
                    u = stack.pop()
                    for v in edges[u]:
                        if comp[v] == UMI_MARK_NO:
                            comp[v] = comp[u]
                            stack.append(v)
        if graph_conn:
            n_u1 += n_comp
        else:
            n_u1 += n_c

        if record_corr:
            for ii in range(n_c):
                if comp[ii] == UMI_MARK_NO:
                    comp[ii] = ii
            umi_best: Dict[int, Tuple[int, int]] = {}
            umi_corr_color: Dict[int, int] = {}
            for e in a:  # iteration in swapped-sorted order
                e[0] = ((e[0] & low) << shift) | (e[0] >> shift)  # restore
                if e[2] == UMI_MARK_NO:
                    continue
                color1 = comp[e[2]]
                count1 = e[1] & mask
                if color1 not in umi_best or umi_best[color1][0] < count1:
                    umi_best[color1] = (count1, e[0])
                umi_corr_color[e[0]] = color1
            for e in a:
                if e[0] in umi_corr_color:
                    corr[e[0]] = umi_best[umi_corr_color[e[0]]][1]
        else:
            for e in a:
                e[0] = ((e[0] & low) << shift) | (e[0] >> shift)
        return n_u1


def collapse_cb(records: List[Tuple[int, int, int]], conf: DedupConf,
                read_info_yes: bool):
    """collapse one CB (reference SoloFeature::collapseUMIperCB).

    records: (gene, umi, iread) in input order; multimapper alignments carry
    GENE_MULT_MARK in gene.  Returns (rows, n_gene, n_umi, read_info,
    mult_rows) where rows = [gene, count_dedup1, ...]; read_info maps
    iread -> corrected umi (or UMI_MARK_NO); mult_rows mirrors countMatMult.
    """
    rec = sorted(records, key=lambda r: r[0])  # by gene (incl. mult mark)
    read_info: Dict[int, int] = {}

    # gene boundaries
    genes: List[Tuple[int, int, int]] = []  # (gid, start, end) in rec
    i = 0
    n_genes_mult = 0
    while i < len(rec):
        j = i
        while j < len(rec) and rec[j][0] == rec[i][0]:
            j += 1
        genes.append((rec[i][0], i, j))
        if conf.multi_yes and (rec[i][0] & GENE_MULT_MARK):
            n_genes_mult += 1
        i = j
    n_genes = len(genes) - n_genes_mult
    uniq_end = genes[n_genes - 1][2] if n_genes > 0 else 0

    umi_gene_count: Dict[int, Dict[int, int]] = {}
    umi_gene_count0: Dict[int, Dict[int, int]] = {}
    if conf.mg_umi:
        for (g, u, r) in rec[:uniq_end]:
            umi_gene_count.setdefault(u, {})
            umi_gene_count[u][g] = umi_gene_count[u].get(g, 0) + 1
        for u, gc in umi_gene_count.items():
            if len(gc) == 1:
                continue
            maxu = max(gc.values())
            if maxu == 1:
                maxu = 2
            for g in gc:
                if gc[g] < maxu:
                    gc[g] = 0
    if conf.mg_umi_all:
        for (g, u, r) in rec[:uniq_end]:
            umi_gene_count.setdefault(u, {})
            umi_gene_count[u][g] = umi_gene_count[u].get(g, 0) + 1
        for u, gc in umi_gene_count.items():
            if len(gc) > 1:
                for g in gc:
                    gc[g] = 0

    rows: List[List[int]] = []
    n_gene_cb = 0
    n_umi_cb = 0
    umi_corrected: List[Dict[int, int]] = [dict() for _ in range(n_genes)]
    cr_gene_counts = None

    for ig in range(n_genes):
        gid, i0, i1 = genes[ig]
        grec = sorted(rec[i0:i1], key=lambda r: r[1])  # by UMI
        # exact collapse
        entries: List[List[int]] = []
        marked: List[Tuple[int, int, int]] = []  # records after MG-UMI filter
        for (g, u, r) in grec:
            # NOTE: the reference gates this skip on .MultiGeneUMI only; the
            # MultiGeneUMI_All kill-map affects only the multimapper rescue
            # below (collapseUMIall.cpp:116 vs :79-90) — replicated as-is.
            if conf.mg_umi and umi_gene_count.get(u, {}).get(gid, 1) == 0:
                if conf.type_main != D_NODEDUP:
                    marked.append((g, UMI_MARK_NO, r))
                else:
                    marked.append((g, u, r))
                continue
            marked.append((g, u, r))
            if entries and entries[-1][0] == u:
                entries[-1][1] += 1
            else:
                entries.append([u, 1, 0])
        n_r0 = len(grec)
        n_u0 = len(entries)
        ua = _UmiArray(entries)

        if conf.mg_umi_cr:
            if n_u0 == 0:
                continue
            for (u, c, _) in entries:
                umi_gene_count0.setdefault(u, {})
                umi_gene_count0[u][ig] = umi_gene_count0[u].get(ig, 0) + c
            ua.correct_cr(read_info_yes, False, umi_corrected[ig])
            for (u, c, corr_u) in entries:
                umi_gene_count.setdefault(corr_u, {})
                umi_gene_count[corr_u][ig] = umi_gene_count[corr_u].get(ig, 0) + c
            continue  # readInfo for MultiGeneUMI_CR is filled after the loop

        counts = [0] * conf.n_dedup
        if conf.yes[D_NODEDUP]:
            counts[conf.count_ind[D_NODEDUP] - 1] = n_r0
        if n_u0 > 0:
            if conf.yes[D_EXACT]:
                counts[conf.count_ind[D_EXACT] - 1] = n_u0
            if conf.yes[D_CR]:
                counts[conf.count_ind[D_CR] - 1] = ua.correct_cr(
                    read_info_yes and conf.type_main == D_CR, True,
                    umi_corrected[ig])
            if conf.yes[D_DIRECTIONAL]:
                counts[conf.count_ind[D_DIRECTIONAL] - 1] = ua.correct_directional(
                    read_info_yes and conf.type_main == D_DIRECTIONAL,
                    umi_corrected[ig], 0)
            if conf.yes[D_DIR_UMITOOLS]:
                counts[conf.count_ind[D_DIR_UMITOOLS] - 1] = ua.correct_directional(
                    read_info_yes and conf.type_main == D_DIR_UMITOOLS,
                    umi_corrected[ig], -1)
            if conf.yes[D_ALL]:
                counts[conf.count_ind[D_ALL] - 1] = ua.correct_graph(
                    read_info_yes and conf.type_main == D_ALL,
                    umi_corrected[ig], conf)
        if sum(counts) > 0:
            rows.append([gid] + counts)
            n_gene_cb += 1
            n_umi_cb += counts[conf.count_ind_main - 1]
        if read_info_yes:
            for (g, u, r) in marked:
                cu = u
                if cu in umi_corrected[ig] and cu != UMI_MARK_NO:
                    cu = umi_corrected[ig][cu]
                read_info[r] = cu

    if conf.mg_umi_cr:
        cr_gene_counts = [0] * n_genes
        gene_umi_hash: List[set] = [set() for _ in range(n_genes)]
        for u, gc in umi_gene_count.items():
            maxu, maxg = 0, -1
            for g, c in gc.items():
                if c > maxu:
                    maxu, maxg = c, g
                elif c == maxu:
                    maxg = -1
            if maxg == -1:
                continue
            for g, c in umi_gene_count0.get(u, {}).items():
                if c > umi_gene_count0[u].get(maxg, 0):
                    maxg = -1
                    break
            if maxg != -1:
                cr_gene_counts[maxg] += 1
                if read_info_yes:
                    gene_umi_hash[maxg].add(u)
        for ig in range(n_genes):
            if cr_gene_counts[ig] == 0:
                continue
            gid = genes[ig][0]
            counts = [0] * conf.n_dedup
            counts[conf.count_ind[D_CR] - 1] = cr_gene_counts[ig]
            rows.append([gid] + counts)
            n_gene_cb += 1
            n_umi_cb += cr_gene_counts[ig]
        if read_info_yes:
            for ig in range(n_genes):
                gid, i0, i1 = genes[ig]
                for (g, u, r) in rec[i0:i1]:
                    cu = u
                    if cu in umi_corrected[ig]:
                        cu = umi_corrected[ig][cu]
                    read_info[r] = cu if cu in gene_umi_hash[ig] else UMI_MARK_NO

    # ---------------------------------------------------- multi-gene reads
    mult_rows: List[Tuple[int, List[float]]] = []
    if n_genes_mult > 0:
        mrec = rec[uniq_end:]
        if read_info_yes:
            for (g, u, r) in mrec:
                read_info[r] = u  # no corrections for multi-gene reads
        # sort by UMI, then read, then gene (funCompare_uint32_1_2_0)
        mrec = sorted(mrec, key=lambda r: (r[1], r[2], r[0]))
        umi_genes: List[List[int]] = []
        i = 0
        while i < len(mrec):
            j = i
            while j < len(mrec) and mrec[j][1] == mrec[i][1]:
                j += 1
            if mrec[i][1] not in umi_gene_count:  # skip if seen among uniques
                gene_read_count: Dict[int, int] = {}
                n_rumi = 0
                read_prev = -1
                for (g, u, r) in mrec[i:j]:
                    if r != read_prev:
                        n_rumi += 1
                        read_prev = r
                    g1 = g ^ GENE_MULT_MARK
                    gene_read_count[g1] = gene_read_count.get(g1, 0) + 1
                umi_genes.append([g for g, c in gene_read_count.items()
                                  if c == n_rumi])
            i = j
        genes_m: Dict[int, int] = {}
        for ug in umi_genes:
            for k, g in enumerate(ug):
                if g not in genes_m:
                    genes_m[g] = len(genes_m)
                ug[k] = genes_m[g]
        # genesM is std::map (ordered by gene id): output iteration sorted
        ng = len(genes_m)
        g_uniform = [0.0] * ng
        for ug in umi_genes:
            for g in ug:
                g_uniform[g] += 1.0 / len(ug)

        def unique_counts(ind_dedup: int) -> List[float]:
            ge = [0.0] * ng
            for row in rows:
                if row[0] in genes_m:
                    ge[genes_m[row[0]]] = float(row[1 + ind_dedup])
            return ge

        g_rescue, g_prop, g_em = {}, {}, {}
        for ind_dedup in range(conf.n_dedup):
            if M_RESCUE in conf.multi_types:
                ge_u = unique_counts(ind_dedup)
                ge = [0.0] * ng
                for ug in umi_genes:
                    norm1 = sum(g_uniform[g] + ge_u[g] for g in ug)
                    if norm1 == 0.0:
                        continue
                    norm1 = 1.0 / norm1
                    for g in ug:
                        ge[g] += (g_uniform[g] + ge_u[g]) * norm1
                g_rescue[ind_dedup] = ge
            if M_PROPUNIQUE in conf.multi_types:
                ge_u = unique_counts(ind_dedup)
                ge = [0.0] * ng
                for ug in umi_genes:
                    norm1 = sum(ge_u[g] for g in ug)
                    if norm1 == 0.0:
                        for g in ug:
                            ge[g] += 1.0 / len(ug)
                    else:
                        norm1 = 1.0 / norm1
                        for g in ug:
                            ge[g] += ge_u[g] * norm1
                g_prop[ind_dedup] = ge
            if M_EM in conf.multi_types:
                ge_u = unique_counts(ind_dedup)
                em1 = [g_uniform[k] + ge_u[k] for k in range(ng)]
                em2 = [0.0] * ng
                iter_i = 0
                while True:
                    iter_i += 1
                    em_old, em_new = em1, em2
                    em_new[:] = ge_u
                    for k in range(ng):
                        if em_old[k] < 0.01:
                            em_old[k] = 0.0
                    for ug in umi_genes:
                        if not ug:
                            # a UMI whose reads share no gene adds nothing
                            # (the reference's 1/0 is never used); star_tpu
                            # raises ZeroDivisionError here
                            continue
                        norm1 = sum(em_old[g] for g in ug)
                        norm1 = 1.0 / norm1
                        for g in ug:
                            em_new[g] += em_old[g] * norm1
                    max_change = max((abs(em_new[k] - em_old[k])
                                      for k in range(ng)), default=0.0)
                    if max_change < 0.01 or iter_i > 100:
                        g_em[ind_dedup] = list(em_new)
                        break
                    em1, em2 = em2, em1
                g_em[ind_dedup] = [g_em[ind_dedup][k] - ge_u[k]
                                   for k in range(ng)]

        # write countMatMult rows replicating the reference's write loop
        # (collapseUMIall.cpp:508-533): per gene, gene id at block start,
        # then per dedup a stride-s block with values at countInd offsets.
        for g_orig in sorted(genes_m.keys()):
            gm = genes_m[g_orig]
            block = [0.0] * (conf.mult_stride * conf.n_dedup)
            block[0] = float(g_orig)
            for ind_dedup in range(conf.n_dedup):
                ind1 = ind_dedup * conf.mult_stride + ind_dedup
                if M_UNIFORM in conf.multi_types:
                    _setblock(block, ind1 + conf.multi_count_ind[M_UNIFORM],
                              g_uniform[gm])
                if M_RESCUE in conf.multi_types:
                    _setblock(block, ind1 + conf.multi_count_ind[M_RESCUE],
                              g_rescue[ind_dedup][gm])
                if M_PROPUNIQUE in conf.multi_types:
                    _setblock(block, ind1 + conf.multi_count_ind[M_PROPUNIQUE],
                              g_prop[ind_dedup][gm])
                if M_EM in conf.multi_types:
                    _setblock(block, ind1 + conf.multi_count_ind[M_EM],
                              g_em[ind_dedup][gm])
            mult_rows.append((g_orig, block))

    return rows, n_gene_cb, n_umi_cb, read_info, mult_rows


def _setblock(block: List[float], idx: int, val: float):
    if idx < len(block):
        block[idx] = val
