"""STARsolo per-feature record/count/output pipeline.

Reference behavior: source/SoloReadFeature_record.cpp (per-read temp records
+ record-time stats), source/SoloReadFeature_inputRecords.cpp (CB resolution
incl. multi-match posterior, per-read stats, readInfo), source/
SoloFeature_sumThreads.cpp (detected-CB index), source/SoloFeature_countCBgeneUMI.cpp
(per-CB record arrays + collapse dispatch), source/SoloFeature_countVelocyto.cpp,
source/SoloFeature_cellFiltering.cpp (knee + filtered stats), source/
SoloFeature_outputResults.cpp (mtx/tsv naming incl. umiDedup-*/UniqueAndMult-*),
source/SoloFeature_statsOutput.cpp (Summary.csv, UMIperCellSorted.txt,
CellReads.stats).
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .annotate import (FT_GENE, FT_GENEFULL, FT_GENEFULL_EXONOVERINTRON,
                       FT_GENEFULL_EX50PAS, FT_SJ, FT_TRANSCRIPT3P,
                       FT_VELOCYTO, FEATURE_DIRNAMES, ReadAnnot,
                       extract_splice_junctions)
from .collapse import (DedupConf, GENE_MULT_MARK, UMI_MARK_NO, collapse_cb)

FEAT_STATS = ["noUnmapped", "noNoFeature", "MultiFeature",
              "subMultiFeatureMultiGenomic", "noTooManyWLmatches",
              "noMMtoWLwithoutExact", "yesWLmatch", "yessubWLmatchExact",
              "yessubWLmatch_UniqueFeature", "yesCellBarcodes", "yesUMIs"]

# SoloReadFlagClass bits (SoloCommon.h:32)
FLAG_NAMES = ["cbMatch", "cbPerfect", "cbMMunique", "cbMMmultiple", "genomeU",
              "genomeM", "featureU", "featureM", "exonic", "intronic",
              "exonicAS", "intronicAS", "mito", "countedU", "countedM"]
FLAG = {n: i for i, n in enumerate(FLAG_NAMES)}
N_BITS = len(FLAG_NAMES)

GENEISH = (FT_GENE, FT_GENEFULL, FT_GENEFULL_EXONOVERINTRON, FT_GENEFULL_EX50PAS)


def fmt_g(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)"""
    if math.isnan(x):
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    return f"{x:g}"


def c_round(x: float) -> int:
    """C round(): half away from zero"""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


class SoloReadFeature:
    """per-feature read recorder (reference SoloReadFeature)"""

    def __init__(self, feature_type: int, P, wl_size: int,
                 read_index_yes: bool, read_stats_yes: bool,
                 read_info_yes: bool = False, smart_seq: bool = False):
        self.feature_type = feature_type
        self.smart_seq = smart_seq
        self.read_index_yes = read_index_yes
        self.read_stats_yes = read_stats_yes
        self.read_info_yes = read_info_yes
        self.multi_yes = (len([t for t in P.soloMultiMappers if t != "Unique"]) > 0
                          and feature_type in GENEISH)
        self.stats = dict.fromkeys(FEAT_STATS, 0)
        self.cb_read_count = np.zeros(wl_size, dtype=np.int64)
        self.records: List[tuple] = []   # mirrors the per-thread temp file
        self.t3p_records: List[tuple] = []   # Transcript3p (cb, umi, [(tr,d)])
        self.transcript_dist_count = np.zeros(10000, dtype=np.int64) \
            if feature_type == FT_TRANSCRIPT3P else None
        self.flag_counts_no_cb = [0] * N_BITS
        self.mito_chrs = {"chrM", "M", "MT", "chrMT"}

    def record(self, annot: ReadAnnot, n_tr: int, transcripts, i_read: int,
               cb_match: int, matches, umi: int, chr_names=None):
        """reference SoloReadFeature::record"""
        ft = self.feature_type
        flag = 0
        if self.read_stats_yes:
            if n_tr == 1:
                flag |= 1 << FLAG["genomeU"]
            elif n_tr > 1:
                flag |= 1 << FLAG["genomeM"]
            if chr_names is not None:
                for itr in range(n_tr):
                    if chr_names[itr] in self.mito_chrs:
                        flag |= 1 << FLAG["mito"]
            ov = annot.ov_type.get(ft, 0)
            if ov in (1, 3):
                flag |= 1 << FLAG["exonic"]
            elif ov == 5:
                flag |= 1 << FLAG["intronic"]
            elif ov in (2, 4):
                flag |= 1 << FLAG["exonicAS"]
            elif ov == 6:
                flag |= 1 << FLAG["intronicAS"]
            if cb_match < 0:
                fset = annot.fset.get(ft, set())
                if len(fset) == 1:
                    flag |= 1 << FLAG["featureU"]
                elif len(fset) > 1:
                    flag |= 1 << FLAG["featureM"]
                flag |= 1 << FLAG["cbMatch"]
                for ib in range(N_BITS):
                    self.flag_counts_no_cb[ib] += (flag >> ib) & 1
        if cb_match < 0:
            return

        ft_local = self.feature_type
        if self.smart_seq and n_tr > 0:
            # SmartSeq pseudo-UMI: (chrStart << 32) | extended length of the
            # last feature-annotated alignment (SoloReadFeature_record.cpp:87-91
            # indAnnotTr + Transcript::chrStartLengthExtended)
            ind = 0
            fal = annot.falign.get(ft_local)
            if fal:
                for itr in range(n_tr - 1, -1, -1):
                    if fal[itr]:
                        ind = itr
                        break
            tr = transcripts[ind]
            start1 = tr.cStart - tr.exons[0][0]
            length1 = (tr.exons[-1][1] + tr.Lread - tr.exons[-1][0]
                       - tr.exons[0][1] + tr.exons[0][0])
            umi = (start1 << 32) | length1

        n_feat = 0
        out: List[tuple] = []
        if n_tr == 0:
            self.stats["noUnmapped"] += 1
        elif ft in GENEISH:
            fset = annot.fset.get(ft, set())
            if len(fset) == 0:
                self.stats["noNoFeature"] += 1
            elif len(fset) > 1:
                self.stats["MultiFeature"] += 1
                flag |= 1 << FLAG["featureM"]
                if n_tr > 1:
                    self.stats["subMultiFeatureMultiGenomic"] += 1
                if self.multi_yes:
                    for g in sorted(fset):
                        out.append((umi, i_read, flag, g | GENE_MULT_MARK,
                                    cb_match, matches))
                    n_feat = len(fset)
            else:
                flag |= 1 << FLAG["featureU"]
                out.append((umi, i_read if self.read_index_yes else None,
                            flag, next(iter(fset)), cb_match, matches))
                n_feat = 1
        elif ft == FT_SJ:
            if n_tr > 1:
                self.stats["subMultiFeatureMultiGenomic"] += 1
                self.stats["MultiFeature"] += 1
            else:
                sj, _ = extract_splice_junctions(transcripts[0])
                if not sj:
                    self.stats["noNoFeature"] += 1
                else:
                    flag |= 1 << FLAG["featureU"]
                    for s in sj:
                        out.append((umi, i_read if self.read_index_yes else None,
                                    flag, s, cb_match, matches))
                    n_feat = len(sj)
        elif ft == FT_TRANSCRIPT3P:
            tc = annot.transcript_concordant
            if len(tc) == 0 or cb_match > 1:
                self.stats["noNoFeature"] += 1
            else:
                self.t3p_records.append((matches[0][0], umi, list(tc)))
                n_feat = 1
            if (len(tc) == 1
                    and tc[0][1] < len(self.transcript_dist_count)):
                # unique-transcript reads feed the 3'-distance distribution
                self.transcript_dist_count[tc[0][1]] += 1
        elif ft == FT_VELOCYTO:
            if annot.tr_velocyto:
                tv = sorted(annot.tr_velocyto, key=lambda t: t[0])
                out.append((i_read, tv))
                n_feat = 1
            else:
                self.stats["noNoFeature"] += 1

        if n_feat == 0 and (self.read_info_yes or self.read_stats_yes):
            # no feature but readInfo/readStats requested: feature=-1 record
            out.append((umi, i_read, flag, -1, cb_match, matches))
        self.records.extend(out)
        if n_feat == 0:
            return
        for cbi in {m[0] for m in matches} if cb_match > 1 else [matches[0][0]]:
            self.cb_read_count[cbi] += n_feat


class SoloFeatureProc:
    """post-mapping per-feature counting (reference SoloFeature); device:
    where EmptyDrops_CR's Monte-Carlo null runs"""

    def __init__(self, feature_type: int, P, conf: DedupConf, trm, bc,
                 read_feat: SoloReadFeature, read_info_yes: bool,
                 device="cpu"):
        self.ft = feature_type
        self.device = device
        self.P = P
        self.conf = conf
        self.trm = trm
        self.bc = bc          # SoloBarcodes (whitelist + exact counts)
        self.rf = read_feat
        self.read_info_yes = read_info_yes
        self.read_info: Dict[int, Tuple[int, int]] = {}  # iread -> (cb, umi)
        self.flag_counts: "OrderedDict[int, List[int]]" = None
        self.sj_all: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.features_number = (len(getattr(trm, "gene_id", []))
                                if feature_type != FT_SJ else 0)

    # ------------------------------------------------------------ sumThreads
    def sum_threads(self):
        wl_size = self.bc.wl_size
        cnt = self.rf.cb_read_count
        self.n_cb = int(np.count_nonzero(cnt > 0))
        self.n_reads_mapped = int(cnt[cnt > 0].sum())
        self.ind_cb = np.flatnonzero(cnt > 0)
        self.ind_cb_wl = np.full(wl_size, -1, dtype=np.int64)
        self.ind_cb_wl[self.ind_cb] = np.arange(self.n_cb)

    # --------------------------------------------------------- countCBgeneUMI
    def count_cb_gene_umi(self):
        """inputRecords + collapse (reference countCBgeneUMI + collapseUMIall)"""
        P = self.P
        conf = self.conf
        stats = self.rf.stats
        exact = self.bc.cb_read_count_exact
        if self.ft == FT_SJ:
            self.features_number = len(self.sj_all[0])

        per_cb: Dict[int, List[Tuple[int, int, int]]] = {int(c): [] for c in self.ind_cb}
        n_read_unique = np.zeros(self.bc.wl_size, dtype=np.int64)
        n_read_multi = np.zeros(self.bc.wl_size, dtype=np.int64)
        from collections import OrderedDict
        flag_counts = OrderedDict()
        prev_iread = None

        for rec in self.rf.records:
            (umi, iread, flag, feature, cb_match, matches) = rec
            if isinstance(feature, tuple):  # SJ (start, gap) -> index
                i = int(np.searchsorted(self.sj_all[0], feature[0]))
                feat = -1
                while i < len(self.sj_all[0]) and self.sj_all[0][i] == feature[0]:
                    if self.sj_all[1][i] == feature[1]:
                        feat = i
                        break
                    i += 1
                feature = feat
            if feature == -1 and not self.rf.read_index_yes:
                continue
            feat_good = feature != -1
            read_counted = False
            no_mm_without_exact = False
            no_too_many = False
            cb = -1
            if cb_match <= 1:
                cb = matches[0][0]
                if (self.bc.one_exact and cb_match == 1 and exact[cb] == 0):
                    no_mm_without_exact = True
                else:
                    if feat_good:
                        read_counted = True
                        per_cb[cb].append((feature, umi, iread if iread is not None else 0))
                    elif self.read_info_yes:
                        self.read_info[iread] = (cb, umi)
            else:
                ptot = np.float32(0.0)
                pmax = np.float32(0.0)
                for (cbin, qin) in matches:
                    if exact[cbin] > 0:
                        qv = min(ord(qin) - 33, 33)
                        pin = np.float32(float(exact[cbin]) * (10.0 ** (-qv / 10.0)))
                        ptot += pin
                        if pin > pmax:
                            cb = cbin
                            pmax = pin
                if float(ptot) > 0.0 and float(pmax) >= 0.975 * float(ptot):
                    if feat_good:
                        read_counted = True
                        per_cb[cb].append((feature, umi, iread if iread is not None else 0))
                    elif self.read_info_yes:
                        self.read_info[iread] = (cb, umi)
                else:
                    no_too_many = True

            if not self.rf.read_index_yes or iread != prev_iread:
                prev_iread = iread
                if feat_good:
                    if cb_match == 0:
                        stats["yessubWLmatchExact"] += 1
                    elif no_mm_without_exact:
                        stats["noMMtoWLwithoutExact"] += 1
                    elif no_too_many:
                        stats["noTooManyWLmatches"] += 1
                if read_counted:
                    if feature < GENE_MULT_MARK:
                        n_read_unique[cb] += 1
                    else:
                        n_read_multi[cb] += 1
                if self.rf.read_stats_yes:
                    if read_counted:
                        if (flag >> FLAG["featureU"]) & 1:
                            flag |= 1 << FLAG["countedU"]
                        if (flag >> FLAG["featureM"]) & 1:
                            flag |= 1 << FLAG["countedM"]
                    flag |= 1 << FLAG["cbMatch"]
                    if cb_match == 0:
                        flag |= 1 << FLAG["cbPerfect"]
                        self._counts_add(flag_counts, cb, flag)
                    elif cb_match == 1 and not no_mm_without_exact:
                        flag |= 1 << FLAG["cbMMunique"]
                        self._counts_add(flag_counts, cb, flag)
                    elif cb_match > 1 and not no_too_many:
                        flag |= 1 << FLAG["cbMMmultiple"]
                        self._counts_add(flag_counts, cb, flag)
                    else:
                        for ib in range(N_BITS):
                            self.rf.flag_counts_no_cb[ib] += (flag >> ib) & 1
        self.flag_counts = flag_counts

        self.n_read_per_cb_unique = n_read_unique[self.ind_cb]
        self.n_read_per_cb_total = (n_read_unique + n_read_multi)[self.ind_cb]

        # ----------------------------------------------- collapse per CB
        self.count_mat_stride = conf.n_dedup + 1
        self.rows_per_cb: List[List[List[int]]] = []
        self.mult_per_cb: List[List[float]] = []
        self.mult_genes_per_cb: List[List[int]] = []
        self.n_umi_per_cb = np.zeros(self.n_cb, dtype=np.int64)
        self.n_gene_per_cb = np.zeros(self.n_cb, dtype=np.int64)
        for icb in range(self.n_cb):
            cbi = int(self.ind_cb[icb])
            rows, n_gene, n_umi, ri, mult_rows = collapse_cb(
                per_cb[cbi], conf, self.read_info_yes)
            self.rows_per_cb.append(rows)
            flat = []
            mgenes = []
            for (g, block) in mult_rows:
                mgenes.append(g)
                flat.extend(block)
            self.mult_per_cb.append(flat)
            self.mult_genes_per_cb.append(mgenes)
            self.n_umi_per_cb[icb] = n_umi
            self.n_gene_per_cb[icb] = n_gene
            if self.read_info_yes:
                for iread, umi in ri.items():
                    self.read_info[iread] = (cbi, umi)
            stats["yesUMIs"] += n_umi
            if n_gene > 0:
                stats["yesCellBarcodes"] += 1
            stats["yesWLmatch"] += int(self.n_read_per_cb_total[icb])
            stats["yessubWLmatch_UniqueFeature"] += int(self.n_read_per_cb_unique[icb])

    def count_smart_seq(self):
        """SmartSeq per-well counting (reference SoloFeature_countSmartSeq.cpp):
        reads sorted by (feature, pseudo-UMI); NoDedup counts all reads of a
        feature, Exact counts distinct consecutive pseudo-UMIs."""
        from .collapse import DEDUP_NAMES
        from collections import OrderedDict
        conf = self.conf
        stats = self.rf.stats
        per_cb: Dict[int, List[Tuple[int, int]]] = {int(c): [] for c in self.ind_cb}
        for (umi, iread, flag, feature, cb_match, matches) in self.rf.records:
            if feature == -1:
                continue
            per_cb[matches[0][0]].append((int(feature), int(umi)))
        cols = {DEDUP_NAMES[t]: j + 1 for j, t in enumerate(conf.types)}
        self.count_mat_stride = conf.n_dedup + 1
        self.rows_per_cb = []
        self.mult_per_cb = [[] for _ in range(self.n_cb)]
        self.mult_genes_per_cb = [[] for _ in range(self.n_cb)]
        self.n_umi_per_cb = np.zeros(self.n_cb, dtype=np.int64)
        self.n_gene_per_cb = np.zeros(self.n_cb, dtype=np.int64)
        n_read = np.zeros(self.n_cb, dtype=np.int64)
        self.flag_counts = OrderedDict()
        for icb in range(self.n_cb):
            fu = sorted(per_cb[int(self.ind_cb[icb])])
            n_read[icb] = len(fu)
            rows: List[List[int]] = []
            for k, (f, u) in enumerate(fu):
                if k == 0 or f != fu[k - 1][0]:
                    row = [f] + [0] * conf.n_dedup
                    if "NoDedup" in cols:
                        row[cols["NoDedup"]] = 1
                    if "Exact" in cols:
                        row[cols["Exact"]] = 1
                    rows.append(row)
                else:
                    if "NoDedup" in cols:
                        rows[-1][cols["NoDedup"]] += 1
                    if u != fu[k - 1][1] and "Exact" in cols:
                        rows[-1][cols["Exact"]] += 1
            self.rows_per_cb.append(rows)
            self.n_gene_per_cb[icb] = len(rows)
            self.n_umi_per_cb[icb] = sum(r[1] for r in rows)
            stats["yesUMIs"] += int(self.n_umi_per_cb[icb])
            if len(rows) > 0:
                stats["yesCellBarcodes"] += 1
        self.n_read_per_cb_total = n_read
        self.n_read_per_cb_unique = n_read.copy()
        stats["yesWLmatch"] += int(n_read.sum())
        stats["yessubWLmatch_UniqueFeature"] += int(n_read.sum())
        stats["yessubWLmatchExact"] = stats["yesWLmatch"]


    def quant_transcript(self, out_prefix: str, P):
        """Transcript3p quantification: 3'-distance-weighted EM over cell
        clusters (reference SoloFeature_quantTranscript.cpp).  Requires
        --soloClusterCBfile; float evaluation order follows the reference
        (libstdc++ unordered_map node order) for identical output."""
        import math
        from ..utils.stdhash import UnorderedMap
        if P.soloClusterCBfile == "-":
            return
        trm = self.trm
        n_tr = len(trm.tr_id)
        # cluster file: CB sequence, cluster index
        from .solo import encode_bc
        cluster_cb = {}
        cluster_ind = set()
        with open(P.soloClusterCBfile) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                v, pos_n = encode_bc(parts[0])
                if pos_n != -1:
                    continue
                ind = int(np.searchsorted(self.bc.wl, v))
                if ind < len(self.bc.wl) and self.bc.wl[ind] == v:
                    cluster_cb[ind] = int(parts[1])
                    cluster_ind.add(int(parts[1]))

        # distance distribution function: running average, cut at the first
        # minimum past the maximum after index 1000, normalize, log
        cnt = self.rf.transcript_dist_count
        n_cnt = len(cnt)
        fun = [0.0] * n_cnt
        aver_n, aver_start = 50, 0
        for ii in range(aver_start, n_cnt - aver_n - 1):
            a = max(aver_start, ii - aver_n)
            b = ii + aver_n + 1
            fun[ii] = float(int(cnt[a:b].sum())) / min(2 * aver_n + 1,
                                                       ii - aver_start + aver_n)
        imax = 1000
        while fun[imax + 1] > fun[imax]:
            imax += 1
        while fun[imax + 1] < fun[imax]:
            imax += 1
        fun = fun[:imax]
        norm1 = 0.0
        for ff in fun:
            norm1 += ff
        with open(out_prefix + "transcriptEndDistanceDistribution.txt", "w") as f:
            for i in range(len(fun)):
                # C++ double division: 0/0 = nan, x/0 = inf
                if norm1 == 0.0:
                    fun[i] = float("nan") if fun[i] == 0.0 else float("inf")
                else:
                    fun[i] = fun[i] / norm1
                f.write(fmt_g(fun[i]) + "\n")
        cum = [0.0] * len(fun)
        acc = 0.0
        for i, ff in enumerate(fun):
            acc += ff
            cum[i] = acc
        factor = [0.0] * n_tr
        for i in range(n_tr):
            tl = int(trm.tr_length[i])
            if tl < len(cum):
                factor[i] = -math.log(cum[tl - 1])
        fun = [math.log(ff) if ff > 0 else float("-inf") for ff in fun]

        # input records -> per-cluster unordered_map<umi, [(tr, d)]>
        map_tr_dist = {}
        for (cb, umi, tc) in self.rf.t3p_records:
            if cb not in cluster_cb:
                continue
            key = (int(umi) + (int(cb) << 32)) & ((1 << 64) - 1)
            cl = cluster_cb[cb]
            td = []
            for (tr, d) in tc:
                if d >= len(fun):
                    continue
                td.append((int(tr), fun[d] + factor[tr]))
            if not td:
                continue
            td.sort(key=lambda t: t[0])
            if cl not in map_tr_dist:
                map_tr_dist[cl] = UnorderedMap()
            m = map_tr_dist[cl]
            node = m.find(key)
            if node is None:
                m.insert(key, td)
                continue
            old = node.val
            inew = 0
            td1 = []
            for (otr, od) in old:
                while inew < len(td) and otr > td[inew][0]:
                    inew += 1
                if inew == len(td):
                    break
                if otr == td[inew][0]:
                    td1.append((otr, od + td[inew][1]))
            node.val = td1

        cluster_expr = {}
        for cl in sorted(map_tr_dist):
            entries = [(k, v) for k, v in map_tr_dist[cl].items()]
            tr_unique = [0.0] * n_tr
            tr_initial = [0.0] * n_tr
            n_umi_tot = 0
            em = []    # multi-transcript UMIs in node order
            for key, td in entries:
                if len(td) == 0:
                    continue
                if len(td) == 1:
                    tr_unique[td[0][0]] += 1
                    tr_initial[td[0][0]] += 1.0
                    n_umi_tot += 1
                    continue
                max1 = max(d for _, d in td)
                td2 = []
                for (tr, d) in td:
                    tr_initial[tr] += 1.0 / len(td)
                    td2.append((tr, math.exp(d - max1)))
                em.append(td2)
                n_umi_tot += 1

            th_old = list(tr_initial)
            th_new = [0.0] * n_tr
            converged = [False] * n_tr
            for _it in range(10000):
                th_new[:] = tr_unique
                for td in em:
                    denom1 = 0.0
                    for (tr, d) in td:
                        denom1 += d * th_old[tr]
                    for (tr, d) in td:
                        if not converged[tr]:
                            th_new[tr] += d * th_old[tr] / denom1
                diff_max_thr = 1e-5
                diff_one_thr = diff_max_thr * 0.1
                expr_thr = 1e-8 * n_umi_tot
                diff_max = 0.0
                for itr in range(n_tr):
                    if converged[itr] or th_old[itr] == 0:
                        continue
                    diff1 = abs(th_new[itr] - th_old[itr]) / th_old[itr]
                    diff_max = max(diff_max, diff1)
                    if th_new[itr] < expr_thr:
                        converged[itr] = True
                        tr_unique[itr] = 0
                    if diff1 < diff_one_thr:
                        converged[itr] = True
                        tr_unique[itr] = th_new[itr]
                if diff_max < diff_max_thr:
                    break
                th_old, th_new = th_new, th_old
            th_out = th_new
            norm1 = 0.0
            for itr in range(n_tr):
                th_out[itr] *= math.exp(factor[itr])
                norm1 += th_out[itr]
            norm1 = n_umi_tot / norm1 if norm1 else 0.0
            for itr in range(n_tr):
                th_out[itr] *= norm1
            cluster_expr[cl] = list(th_out)

        with open(out_prefix + "matrix.mtx", "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n%\n")
            n_entries = sum(1 for v in cluster_expr.values() for x in v if x > 0)
            f.write(f"{n_tr} {max(cluster_ind) if cluster_ind else 0} "
                    f"{n_entries}\n")
            for cl in sorted(cluster_expr):
                for i, x in enumerate(cluster_expr[cl]):
                    if x > 0:
                        f.write(f"{i + 1} {cl} {fmt_g(x)}\n")
        with open(out_prefix + "features.tsv", "w") as f:
            for i in range(n_tr):
                f.write(f"{trm.tr_id[i]}\t{int(trm.tr_length[i])}\t"
                        f"{trm.gene_name[int(trm.tr_gene[i])]}\n")

    @staticmethod
    def _counts_add(flag_counts, cb, flag):
        if cb not in flag_counts:
            flag_counts[cb] = [0] * N_BITS
        arr = flag_counts[cb]
        for ib in range(N_BITS):
            arr[ib] += (flag >> ib) & 1

    # ----------------------------------------------------------- countVelocyto
    def count_velocyto(self, gene_proc: "SoloFeatureProc"):
        """reference SoloFeature::countVelocyto (uses Gene readInfo)"""
        self.count_mat_stride = 4
        cu: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(self.n_cb)]
        n_read_per_cb = np.zeros(self.n_cb, dtype=np.int64)
        for (iread, tr_types) in self.rf.records:
            info = gene_proc.read_info.get(iread)
            if info is None:
                continue
            cb, umi = info
            if cb == -1 or umi == UMI_MARK_NO:
                continue
            icb = int(self.ind_cb_wl[cb])
            if icb < 0:
                continue
            n_read_per_cb[icb] += 1
            m = cu[icb]
            if umi in m and not m[umi]:
                continue
            if umi not in m:
                m[umi] = list(tr_types)
                continue
            old = m[umi]
            new = tr_types
            inter = []
            inew = 0
            for (tro, tyo) in old:
                while inew < len(new) and tro > new[inew][0]:
                    inew += 1
                if inew == len(new):
                    break
                if tro == new[inew][0]:
                    inter.append((tro, tyo | new[inew][1]))
            m[umi] = inter

        trm = self.trm
        self.n_umi_per_cb = np.zeros(self.n_cb, dtype=np.int64)
        self.n_gene_per_cb = np.zeros(self.n_cb, dtype=np.int64)
        self.rows_per_cb = []
        self.mult_per_cb = [[] for _ in range(self.n_cb)]
        self.mult_genes_per_cb = [[] for _ in range(self.n_cb)]
        stats = self.rf.stats
        for icb in range(self.n_cb):
            gene_c: Dict[int, List[int]] = {}
            for umi, trts in cu[icb].items():
                if not trts:
                    continue
                gene_i = int(trm.tr_gene[trts[0][0]])
                exon_m = intron_m = mixed_m = False
                span_m = True
                multi = False
                for (tr, ty) in trts:
                    if int(trm.tr_gene[tr]) != gene_i:
                        multi = True
                        break
                    has_i = bool(ty & 1)        # AVT_INTRON
                    has_ei = bool(ty & 2)       # AVT_EXON_INTRON
                    has_sp = bool(ty & 4)       # AVT_SPAN
                    has_c = bool(ty & 8)        # AVT_CONCORDANT
                    mixed_m |= ((has_i and has_c) or has_ei) and not has_sp
                    span_m &= has_sp
                    exon_m |= has_c and not has_i and not has_ei
                    intron_m |= has_i and not has_ei and not has_c
                if multi:
                    continue
                if gene_i not in gene_c:
                    gene_c[gene_i] = [0, 0, 0]
                if exon_m and not intron_m and not mixed_m:
                    gene_c[gene_i][0] += 1
                elif span_m or ((intron_m or mixed_m) and not exon_m):
                    gene_c[gene_i][1] += 1
                else:
                    gene_c[gene_i][2] += 1
                self.n_umi_per_cb[icb] += 1
            rows = [[g] + gene_c[g] for g in sorted(gene_c)] \
                if self.n_umi_per_cb[icb] > 0 else []
            self.rows_per_cb.append(rows)
            if self.n_umi_per_cb[icb] == 0:
                continue
            self.n_gene_per_cb[icb] = len(gene_c)
            stats["yesUMIs"] += int(self.n_umi_per_cb[icb])
            stats["yesCellBarcodes"] += 1
        self.n_read_per_cb_total = n_read_per_cb
        self.n_read_per_cb_unique = n_read_per_cb

    # ---------------------------------------------------------- outputResults
    def output_results(self, cell_filter_yes: bool, out_dir: str, P,
                       filt_vec=None):
        """out_dir is a filename PREFIX (reference concatenates; callers pass
        '<dir>/raw/' etc., soloCellFiltering passes a bare prefix)"""
        os.makedirs(os.path.dirname(out_dir + "x") or ".", exist_ok=True)
        trm = self.trm
        # features.tsv
        if self.ft == -1:
            pass  # soloCellFiltering: features.tsv copied verbatim by loader
        elif self.ft == FT_SJ:
            sjout = P.outFileNamePrefix + "SJ.out.tab"
            if not sjout.startswith("/"):
                sjout = os.path.join(os.getcwd(), sjout)
            link = out_dir + "features.tsv"
            if os.path.islink(link) or os.path.exists(link):
                os.remove(link)
            os.symlink(sjout, link)
        else:
            with open(out_dir + "features.tsv", "w") as f:
                for g, n in zip(trm.gene_id, trm.gene_name):
                    f.write(f"{g}\t{n or g}\tGene Expression\n")
        # barcodes.tsv
        n_entries = 0
        with open(out_dir + "barcodes.tsv", "w") as f:
            if cell_filter_yes:
                for icb in range(self.n_cb):
                    if filt_vec[icb]:
                        f.write(self.bc.wl_str[int(self.ind_cb[icb])] + "\n")
                        n_entries += len(self.rows_per_cb[icb])
            else:
                for s in self.bc.wl_str:
                    f.write(s + "\n")
                n_entries = sum(len(r) for r in self.rows_per_cb)
        # count matrices
        conf = self.conf
        for icol in range(1, self.count_mat_stride):
            if self.ft == FT_VELOCYTO:
                name = ["spliced.mtx", "unspliced.mtx", "ambiguous.mtx"][icol - 1]
            elif icol > 1 and cell_filter_yes:
                break
            elif conf.n_dedup > 1:
                from .collapse import DEDUP_NAMES
                name = f"umiDedup-{DEDUP_NAMES[conf.types[icol - 1]]}.mtx"
            else:
                name = "matrix.mtx"
            with open(out_dir + name, "w") as f:
                f.write("%%MatrixMarket matrix coordinate integer general\n%\n")
                ncols = (int(np.count_nonzero(filt_vec[:self.n_cb]))
                         if cell_filter_yes else len(self.bc.wl_str))
                f.write(f"{self.features_number} {ncols} {n_entries}\n")
                cb_ind1 = 0
                for icb in range(self.n_cb):
                    if cell_filter_yes:
                        if filt_vec[icb]:
                            cb_ind1 += 1
                        else:
                            continue
                    else:
                        cb_ind1 = int(self.ind_cb[icb]) + 1
                    for row in self.rows_per_cb[icb]:
                        f.write(f"{row[0] + 1} {cb_ind1} {row[icol]}\n")
        # UniqueAndMult-*.mtx
        if conf.multi_yes and not cell_filter_yes and self.ft in GENEISH:
            self.n_umi_per_cb_multi = np.zeros(self.n_cb, dtype=np.float64)
            self.n_gene_per_cb_multi = np.zeros(self.n_cb, dtype=np.int64)
            fill = True
            from .collapse import MULTI_NAMES, DEDUP_NAMES
            for imult in conf.multi_types:
                for ided in range(conf.n_dedup):
                    name = f"UniqueAndMult-{MULTI_NAMES[imult]}"
                    if conf.n_dedup > 1:
                        name += f"_umiDedup-{DEDUP_NAMES[conf.types[ided]]}"
                    name += ".mtx"
                    m_index = conf.multi_count_ind[imult] + ided
                    lines = []
                    n_ent = 0
                    for icb in range(self.n_cb):
                        cb_ind1 = int(self.ind_cb[icb]) + 1
                        rows = self.rows_per_cb[icb]
                        mflat = self.mult_per_cb[icb]
                        s = conf.mult_stride
                        i1, i2 = 0, 0
                        n2 = len(mflat) // s
                        while i1 < len(rows) or i2 < n2:
                            g1 = rows[i1][0] if i1 < len(rows) else (1 << 62)
                            c1 = rows[i1][1 + ided] if i1 < len(rows) else 0
                            g2 = int(mflat[i2 * s]) if i2 < n2 else (1 << 62)
                            c2 = mflat[i2 * s + m_index] if i2 < n2 else 0.0
                            if g1 < g2:
                                lines.append(f"{g1 + 1} {cb_ind1} {c1}\n")
                                i1 += 1
                            elif g1 > g2:
                                lines.append(f"{g2 + 1} {cb_ind1} {fmt_g(c2)}\n")
                                i2 += 1
                                if fill:
                                    self.n_umi_per_cb_multi[icb] += c2
                                    self.n_gene_per_cb_multi[icb] += 1
                            else:
                                lines.append(f"{g1 + 1} {cb_ind1} {fmt_g(c1 + c2)}\n")
                                i1 += 1
                                i2 += 1
                                if fill:
                                    self.n_umi_per_cb_multi[icb] += c2
                            n_ent += 1
                    fill = False
                    with open(out_dir + name, "w") as f:
                        f.write("%%MatrixMarket matrix coordinate real general\n%\n")
                        f.write(f"{self.features_number} {len(self.bc.wl_str)} {n_ent}\n")
                        f.writelines(lines)

    # ---------------------------------------------------------- cellFiltering
    def cell_filtering(self, P, out_prefix: str,
                       gene_proc: Optional["SoloFeatureProc"] = None):
        """knee / EmptyDrops_CR / TopCells; returns filtVecBool or None"""
        filt = P.soloCellFilter
        if filt[0] == "None" or self.n_cb < 1:
            self.filt_vec = None
            return None
        if self.ft == FT_VELOCYTO:
            filt_vec = np.zeros(self.n_cb, dtype=bool)
            if gene_proc is not None and gene_proc.filt_vec is not None:
                for ic in range(gene_proc.n_cb):
                    if gene_proc.filt_vec[ic]:
                        my = int(self.ind_cb_wl[int(gene_proc.ind_cb[ic])])
                        if my != -1:
                            filt_vec[my] = True
            self.n_umi_sorted = np.sort(self.n_umi_per_cb)[::-1]
        elif self.ft in GENEISH or self.ft == -1:
            self.n_umi_sorted = np.sort(self.n_umi_per_cb)[::-1]
            if filt[0] == "TopCells":
                n_umi_min = int(self.n_umi_sorted[min(self.n_cb - 1, int(filt[1]))])
            else:
                n_expected = int(filt[1]) if len(filt) > 1 else 3000
                max_perc = float(filt[2]) if len(filt) > 2 else 0.99
                max_min_ratio = float(filt[3]) if len(filt) > 3 else 10.0
                maxind = c_round(n_expected * (1.0 - max_perc))
                n_umi_max = int(self.n_umi_sorted[min(self.n_cb - 1, maxind)])
                n_umi_min = c_round(n_umi_max / max_min_ratio)
            n_umi_min = max(n_umi_min, 1)
            filt_vec = self.n_umi_per_cb >= n_umi_min
            if filt[0] == "EmptyDrops_CR":
                from .emptydrops import empty_drops_cr_proc
                filt_vec = empty_drops_cr_proc(self, filt_vec, P)
        else:
            self.filt_vec = None
            return None
        self.filt_vec = filt_vec

        # filtered statistics (reference cellFiltering tail)
        fc = self.filtered_cells = {}
        gene_detected = np.zeros(max(self.features_number, 1), dtype=np.int64)
        n_cells = 0
        n_umi_in = 0
        n_read_u = []
        n_gene_per_cell = []
        n_gene_in = 0
        for icb in range(self.n_cb):
            if not filt_vec[icb]:
                continue
            n_cells += 1
            n_umi_in += int(self.n_umi_per_cb[icb])
            nru = getattr(self, "n_read_per_cb_unique", None)
            n_read_u.append(int(nru[icb]) if nru is not None else 0)
            ng1 = 0
            for row in self.rows_per_cb[icb]:
                if row[self.conf.count_ind_main if self.ft != FT_VELOCYTO else 1] > 0:
                    gene_detected[row[0]] = 1
                    ng1 += 1
            n_gene_in += ng1
            n_gene_per_cell.append(ng1)
        fc["nCells"] = n_cells
        if n_cells == 0:
            self.output_results(True, out_prefix, P, filt_vec)
            return filt_vec
        fc["nUMIinCells"] = n_umi_in
        fc["nReadInCellsUnique"] = sum(n_read_u)
        fc["meanUMIperCell"] = n_umi_in // n_cells
        fc["meanReadPerCellUnique"] = sum(n_read_u) // n_cells
        fc["meanGenePerCell"] = n_gene_in // n_cells
        fc["nGeneDetected"] = int(gene_detected.sum())
        n_read_u.sort()
        n_gene_per_cell.sort()
        fc["medianUMIperCell"] = int(self.n_umi_sorted[n_cells // 2])
        fc["medianGenePerCell"] = n_gene_per_cell[n_cells // 2]
        fc["medianReadPerCellUnique"] = n_read_u[n_cells // 2]
        self.output_results(True, out_prefix, P, filt_vec)
        return filt_vec

    # ------------------------------------------------------------ statsOutput
    def stats_output(self, out_prefix: str, P, run_stats, bar_sum,
                     q30_bc, q30_rna):
        name = FEATURE_DIRNAMES[self.ft]
        st = self.rf.stats
        n = run_stats["readN"]
        lines = [f"Number of Reads,{n}"]
        inval = bar_sum + st["noTooManyWLmatches"] + st["noMMtoWLwithoutExact"]
        lines.append("Reads With Valid Barcodes," +
                     (fmt_g(1.0 - inval / n) if n else "0"))
        denom = st["yessubWLmatch_UniqueFeature"]
        if denom:
            sat = fmt_g(1.0 - st["yesUMIs"] / denom)
        else:  # C double division: x/0 = inf (x>0), 0/0 = -nan
            sat = "-inf" if st["yesUMIs"] > 0 else "-nan"
        lines.append("Sequencing Saturation," + sat)
        if not self.rf.smart_seq:
            lines.append(f"Q30 Bases in CB+UMI,{fmt_g(q30_bc[0] / max(q30_bc[1], 1))}")
        lines.append(f"Q30 Bases in RNA read,{fmt_g(q30_rna[0] / max(q30_rna[1], 1))}")
        lines.append("Reads Mapped to Genome: Unique+Multiple,"
                     + fmt_g(run_stats["mappedUM"] / n))
        lines.append("Reads Mapped to Genome: Unique,"
                     + fmt_g(run_stats["mappedU"] / n))
        if self.conf.multi_yes:
            lines.append(f"Reads Mapped to {name}: Unique+Multiple {name},"
                         + fmt_g(st["yesWLmatch"] / n))
        else:
            lines.append(f"Reads Mapped to {name}: Unique+Multiple {name},NoMulti")
        lines.append(f"Reads Mapped to {name}: Unique {name},"
                     + fmt_g(st["yessubWLmatch_UniqueFeature"] / n))
        if (P.soloCellFilter[0] != "None" and self.ft in GENEISH
                and getattr(self, "filt_vec", None) is not None):
            fc = self.filtered_cells
            lines.append(f"Estimated Number of Cells,{fc['nCells']}")
            if fc["nCells"] > 0:
                lines += [
                    f"Unique Reads in Cells Mapped to {name},{fc['nReadInCellsUnique']}",
                    "Fraction of Unique Reads in Cells,"
                    + fmt_g(fc["nReadInCellsUnique"]
                            / st["yessubWLmatch_UniqueFeature"]),
                    f"Mean Reads per Cell,{fc['meanReadPerCellUnique']}",
                    f"Median Reads per Cell,{fc['medianReadPerCellUnique']}",
                    f"UMIs in Cells,{fc['nUMIinCells']}",
                    f"Mean UMI per Cell,{fc['meanUMIperCell']}",
                    f"Median UMI per Cell,{fc['medianUMIperCell']}",
                    f"Mean {name} per Cell,{fc['meanGenePerCell']}",
                    f"Median {name} per Cell,{fc['medianGenePerCell']}",
                    f"Total {name} Detected,{fc['nGeneDetected']}"]
            with open(out_prefix + "UMIperCellSorted.txt", "w") as f:
                for v in self.n_umi_sorted:
                    if v == 0:
                        break
                    f.write(f"{v}\n")
        with open(out_prefix + "Summary.csv", "w") as f:
            f.write("\n".join(lines) + "\n")
