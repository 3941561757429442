"""EmptyDrops_CR cell calling (CellRanger 3 EmptyDrops adaptation).

Reference behavior: source/SoloFeature_emptyDrops_CR.cpp — ambient profile
from the "true empty" index window via Simple Good-Turing smoothing, sparse
multinomial log-PDF of candidate cells, Monte-Carlo null simulations driven by
std::mt19937 + std::discrete_distribution (both replicated bit-exactly), BH
adjustment, FDR cut.  Floating-point accumulation order mirrors the reference
so p-values match exactly.  The Monte-Carlo null and each candidate's count
of lower simulations run on the job's device (solo/mc_null.py: a CUDA
kernel on the card, its plain PyTorch version on the CPU); the rest stays
on the host.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import mc_null
from .sgt import SGT


def empty_drops_cr_proc(proc, filt_vec, P):
    """adapter for the SoloFeatureProc pipeline: extends the simple-knee
    filter vector with EmptyDrops_CR calls (reference SoloFeature_emptyDrops_CR.cpp)"""
    counts = {}
    n_umi = {}
    for icb in range(proc.n_cb):
        cbi = int(proc.ind_cb[icb])
        counts[cbi] = [(row[0], row[proc.conf.count_ind_main])
                       for row in proc.rows_per_cb[icb]]
        n_umi[cbi] = int(proc.n_umi_per_cb[icb])
    simple = {int(proc.ind_cb[i]) for i in range(proc.n_cb) if filt_vec[i]}
    extra = empty_drops_cr(counts, n_umi, proc.features_number, simple, P,
                           proc.device)
    out = filt_vec.copy()
    for cbi in extra:
        out[int(proc.ind_cb_wl[cbi])] = True
    return out


def empty_drops_cr(counts: Dict[int, List], n_umi_per_cb: Dict[int, int],
                   n_genes_total: int, simple_filtered: set, P,
                   device="cpu") -> set:
    """returns the set of ADDITIONAL cell barcodes called non-ambient; the
    Monte-Carlo null runs on `device`"""
    filt = P.soloCellFilter
    ind_min = int(filt[4]) if len(filt) > 4 else 45000
    ind_max = int(filt[5]) if len(filt) > 5 else 90000
    umi_min = int(filt[6]) if len(filt) > 6 else 500
    umi_min_frac_median = float(filt[7]) if len(filt) > 7 else 0.01
    cand_max_n = int(filt[8]) if len(filt) > 8 else 20000
    fdr = float(filt[9]) if len(filt) > 9 else 0.01
    sim_n = int(filt[10]) if len(filt) > 10 else 10000

    cbs = sorted(counts.keys())
    n_cb = len(cbs)
    if n_cb <= ind_min:
        return set()

    # genes detected in any cell
    feat_det = set()
    for c in cbs:
        for (g, n) in counts[c]:
            if n > 0:
                feat_det.add(g)
    feat_det_n = len(feat_det)

    # cells sorted by (count desc, index asc); "index" is the per-run cell
    # order = ascending barcode index (matches the reference's icb order)
    ind_count = sorted(range(n_cb),
                       key=lambda i: (-n_umi_per_cb[cbs[i]], i))

    # ambient profile from the empty window
    amb_count = [0] * n_genes_total
    for pos in range(ind_min, min(n_cb, ind_max)):
        c = cbs[ind_count[pos]]
        for (g, n) in counts[c]:
            amb_count[g] += n
    amb_freq: Dict[int, int] = {}
    for ac in amb_count:
        amb_freq[ac] = amb_freq.get(ac, 0) + 1
    if len(amb_freq) <= 1:
        return set()
    amb_freq[0] = amb_freq.get(0, 0) - (n_genes_total - feat_det_n)
    max_freq = max(amb_freq.keys())

    sgt = SGT()
    for f, n in sorted(amb_freq.items()):
        if f != 0:
            sgt.add(f, n)
    sgt.analyse()
    amb_sgt = [0.0] * (max_freq + 1)
    for f in range(max_freq + 1):
        found, est = sgt.estimate(f)
        if found:
            amb_sgt[f] = est
    if amb_freq[0]:
        amb_sgt[0] /= amb_freq[0]

    amb_log_p = [0.0] * n_genes_total
    for g in range(n_genes_total):
        if g in feat_det:
            amb_log_p[g] = amb_sgt[amb_count[g]]
    norm1 = math.fsum(amb_log_p) if False else sum(amb_log_p)
    amb_p_non0 = []
    amb_log_p_non0 = []
    for g in range(n_genes_total):
        if amb_log_p[g] > 0:
            amb_log_p[g] /= norm1
            amb_p_non0.append(amb_log_p[g])
            amb_log_p[g] = math.log(amb_log_p[g])
            amb_log_p_non0.append(amb_log_p[g])

    # candidate range
    n_umi_sorted = [n_umi_per_cb[cbs[i]] for i in ind_count]
    n_simple = len(simple_filtered)
    i_first = n_simple
    min_umi = int(umi_min_frac_median * n_umi_sorted[n_simple // 2])
    min_umi = max(umi_min, min_umi)
    i_last = i_first
    while i_last < i_first + cand_max_n:
        if i_last >= n_cb or n_umi_sorted[i_last] < min_umi:
            break
        i_last += 1
    i_last -= 1
    if i_last < i_first:
        return set()

    # observed log-probabilities
    max_count = n_umi_sorted[i_first]
    log_fact = [0.0] * (max_count + 1)
    for cc in range(2, max_count + 1):
        log_fact[cc] = log_fact[cc - 1] + math.log(cc)
    obs_log_prob = []
    for icand in range(i_first, i_last + 1):
        c = cbs[ind_count[icand]]
        sum_count = 0
        sum_log_fac = 0.0
        sum_count_log_p = 0.0
        for (g, n) in counts[c]:
            sum_count += n
            sum_log_fac += log_fact[n]
            sum_count_log_p += amb_log_p[g] * n
        obs_log_prob.append(log_fact[sum_count] - sum_log_fac + sum_count_log_p)

    # Monte-Carlo simulations (mt19937 + libstdc++ discrete_distribution)
    # and each candidate's count of simulations below it, on the device
    from ..ops import pipeline
    with pipeline._tick("solo_mc"):
        psum = sum(amb_p_non0)
        cp = []
        acc = 0.0
        for p in amb_p_non0:
            acc += p / psum
            cp.append(acc)
        n_cand = len(obs_log_prob)
        cand_count = n_umi_sorted[i_first:i_first + n_cand]
        group_count, group_off, obs_sorted, order = \
            mc_null.group_candidates(cand_count, obs_log_prob)
        logtab = [0.0] + [math.log(k) for k in range(1, max_count + 1)]
        f64 = dict(dtype=torch.float64, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        n_lower = np.empty(n_cand, dtype=np.int64)
        n_lower[order] = mc_null.n_lower(
            torch.tensor(cp, **f64), torch.tensor(amb_log_p_non0, **f64),
            torch.tensor(logtab, **f64), torch.tensor(group_count, **i32),
            torch.tensor(group_off, **i32), torch.tensor(obs_sorted, **f64),
            sim_n)
        n_lower = n_lower.tolist()

    # p-values + BH
    pvals = []
    for icand in range(n_cand):
        pvals.append((cbs[ind_count[i_first + icand]],
                      (1 + n_lower[icand]) / (1 + sim_n)))
    pvals.sort(key=lambda t: t[1])
    padj = []
    for rank, (c, p) in enumerate(pvals, start=1):
        padj.append([c, p * n_cand / rank])
    for i in range(len(padj) - 2, -1, -1):
        padj[i][1] = min(padj[i][1], padj[i + 1][1])
    extra = set()
    for c, pa in padj:
        if pa <= fdr:
            extra.add(c)
    return extra
