"""Splice-junction collection, collapse, filtering, SJ.out.tab output.

Reference behavior: source/ReadAlign_outputTranscriptSJ.cpp (per-read junction
records), source/outputSJ.cpp (collapse across the run + motif-class filters +
neighbour-distance filter), source/OutSJ.cpp (output columns).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class SJCollector:
    """accumulates collapsed junction records keyed by (intron_start, gap)."""

    def __init__(self, P, gi):
        self.P = P
        self.gi = gi
        # key -> [motif, strand, annot, countUnique, countMultiple, overhang]
        self.records: Dict[Tuple[int, int], list] = {}

    def add_read(self, transcripts, n_tr):
        P = self.P
        if not P.outSJtype == "Standard":
            return
        if not (P.outSJfilterReads == "All" or n_tr == 1):
            return
        seen_this_read: Dict[Tuple[int, int], int] = {}
        for tr in transcripts:
            for iex in range(tr.nExons - 1):
                if tr.canonSJ[iex] < 0:
                    continue
                start = tr.exons[iex][1] + tr.exons[iex][2]
                gap = tr.exons[iex + 1][1] - start
                overhang = min(tr.exons[iex][2], tr.exons[iex + 1][2])
                key = (int(start), int(gap))
                if key in seen_this_read:
                    seen_this_read[key] = max(seen_this_read[key], overhang)
                    continue
                seen_this_read[key] = overhang
                motif = tr.canonSJ[iex]
                strand = 0 if motif == 0 else (motif + 1) % 2 + 1
                annot = tr.sjAnnot[iex]
                rec = self.records.get(key)
                if rec is None:
                    self.records[key] = [motif, strand, annot,
                                         1 if n_tr == 1 else 0,
                                         0 if n_tr == 1 else 1, overhang]
                else:
                    if n_tr == 1:
                        rec[3] += 1
                    else:
                        rec[4] += 1
                    rec[5] = max(rec[5], overhang)
                # per-read max-overhang update must also land in the record
                # (reference updates the stored overhang for duplicates)
        # apply per-read overhang maxima
        for key, oh in seen_this_read.items():
            rec = self.records[key]
            rec[5] = max(rec[5], oh)

    # ----------------------------------------------------------------- output
    def collapse_and_filter(self):
        """returns list of rows (start, gap, motif, strand, annot, nU, nM, overhang)
        passing the motif-class count/overhang filters + distance filter."""
        P = self.P
        keys = sorted(self.records.keys())
        rows = []
        for key in keys:
            start, gap = key
            motif, strand, annot, n_u, n_m, oh = self.records[key]
            mclass = (motif + 1) // 2
            keep = annot > 0 or (
                (n_u >= P.outSJfilterCountUniqueMin[mclass]
                 or n_u + n_m >= P.outSJfilterCountTotalMin[mclass])
                and oh >= P.outSJfilterOverhangMin[mclass]
                and (n_u + n_m > len(P.outSJfilterIntronMaxVsReadN)
                     or gap <= P.outSJfilterIntronMaxVsReadN[min(n_u + n_m, len(P.outSJfilterIntronMaxVsReadN)) - 1]))
            if keep:
                rows.append([start, gap, motif, strand, annot, n_u, n_m, oh])

        # neighbour-distance filter on donors and acceptors
        n = len(rows)
        keep_flags = [True] * n
        if n and self.P.outFilterBySJoutStage != 2:
            donors = [r[0] for r in rows]
            for i, r in enumerate(rows):
                x1 = donors[i - 1] if i > 0 else 0
                x2 = donors[i + 1] if i + 1 < n else (1 << 62)
                min_dist = min(r[0] - x1, x2 - r[0])
                keep_flags[i] = min_dist >= P.outSJfilterDistToOtherSJmin[(r[2] + 1) // 2]
            acc = sorted(range(n), key=lambda i: rows[i][0] + rows[i][1])
            acc_pos = [rows[i][0] + rows[i][1] for i in acc]
            for j, i in enumerate(acc):
                if rows[i][4] != 0:
                    keep_flags[i] = True  # annotated: no distance filtering
                    continue
                x1 = acc_pos[j - 1] if j > 0 else 0
                x2 = acc_pos[j + 1] if j + 1 < n else (1 << 62)
                min_dist = min(acc_pos[j] - x1, x2 - acc_pos[j])
                keep_flags[i] = keep_flags[i] and (
                    min_dist >= P.outSJfilterDistToOtherSJmin[(rows[i][2] + 1) // 2])
        return [r for r, k in zip(rows, keep_flags) if k]

    def write(self, path: str):
        gi = self.gi
        with open(path, "w") as f:
            for start, gap, motif, strand, annot, n_u, n_m, oh in self.collapse_and_filter():
                chrom = int(gi.chr_bin[start >> gi.chr_bin_nbits])
                cs = int(gi.chr_start[chrom])
                f.write(f"{gi.chr_name[chrom]}\t{start + 1 - cs}\t{start + gap - cs}"
                        f"\t{strand}\t{motif}\t{annot}\t{n_u}\t{n_m}\t{oh}\n")
