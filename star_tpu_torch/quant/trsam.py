"""TranscriptomeSAM: Aligned.toTranscriptome.out.bam for RSEM/salmon.

Reference behavior: source/ReadAlign_quantTranscriptome.cpp — per-alignment
bans (indel / softclip-extension with mismatch recheck / single-end),
projection via quant_align, random primary pick from the shared mt19937
stream, BAM records with NH/HI attributes only.  While tracing, each
alignment a ban keeps out adds to pipeline.COUNTS["trsam_banned"].
"""
from __future__ import annotations

import numpy as np

from ..align.transcript import Transcript
from .transcriptome import Transcriptome, quant_align


class TrGenomeShim:
    """genome-like view of the transcriptome for the BAM encoder"""

    def __init__(self, trm: Transcriptome):
        self.chr_name = trm.tr_id
        self.chr_length = trm.tr_length
        self.chr_start = np.zeros(len(trm.tr_id) + 1, dtype=np.int64)
        self.n_chr_real = len(trm.tr_id)


def quant_transcriptome(res, trm: Transcriptome, gi, P, rng,
                        out_filter_mm_max_total: int):
    """project all alignments of a read; returns list of Transcript in
    transcript coordinates with primaryFlag set on a random one."""
    from ..ops import pipeline
    align_t = []
    n_mates = len(res.seqs)
    ban_indel = not P.quantTrSAMindel
    ban_softclip = not P.quantTrSAMsoftClip
    ban_single = not P.quantTrSAMsingleEnd
    for a1 in res.transcripts[:res.n_tr]:
        if ban_indel and (a1.nDel > 0 or a1.nIns > 0):
            pipeline._count("trsam_banned")
            continue
        if ban_single and n_mates == 2 and a1.exons[0][3] == a1.exons[-1][3]:
            pipeline._count("trsam_banned")
            continue
        align = a1
        if ban_softclip:
            read1 = res.read1 if a1.roStr == 0 else res.read1rc
            G = gi.G_bytes
            a2 = a1.copy()
            n_mm1 = 0
            lread = res.lread
            for iab in range(a2.nExons):
                left1 = right1 = 0
                if iab == 0:
                    left1 = a2.exons[iab][0]
                elif a2.canonSJ[iab - 1] == -3:
                    left1 = a2.exons[iab][0] - res.read_length[a2.exons[iab - 1][3]] - 1
                if iab == a2.nExons - 1:
                    right1 = lread - a2.exons[iab][0] - a2.exons[iab][2]
                elif a2.canonSJ[iab] == -3:
                    right1 = (res.read_length[a2.exons[iab][3]]
                              - a2.exons[iab][0] - a2.exons[iab][2])
                for b in range(1, left1 + 1):
                    r1 = read1[a2.exons[iab][0] - b]
                    g1 = G[a2.exons[iab][1] - b]
                    if r1 != g1 and r1 < 4 and g1 < 4:
                        n_mm1 += 1
                for b in range(right1):
                    r1 = read1[a2.exons[iab][0] + a2.exons[iab][2] + b]
                    g1 = G[a2.exons[iab][1] + a2.exons[iab][2] + b]
                    if r1 != g1 and r1 < 4 and g1 < 4:
                        n_mm1 += 1
                a2.exons[iab][0] -= left1
                a2.exons[iab][1] -= left1
                a2.exons[iab][2] += left1 + right1
            if a2.nMM + n_mm1 > min(out_filter_mm_max_total,
                                    int(P.outFilterMismatchNoverLmax * (res.lread - 1))):
                pipeline._count("trsam_banned")
                continue
            align = a2
        align_t += quant_align(trm, align, res.lread)
    if align_t:
        idx = int(rng.uniform01() * len(align_t))
        align_t[min(idx, len(align_t) - 1)].primaryFlag = True
    else:
        rng.uniform01()  # the reference draws unconditionally
    return align_t
