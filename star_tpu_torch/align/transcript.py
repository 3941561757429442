"""Transcript: one candidate alignment of a read (chain of exon blocks).

Mirrors the semantic content of the reference's per-alignment record
(reference: source/Transcript.h) with exon blocks in combined-read
coordinates, per-junction motif/shift/annotation arrays, and score/mismatch
accounting.  This is the host-side record; the batched device pipeline uses
flat arrays with the same field meanings.
"""
from __future__ import annotations

from ..constants import MAX_N_EXONS


class Transcript:
    __slots__ = (
        "exons", "canonSJ", "shiftSJ", "sjAnnot", "sjStr",
        "nExons", "rStart", "roStart", "rLength", "gStart", "gLength", "cStart",
        "Chr", "Str", "roStr", "iFrag", "primaryFlag",
        "nMatch", "nMM", "mappedLength", "extendL", "maxScore",
        "nGap", "lGap", "nDel", "nIns", "lDel", "lIns",
        "nUnique", "nAnchor", "sjMotifStrand", "intronMotifs", "sjYes",
        "Lread", "haploType",
        "varInd", "varGenCoord", "varReadCoord", "varAllele",
    )

    def __init__(self):
        self.reset()

    def reset(self):
        # exon rows: [rStart, gStart, length, iFrag, sjA]
        self.exons = []
        self.canonSJ = []
        self.shiftSJ = []
        self.sjAnnot = []
        self.sjStr = []
        self.nExons = 0
        self.rStart = 0
        self.roStart = 0
        self.rLength = 0
        self.gStart = 0
        self.gLength = 0
        self.cStart = 0
        self.Chr = 0
        self.Str = 0
        self.roStr = 0
        self.iFrag = -1
        self.primaryFlag = False
        self.nMatch = 0
        self.nMM = 0
        self.mappedLength = 0
        self.extendL = 0
        self.maxScore = 0
        self.nGap = 0
        self.lGap = 0
        self.nDel = 0
        self.nIns = 0
        self.lDel = 0
        self.lIns = 0
        self.nUnique = 0
        self.nAnchor = 0
        self.sjMotifStrand = 0
        self.intronMotifs = [0, 0, 0]
        self.sjYes = False
        self.Lread = 0
        self.haploType = 0  # diploid-transform haplotype (Transcript.h:37)
        # SNP annotations (Transcript.h:56-58); None until variation_adjust
        self.varInd = None
        self.varGenCoord = None
        self.varReadCoord = None
        self.varAllele = None
        return self

    def copy(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t.exons = [e[:] for e in self.exons]
        t.canonSJ = self.canonSJ[:]
        t.shiftSJ = [s[:] for s in self.shiftSJ]
        t.sjAnnot = self.sjAnnot[:]
        t.sjStr = self.sjStr[:]
        t.nExons = self.nExons
        t.rStart = self.rStart
        t.roStart = self.roStart
        t.rLength = self.rLength
        t.gStart = self.gStart
        t.gLength = self.gLength
        t.cStart = self.cStart
        t.Chr = self.Chr
        t.Str = self.Str
        t.roStr = self.roStr
        t.iFrag = self.iFrag
        t.primaryFlag = self.primaryFlag
        t.nMatch = self.nMatch
        t.nMM = self.nMM
        t.mappedLength = self.mappedLength
        t.extendL = self.extendL
        t.maxScore = self.maxScore
        t.nGap = self.nGap
        t.lGap = self.lGap
        t.nDel = self.nDel
        t.nIns = self.nIns
        t.lDel = self.lDel
        t.lIns = self.lIns
        t.nUnique = self.nUnique
        t.nAnchor = self.nAnchor
        t.sjMotifStrand = self.sjMotifStrand
        t.sjYes = self.sjYes
        t.Lread = self.Lread
        t.haploType = self.haploType
        t.intronMotifs = self.intronMotifs[:]
        t.varInd = self.varInd[:] if self.varInd is not None else None
        t.varGenCoord = self.varGenCoord[:] if self.varGenCoord is not None else None
        t.varReadCoord = self.varReadCoord[:] if self.varReadCoord is not None else None
        t.varAllele = self.varAllele[:] if self.varAllele is not None else None
        return t

    def add_counts(self, other: "Transcript"):
        """accumulate extension result counters (reference Transcript::add)"""
        self.maxScore += other.maxScore
        self.nMatch += other.nMatch
        self.nMM += other.nMM
        self.nGap += other.nGap
        self.lGap += other.lGap
        self.lDel += other.lDel
        self.nDel += other.nDel
        self.lIns += other.lIns
        self.nIns += other.nIns
        self.nUnique += other.nUnique


def blocks_overlap(t1: Transcript, t2: Transcript) -> int:
    """shared (read,genome)-diagonal overlap between exon blocks
    (reference: source/blocksOverlap.cpp)."""
    i1 = i2 = 0
    n_overlap = 0
    while i1 < t1.nExons and i2 < t2.nExons:
        rs1, gs1, l1 = t1.exons[i1][0], t1.exons[i1][1], t1.exons[i1][2]
        rs2, gs2, l2 = t2.exons[i2][0], t2.exons[i2][1], t2.exons[i2][2]
        re1 = rs1 + l1
        re2 = rs2 + l2
        if rs1 >= re2:
            i2 += 1
        elif rs2 >= re1:
            i1 += 1
        elif gs1 - rs1 != gs2 - rs2:
            if re1 >= re2:
                i2 += 1
            if re2 >= re1:
                i1 += 1
        else:
            n_overlap += min(re1, re2) - max(rs1, rs2)
            if re1 >= re2:
                i2 += 1
            if re2 >= re1:
                i1 += 1
    return n_overlap
