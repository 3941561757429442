"""The reference's own view of a genome and its annotation, read from the
raw FASTA and GTF that the aligner was built from.

Plain NumPy and Python: nothing of the aligner is imported or read (no index
file, no table it wrote).  Coordinates are global: chromosome i starts at
offset[i] of one concatenated sequence, as 0-based positions.
"""
from __future__ import annotations

import numpy as np

_CODE = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[ord(chr(_b).lower())] = _i


def encode(s: str) -> np.ndarray:
    """A C G T -> 0 1 2 3, anything else -> 4"""
    return _CODE[np.frombuffer(s.encode(), np.uint8)]


class RefGenome:
    def __init__(self, fasta: str, gtf: str):
        names, seqs = [], []
        with open(fasta, "rb") as f:
            data = f.read()
        for block in data.split(b">")[1:]:
            head, _, body = block.partition(b"\n")
            names.append(head.split()[0].decode())
            seqs.append(_CODE[np.frombuffer(body.replace(b"\n", b""), np.uint8)])
        self.names = names
        self.index = {n: i for i, n in enumerate(names)}
        self.lens = np.array([len(s) for s in seqs], np.int64)
        self.offset = np.concatenate([[0], np.cumsum(self.lens)])
        self.seq = np.concatenate(seqs)
        self._read_gtf(gtf)

    def _read_gtf(self, gtf: str):
        """transcripts (exons ascending), genes, and the annotated junctions
        as (intron start, intron end) global 0-based inclusive pairs"""
        tx = {}
        genes = {}
        with open(gtf) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                c = line.rstrip("\n").split("\t")
                if len(c) < 9 or c[0] not in self.index:
                    continue
                attrs = dict(_attr_pairs(c[8]))
                off = int(self.offset[self.index[c[0]]])
                a, b = int(c[3]) - 1 + off, int(c[4]) + off     # [a, b)
                if c[2] == "exon":
                    t = tx.setdefault(attrs["transcript_id"],
                                      [attrs["gene_id"], c[6], []])
                    t[2].append((a, b))
                elif c[2] == "gene":
                    genes[attrs["gene_id"]] = (a, b, c[6],
                                               attrs.get("gene_name", ""))
        self.tx_id = sorted(tx)
        self.tx = {}
        sj = set()
        for t in self.tx_id:
            gid, strand, ex = tx[t]
            ex.sort()
            self.tx[t] = (gid, strand, ex)
            for (a0, b0), (a1, b1) in zip(ex[:-1], ex[1:]):
                sj.add((b0, a1 - 1))
        self.sjdb = sj
        self.genes = genes

    def chrom_of(self, g: int) -> int:
        return int(np.searchsorted(self.offset, g, side="right")) - 1


def _attr_pairs(s: str):
    for part in s.strip().split(";"):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition(" ")
        yield k, v.strip().strip('"')


def motif(seq: np.ndarray, start: int, end: int) -> int:
    """STAR's junction motif of the intron [start, end] (global, inclusive):
    0 non-canonical, 1 GT/AG, 2 CT/AC, 3 GC/AG, 4 CT/GC, 5 AT/AC, 6 GT/AT"""
    d = (int(seq[start]), int(seq[start + 1]))
    a = (int(seq[end - 1]), int(seq[end]))
    return {((2, 3), (0, 2)): 1, ((1, 3), (0, 1)): 2, ((2, 1), (0, 2)): 3,
            ((1, 3), (2, 1)): 4, ((0, 3), (0, 1)): 5,
            ((2, 3), (0, 3)): 6}.get((d, a), 0)
