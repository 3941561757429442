"""Cell Ranger 4's adapter clip of a 10x cDNA read, as STARsolo's
`--clipAdapterType CellRanger4` states it (STAR source/ClipCR4.cpp and
ClipMate_clipChunk.cpp), worked out again from the reads fed.

5' end: the template-switch oligo AAGCAGTGGTATCAACGCAGAGTACATGGG is aligned
to the read's first 91 bases (N-padded to 91) in overlap mode: leading and
trailing gaps free in both, +1 a match, -2 a mismatch or a base against N
(N against N 0), -2 a gap base.  The score is the best of the oligo's last
row and the target's last column; the clip ends at the first column where
the last row reaches its best, or at the target's end where the last
column is strictly better.  A score under 20, or 20 with a clip over 26,
or 21 with a clip over 30, clips nothing.

3' end: of what the 5' clip leaves, the longest tail in which As make at
least 70 % of the bases, scanned from the end with +1 an A and -2 another
base, stopping once the scan is 27 past its score; under 20 As nothing.
"""
from __future__ import annotations

import numpy as np

TSO = "AAGCAGTGGTATCAACGCAGAGTACATGGG"
WIDTH = 91
_CODE = np.full(256, 4, np.int64)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i


def _codes(seqs, width):
    out = np.full((len(seqs), width), 4, np.int64)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s[:width].encode(), np.uint8)
        out[i, :len(b)] = _CODE[b]
    return out


def tso_clip(seqs):
    """the 5' clip of each read (an int array)"""
    q = _CODE[np.frombuffer(TSO.encode(), np.uint8)]
    t = _codes(seqs, WIDTH)
    n, nq = len(seqs), len(q)
    # h[r] is the column's H of oligo row r; row -1 and column -1 are 0
    prev = np.zeros((n, nq), np.int64)
    last_best = np.full(n, -(1 << 30), np.int64)
    end = np.full(n, -1, np.int64)
    for c in range(WIDTH):
        tc = t[:, c]
        h = np.empty_like(prev)
        up = np.zeros(n, np.int64)
        diag = np.zeros(n, np.int64)
        for r in range(nq):
            s = np.where(tc == q[r], 1, -2)
            s = np.where(tc == 4, np.where(q[r] == 4, 0, -2), s)
            h[:, r] = np.maximum(np.maximum(prev[:, r] - 2, up - 2), diag + s)
            diag = prev[:, r]
            up = h[:, r]
        better = h[:, -1] > last_best
        end[better] = c
        last_best[better] = h[better, -1]
        prev = h
    col_best = prev.max(axis=1)
    score = np.maximum(col_best, last_best)
    clip = np.where(col_best > last_best, WIDTH - 1, end) + 1
    none = (score < 20) | ((score == 20) & (clip > 26)) | \
        ((score == 21) & (clip > 30))
    return np.where(none, 0, clip)


def polya_clip(seq: str) -> int:
    """the 3' clip of a read's sequence after its 5' clip"""
    n = len(seq)
    if n < 20:
        return 0
    score = best = 0
    clip = 0
    for k in range(1, n + 1):
        if seq[n - k] == "A":
            score += 1
            if 10 * score >= 7 * k:
                clip, best = k, score
        else:
            score -= 2
            if k - score > 27:
                break
    return clip if best >= 20 else 0


def clips(seqs):
    """[(5' clip, 3' clip)] of each cDNA read, in the read's own
    orientation"""
    c5 = [min(int(x), len(s)) for x, s in zip(tso_clip(seqs), seqs)]
    return [(a, polya_clip(s[a:])) for a, s in zip(c5, seqs)]
