"""FASTA scanning and genome encoding.

Layout semantics match the reference index (reference:
source/genomeScanFastaFiles.cpp): chromosomes are concatenated with each chr
start aligned to a `2^genomeChrBinNbits` boundary; gaps and all padding hold
the spacer code 5; total padded length always ends with >=1 spacer bin.
"""
from __future__ import annotations

import numpy as np

from ..constants import SPACER, encode_seq


def scan_fasta_files(paths, chr_bin_nbases: int):
    """Parse FASTA file(s) -> (G, chr_names, chr_start, chr_length).

    G is an int8 array of padded length with codes 0-5.
    chr_start has nChr+1 entries (last = padded genome length).
    """
    chr_names: list[str] = []
    chr_seqs: list[list[str]] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n\r")
                if not line:
                    continue
                if line.startswith(">"):
                    chr_names.append(line[1:].split()[0])
                    chr_seqs.append([])
                else:
                    chr_seqs[-1].append(line.strip())
    if not chr_names:
        raise ValueError(f"no sequences found in {paths}")

    seqs = ["".join(parts) for parts in chr_seqs]
    chr_length = np.array([len(s) for s in seqs], dtype=np.int64)

    chr_start = np.zeros(len(seqs) + 1, dtype=np.int64)
    n = 0
    for i, L in enumerate(chr_length):
        chr_start[i] = n
        n += int(L)
        # pad to next bin boundary, always leaving >=1 spacer base
        n = ((n + 1) // chr_bin_nbases + 1) * chr_bin_nbases
    chr_start[-1] = n

    G = np.full(n, SPACER, dtype=np.int8)
    for i, s in enumerate(seqs):
        G[chr_start[i]:chr_start[i] + chr_length[i]] = encode_seq(s)
    return G, chr_names, chr_start, chr_length


def chr_bin_fill(chr_start: np.ndarray, chr_bin_nbases: int) -> np.ndarray:
    """bin index -> chromosome index (reference: Genome.cpp chrBinFill)."""
    n_chr = len(chr_start) - 1
    n_bins = chr_start[-1] // chr_bin_nbases + 1
    bins = np.arange(n_bins, dtype=np.int64) * chr_bin_nbases
    # chrBin[b] = (index of first chrStart > b*binNbases) - 1
    return np.minimum(np.searchsorted(chr_start, bins, side="right") - 1, n_chr - 1)


def build_t2(G: np.ndarray) -> np.ndarray:
    """Doubled search text: T2 = concat(G, revcomp(G)).

    A forward-strand suffix lives at combined position p<N; the reverse-strand
    suffix "j" of the reference's strand-bit encoding lives at p=N+j.  All
    suffix comparisons in the whole framework are plain byte comparisons
    against T2 (this single text replaces the reference's four directional
    compare loops, reference: source/SuffixArrayFuns.cpp compareSeqToGenome).
    """
    n = len(G)
    t2 = np.empty(2 * n, dtype=np.int8)
    t2[:n] = G
    rev = G[::-1]
    comp = rev.copy()
    m = rev < 4
    comp[m] = 3 - rev[m]
    t2[n:] = comp
    return t2
