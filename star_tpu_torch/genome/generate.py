"""Genome index generation: suffix array + prefix index (SAi).

Semantics (not code) follow the reference index so that search results are
bit-compatible (reference: source/Genome_genomeGenerate.cpp,
source/genomeSAindex.cpp):

* SA = lexicographically sorted suffixes of T2=concat(G, revcomp(G)),
  restricted to positions whose first char is a real nucleotide (<4).
  The spacer char (5) sorts above all real chars and terminates comparison;
  suffixes equal up to a shared spacer tie-break by ascending position.
* SAi level L (1..gSAindexNbases) maps every L-mer to the first SA row of its
  block, with an ABSENT flag for missing L-mers (value = next present block
  start) and an N flag when an N-interrupted suffix is mixed into the block's
  row range.

Implementation is our own: a vectorised prefix-doubling sort where spacer
positions are replaced by unique ascending sentinels, which reproduces the
"terminate at spacer, tie-break by position" total order exactly.
"""
from __future__ import annotations

import numpy as np


def sort_suffixes(t2: np.ndarray) -> np.ndarray:
    """Return SA: combined positions p (0..2N) of nucleotide-starting suffixes
    of t2, in lexicographic order (spacer-terminated, position tie-break).

    Uses the native C++ sorter when built (tools/build_native.sh); the numpy
    prefix-doubling path below is the always-available reference.

    Mammal-scale (SA bytes above STAR_TPU_SORT_RAM, default 8 GiB): the
    RAM-bounded chunked sorter spills sorted chunks to disk and returns a
    memmap (reference analog: prefix-bucket chunking in
    Genome_genomeGenerate.cpp:221-331)."""
    import os
    from .native import sort_suffixes_chunked, sort_suffixes_native
    ram_cap = int(os.environ.get("STAR_TPU_SORT_RAM", 8 << 30))
    if len(t2) * 8 > ram_cap:
        import tempfile
        out = os.environ.get("STAR_TPU_SORT_SPILL")
        if out is None:
            fd, out = tempfile.mkstemp(suffix=".sa.i64",
                                       prefix="star_tpu_sort_")
            os.close(fd)
        sa = sort_suffixes_chunked(t2, out, ram_cap)
        if sa is not None:
            return sa
    sa = sort_suffixes_native(t2)
    if sa is not None:
        return sa
    # The reference allocation guards the doubled text with trailing spacers
    # (genome buffer is memset to the spacer char); append one so suffixes
    # near the end terminate identically.
    t2 = np.concatenate([t2, np.array([5], dtype=np.int8)])
    n = len(t2)
    # text for ordering: spacers become unique ascending sentinels > any base
    keys = t2.astype(np.int64)
    sp = np.flatnonzero(t2 >= 5)
    keys[sp] = 6 + np.arange(len(sp), dtype=np.int64)
    rank = _dense_rank(keys)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        boundary = np.empty(n, dtype=np.int64)
        boundary[0] = 0
        boundary[1:] = ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(np.int64)
        boundary = np.cumsum(boundary)
        if boundary[-1] == n - 1:
            sa_all = order
            break
        rank = np.empty(n, dtype=np.int64)
        rank[order] = boundary
        k *= 2
        if k >= n:
            sa_all = np.argsort(rank, kind="stable")
            break
    return sa_all[t2[sa_all] < 4].astype(np.int64)


def _dense_rank(keys: np.ndarray) -> np.ndarray:
    order = np.argsort(keys, kind="stable")
    rank = np.empty(len(keys), dtype=np.int64)
    s = keys[order]
    r = np.empty(len(keys), dtype=np.int64)
    r[0] = 0
    r[1:] = np.cumsum(s[1:] != s[:-1])
    rank[order] = r
    return rank


def build_sai(t2: np.ndarray, sa: np.ndarray, n_levels: int):
    """Build the L-mer prefix index for L=1..n_levels.

    Returns dict with concatenated per-level tables:
      level_start[L]  (n_levels+1): offsets of level-L table (4^1, 4^2, ...)
      val             int64: first SA row of the block / next-present start
      absent          bool
      nbit            bool
    """
    nsa = len(sa)
    L = n_levels
    # prefix value + first-bad position per SA row, computed in bounded-RAM
    # chunks (an [nsa, L] materialization needs ~30 GB at chr-scale)
    t2p = np.concatenate([t2, np.full(L, 5, dtype=np.int8)])
    full = np.empty(nsa, dtype=np.int64)
    il4 = np.empty(nsa, dtype=np.int8)
    pw = 4 ** np.arange(L - 1, -1, -1, dtype=np.int64)
    arL = np.arange(L, dtype=np.int64)[None, :]
    CH = 1 << 23
    for c0 in range(0, nsa, CH):
        c1 = min(c0 + CH, nsa)
        chars = t2p[sa[c0:c1, None] + arL]
        bad = chars > 3
        il4[c0:c1] = np.where(bad.any(axis=1), bad.argmax(axis=1), L)
        full[c0:c1] = np.where(bad, 0, chars).astype(np.int64) @ pw

    level_start = np.zeros(L + 1, dtype=np.int64)
    for i in range(1, L + 1):
        level_start[i] = level_start[i - 1] + (1 << (2 * i))
    total = int(level_start[-1])
    val = np.empty(total, dtype=np.int64)
    absent = np.empty(total, dtype=bool)
    nbit = np.zeros(total, dtype=bool)

    # reference quirk: the SAi skip-scan (genomeSAindex.cpp
    # funSAiFindNextIndex) misses the very last SA row when (a) it forms its
    # own (indFull, iL4) run and (b) the scan overshoots it degenerately —
    # first probe past the previous run lands exactly at nSA-2+isaStep >= nSA,
    # so the end-of-array binary search enters with i1+1==i2 and never
    # assigns isa=i2.  That row then never records its block or N flag.
    n_use = nsa
    if nsa >= 2:
        isa_step = nsa // (1 << (2 * L)) + 1
        if ((full[-1] != full[-2] or il4[-1] != il4[-2]) and isa_step >= 2):
            neq = (full[1:nsa - 1] != full[:nsa - 2]) \
                | (il4[1:nsa - 1] != il4[:nsa - 2])
            bnd = np.nonzero(neq)[0]
            run_start = int(bnd[-1]) + 1 if len(bnd) else 0
            if (nsa - 2 - run_start) % isa_step == 0:
                n_use = nsa - 1

    rows = np.arange(n_use, dtype=np.int64)
    full = full[:n_use]
    il4 = il4[:n_use]
    for lvl in range(1, L + 1):
        off = int(level_start[lvl - 1])
        size = 1 << (2 * lvl)
        pref = full >> (2 * (L - lvl))
        valid = il4 >= lvl
        vpref = pref[valid]
        vrows = rows[valid]
        # first occurrence of each distinct prefix among valid rows (SA order;
        # prefixes of valid rows are non-decreasing, so firsts are boundaries)
        first_mask = np.empty(len(vpref), dtype=bool)
        if len(vpref):
            first_mask[0] = True
            first_mask[1:] = vpref[1:] != vpref[:-1]
        pres_v = vpref[first_mask]
        pres_row = vrows[first_mask]
        # present entries hold their block's first SA row; absent entries
        # point at the next present block's start (suffix-min scan: rows grow
        # with slot index, so min-over-later == nearest present to the right)
        v = np.full(size, nsa, dtype=np.int64)
        ab = np.ones(size, dtype=bool)
        v[pres_v] = pres_row
        ab[pres_v] = False
        v = np.minimum.accumulate(v[::-1])[::-1]
        # N flag: invalid rows mark the most recent present block at <= row
        inv_rows = rows[~valid]
        if len(inv_rows) and len(pres_row):
            j = np.searchsorted(pres_row, inv_rows, side="right") - 1
            j = j[j >= 0]
            marked = np.unique(pres_v[j])
            nbit[off + marked] = True
        val[off:off + size] = v
        absent[off:off + size] = ab
    return {"level_start": level_start, "val": val, "absent": absent, "nbit": nbit}
