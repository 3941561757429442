"""Batched post-seeding alignment: windows -> seed assignment -> stitch -> extend.

This is the production hot path after the device seed loop: every per-read
stage of the reference engine (reference: ReadAlign_stitchPieces.cpp,
ReadAlign_createExtendWindowsWithAlign.cpp, ReadAlign_assignAlignToWindow.cpp,
stitchWindowAligns.cpp, stitchAlignToTranscript.cpp, extendAlign.cpp) is
reformulated as fixed-shape array ops over a batch of reads and runs
vectorized (numpy) on the host — the stages are written against a static
shape envelope so they can later be jitted unchanged with jnp.
Reads whose shapes exceed the static envelope (window/seed/subset
caps below) raise a per-read fallback flag and are re-run through the host
oracle (align/windows.py + align/stitch.py), which keeps every output
byte-identical while the envelope covers the overwhelming majority of reads.

Window clustering note: the reference marks 64 KB genome bins in a winBin
array and grows/merges windows through neighbour-bin scans.  The marked bins
of a live window always form one contiguous interval, so the whole winBin
state collapses to per-window [lo, hi] bin intervals — that is what makes the
stage batchable without a per-read genome-sized array.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..constants import MARK_FRAG_SPACER_BASE, MAX_N_EXONS, SCORE_MATCH

# static envelope of the fast path; beyond any of these -> host fallback
W_MAX = 8       # windows per read (live slots, incl. dead-by-merge)
S_MAX = 16      # seeds per window

import os as _os

# seed records from which a level's grow runs on the device engine, keyed
# by the level's s_max.  Where the card's grow overtook the numpy grow in
# chip_smoke.py's grow sweep on an H100 (PERF.md): level 0 (W8, 16 steps)
# lost at 71,557 records and won at 143,268; level 1 (W512, 50 steps) won
# from its smallest point, 19,017, and its fixed cost of ~0.4 s against
# numpy's ~26 us per record puts the tie near 15,000.
DEVICE_GROW_MIN_RECORDS = {S_MAX: 100_000, 50: 16_000}


def _use_device_stitch(gi, s_max: int, n_records: int) -> bool:
    """gate for the device stitch engine (ops/device_stitch.py: grow,
    finalize and select): int32 positions require a <2^30-base genome
    (bigger genomes keep the numpy engine); mask words cover s_max <= 50;
    levels with fewer seed records than DEVICE_GROW_MIN_RECORDS[s_max] stay
    on the numpy engine.  STAR_TPU_DEVICE_STITCH=0 turns the device engine
    off."""
    if _os.environ.get("STAR_TPU_DEVICE_STITCH", "1") == "0":
        return False
    if int(gi.n_genome) >= (1 << 30) or s_max > 50:
        return False
    return n_records >= DEVICE_GROW_MIN_RECORDS[s_max]


# fallback-cause counters (diagnostics, always on; read by the tests and
# chip_smoke.py)
import collections as _collections
FB_STATS = _collections.Counter()
RPT = 256       # repeat-shift scan bound (MAX_SJ_REPEAT_SEARCH + 1)
PAD_BASE = 255  # out-of-read padding: fails every base compare like C++ OOB


@dataclass
class SeedArrays:
    """flat per-batch seed table (the reference PC rows, read-major order)"""
    read: np.ndarray      # int32 read index
    r_start: np.ndarray   # int64
    length: np.ndarray    # int64
    idir: np.ndarray      # int8
    nrep: np.ndarray      # int64
    lo: np.ndarray        # int64 SA interval start
    hi: np.ndarray        # int64 SA interval end
    ifrag: np.ndarray     # int8


@dataclass
class WindowsState:
    n_reads: int
    win_str: np.ndarray    # [B, W] int8
    win_chr: np.ndarray    # [B, W] int32
    win_lo: np.ndarray     # [B, W] int64 core bin interval (pre-flank)
    win_hi: np.ndarray
    win_flo: np.ndarray    # [B, W] flanked interval
    win_fhi: np.ndarray
    win_alive: np.ndarray  # [B, W] bool
    win_n: np.ndarray      # [B] int32
    fallback: np.ndarray   # [B] bool


# --------------------------------------------------------------------------
# Stage A: SA-hit expansion + plus-strand conversion + sjdb split
# --------------------------------------------------------------------------

def _plus_strand(gi, combined, idir, length, r_start, lread):
    """vectorized _hit_to_plus_strand (reference stitchPieces.cpp:143-158)"""
    n = gi.n_genome
    str0 = combined >= n
    a1 = np.where(str0, combined - n, combined)
    a_str = (str0 ^ (idir == 1)).astype(np.int8)
    flip = (idir == 1) ^ str0
    a_rstart = np.where(flip, lread - (length + r_start), r_start)
    a1 = np.where(str0, n - (length + a1), a1)
    return a1, a_str, a_rstart


def _sj_split(gi, a1, length):
    """vectorized sjAlignSplit (reference sjAlignSplit.cpp:3-15).
    returns (in_sj, crosses, a1_d, len_d, a1_a, len_a, isj)"""
    in_sj = a1 >= gi.sj_gstart
    if not in_sj.any():
        z = np.zeros_like(a1)
        return in_sj, in_sj.copy(), z, z, z, z, z
    sjl = max(gi.sjdb_length, 1)
    off = np.where(in_sj, a1 - gi.sj_gstart, 0)
    sj1 = off % sjl
    isj = off // sjl
    crosses = in_sj & (sj1 < gi.sjdb_overhang) & (sj1 + length > gi.sjdb_overhang)
    len_d = np.where(crosses, gi.sjdb_overhang - sj1, 0)
    len_a = np.where(crosses, length - len_d, 0)
    isj_c = np.clip(isj, 0, max(gi.sjdb_n - 1, 0))
    a1_d = np.where(crosses, gi.sj_dstart[isj_c] + sj1, 0)
    a1_a = np.where(crosses, gi.sj_astart[isj_c], 0)
    return in_sj, crosses, a1_d, len_d, a1_a, len_a, isj


def expand_hits(gi, P, seeds: SeedArrays, lread: np.ndarray, n_reads: int):
    """expand every seed's SA interval into per-hit records, in the exact
    reference processing order (seed-major, SA-row-minor, donor-before-
    acceptor for junction hits).  Returns (create_recs, assign_recs,
    fallback) where each recs is a dict of dense [B, K] arrays + counts."""
    nh = (seeds.hi - seeds.lo + 1).astype(np.int64)
    flat_seed = np.repeat(np.arange(len(seeds.read)), nh)
    if len(flat_seed):
        row_off = np.arange(len(flat_seed)) - np.repeat(
            np.cumsum(nh) - nh, nh)
    else:
        row_off = np.zeros(0, np.int64)
    rows = seeds.lo[flat_seed] + row_off
    combined = gi.sa[rows]
    h_read = seeds.read[flat_seed]
    h_dir = seeds.idir[flat_seed]
    h_len = seeds.length[flat_seed]
    h_rs = seeds.r_start[flat_seed]
    h_nrep = seeds.nrep[flat_seed]
    h_frag = seeds.ifrag[flat_seed]
    h_lread = lread[h_read]
    a1, a_str, a_rstart = _plus_strand(gi, combined, h_dir, h_len, h_rs,
                                       h_lread)
    if gi.sjdb_n == 0 or gi.sj_gstart >= gi.n_genome:
        # no junction pseudo-chromosome: every hit is one plain record in
        # order — skip the expensive scatter assembly below entirely
        anchor = h_nrep <= P.winAnchorMultimapNmax
        return dict(read=h_read.astype(np.int32, copy=False), a1=a1,
                    length=h_len, strand=a_str, rs=a_rstart, nrep=h_nrep,
                    frag=h_frag, sja=np.full(len(a1), -1, np.int64),
                    anchor=anchor)
    in_sj, crosses, a1_d, len_d, a1_a, len_a, isj = _sj_split(gi, a1, h_len)

    # each hit contributes 0 (uncrossed sj), 1 (plain) or 2 (split) records
    n_out = np.where(in_sj, np.where(crosses, 2, 0), 1)
    out_start = np.cumsum(n_out) - n_out
    total = int(n_out.sum())
    r_read = np.zeros(total, np.int32)
    r_a1 = np.zeros(total, np.int64)
    r_len = np.zeros(total, np.int64)
    r_str = np.zeros(total, np.int8)
    r_rs = np.zeros(total, np.int64)
    r_nrep = np.zeros(total, np.int64)
    r_frag = np.zeros(total, np.int8)
    r_sja = np.full(total, -1, np.int64)

    plain = ~in_sj
    p_i = out_start[plain]
    r_read[p_i] = h_read[plain]
    r_a1[p_i] = a1[plain]
    r_len[p_i] = h_len[plain]
    r_str[p_i] = a_str[plain]
    r_rs[p_i] = a_rstart[plain]
    r_nrep[p_i] = h_nrep[plain]
    r_frag[p_i] = h_frag[plain]

    c_i = out_start[crosses]
    for k, (aa, ll, rr) in enumerate([
            (a1_d, len_d, a_rstart),
            (a1_a, len_a, a_rstart + len_d)]):
        ii = c_i + k
        r_read[ii] = h_read[crosses]
        r_a1[ii] = aa[crosses]
        r_len[ii] = ll[crosses]
        r_str[ii] = a_str[crosses]
        r_rs[ii] = rr[crosses]
        r_nrep[ii] = h_nrep[crosses]
        r_frag[ii] = h_frag[crosses]
        r_sja[ii] = isj[crosses]

    anchor = r_nrep <= P.winAnchorMultimapNmax
    recs = dict(read=r_read, a1=r_a1, length=r_len, strand=r_str, rs=r_rs,
                nrep=r_nrep, frag=r_frag, sja=r_sja, anchor=anchor)
    return recs


def densify(recs: dict, n_reads: int, mask=None):
    """flat records -> dense [B, K] arrays + per-read counts (order kept)"""
    read = recs["read"]
    if mask is not None:
        read = read[mask]
    counts = np.bincount(read, minlength=n_reads)
    K = int(counts.max()) if len(counts) and counts.max() > 0 else 0
    pos = _stable_pos(read, n_reads) if len(read) else np.zeros(0, np.int64)
    out = {}
    for k, v in recs.items():
        if k == "read":
            continue
        vv = v[mask] if mask is not None else v
        d = np.zeros((n_reads, K), dtype=v.dtype)
        d[read, pos] = vv
        out[k] = d
    return out, counts


def _stable_pos(read, n_reads):
    # records are produced read-major already; this handles any interleaving
    order = np.argsort(read, kind="stable")
    pos = np.zeros(len(read), np.int64)
    counts = np.bincount(read, minlength=n_reads)
    start = np.zeros(n_reads, np.int64)
    start[1:] = np.cumsum(counts)[:-1]
    pos[order] = np.arange(len(read)) - start[read[order]]
    return pos


# --------------------------------------------------------------------------
# Stage B: window creation scan (reference createExtendWindowsWithAlign)
# --------------------------------------------------------------------------

def build_windows(gi, P, crec: dict, c_counts: np.ndarray, n_reads: int,
                  w_max: int = W_MAX) -> WindowsState:
    wbits = P.winBinNbits
    wbc = gi.chr_bin_nbits - wbits
    dist = P.winAnchorDistNbins
    win_bin_n = gi.n_genome // (1 << wbits) + 1
    # chr_bin extended to cover the sjdb region the same way the in-range
    # values behave (clamped to the last real chromosome)
    chr_bin = gi.chr_bin

    B = n_reads
    ws = WindowsState(
        n_reads=B,
        win_str=np.zeros((B, w_max), np.int8),
        win_chr=np.zeros((B, w_max), np.int32),
        win_lo=np.full((B, w_max), 1, np.int64),
        win_hi=np.full((B, w_max), 0, np.int64),
        win_flo=np.zeros((B, w_max), np.int64),
        win_fhi=np.zeros((B, w_max), np.int64),
        win_alive=np.zeros((B, w_max), bool),
        win_n=np.zeros(B, np.int32),
        fallback=np.zeros(B, bool),
    )

    def chrb(b):
        return chr_bin[np.minimum(b >> wbc, len(chr_bin) - 1)]

    K = crec["a1"].shape[1] if crec else 0
    for k in range(K):
        act = (k < c_counts) & ~ws.fallback
        ai = np.nonzero(act)[0]
        if len(ai) == 0:
            if not (c_counts[~ws.fallback] > k).any():
                break
            continue
        a1 = crec["a1"][ai, k]
        astr = crec["strand"][ai, k]
        a_bin = a1 >> wbits
        achr = chrb(a_bin)

        w_alive = ws.win_alive[ai]
        w_str = ws.win_str[ai]
        w_lo = ws.win_lo[ai]
        w_hi = ws.win_hi[ai]

        same = w_alive & (w_str == astr[:, None])
        contained = (same & (w_lo <= a_bin[:, None])
                     & (a_bin[:, None] <= w_hi)).any(1)

        # left neighbour: max hi among windows with hi in [a_bin-dist, a_bin)
        lbound = np.maximum(a_bin - dist, 0)
        leftc = same & (w_hi < a_bin[:, None]) & (w_hi >= lbound[:, None]) \
            & (a_bin[:, None] > 0)
        lkey = np.where(leftc, w_hi, -1)
        lwin = np.argmax(lkey, axis=1)
        lhi = lkey[np.arange(len(ai)), lwin]
        flag_left = (lhi >= 0) & (chrb(np.maximum(lhi, 0)) == achr)

        # right neighbour: min lo among windows with lo in (a_bin, a_bin+dist]
        rightc = same & (w_lo > a_bin[:, None]) \
            & (w_lo <= (a_bin + dist)[:, None]) \
            & ((a_bin + 1)[:, None] < win_bin_n)
        rkey = np.where(rightc, w_lo, np.iinfo(np.int64).max)
        rwin = np.argmin(rkey, axis=1)
        rlo = rkey[np.arange(len(ai)), rwin]
        flag_right = (rlo < np.iinfo(np.int64).max) & (chrb(np.minimum(
            rlo, win_bin_n)) == achr)

        do = ~contained
        # both sides: merge right into left
        both = do & flag_left & flag_right
        bi = ai[both]
        if len(bi):
            lw = lwin[both]
            rw = rwin[both]
            ws.win_hi[bi, lw] = ws.win_hi[bi, rw]
            ws.win_alive[bi, rw] = False
            ws.win_lo[bi, rw] = 1
            ws.win_hi[bi, rw] = 0
        only_l = do & flag_left & ~flag_right
        li = ai[only_l]
        if len(li):
            ws.win_hi[li, lwin[only_l]] = a_bin[only_l]
        only_r = do & ~flag_left & flag_right
        ri = ai[only_r]
        if len(ri):
            ws.win_lo[ri, rwin[only_r]] = a_bin[only_r]
        # new window
        new = do & ~flag_left & ~flag_right
        ni = ai[new]
        if len(ni):
            slot = ws.win_n[ni]
            over = (slot >= w_max) | (slot + 1 >= P.alignWindowsPerReadNmax)
            ws.fallback[ni[over]] = True
            FB_STATS['win_overflow'] += int(over.sum())
            ok = ~over
            nio = ni[ok]
            so = slot[ok]
            ws.win_str[nio, so] = astr[new][ok]
            ws.win_chr[nio, so] = achr[new][ok]
            ws.win_lo[nio, so] = a_bin[new][ok]
            ws.win_hi[nio, so] = a_bin[new][ok]
            ws.win_alive[nio, so] = True
            ws.win_n[nio] = so + 1

    # flank extension (reference stitchPieces.cpp flank loop); per-window
    # intervals only — ownership overlaps are resolved at assignment time
    live = ws.win_alive & (ws.win_lo <= ws.win_hi)
    chrs = ws.win_chr
    cs_bin = gi.chr_start[chrs] >> wbits
    n_chr = len(gi.chr_name)
    ce_bin = np.where(chrs + 1 < n_chr,
                      (gi.chr_start[np.minimum(chrs + 1, n_chr)] >> wbits) - 1,
                      win_bin_n - 1)
    ws.win_flo = np.where(live, np.maximum.reduce(
        [ws.win_lo - P.winFlankNbins, cs_bin,
         np.zeros_like(ws.win_lo)]), ws.win_lo)
    ws.win_fhi = np.where(live, np.minimum.reduce(
        [ws.win_hi + P.winFlankNbins, ce_bin,
         np.full_like(ws.win_hi, win_bin_n - 1)]), ws.win_hi)
    return ws


# --------------------------------------------------------------------------
# Stage C: seed->window assignment scan (reference assignAlignToWindow)
# --------------------------------------------------------------------------

def compute_owner(P, gi, ws: WindowsState, read, a1, astr):
    """window ownership for FLAT records via a batched winBin table — the
    reference's own design (ReadAlign.h winBin; marking in
    createExtendWindowsWithAlign.cpp): per (read, strand, 64K-genome-bin)
    store the owning window slot.  Cores are marked in window order, then
    flanks in window order (later marks overwrite, so the highest-index
    flank covering a bin beats any core — same quirk _owner_window models).
    Ownership is pure once windows are built, so records owned by no window
    are dropped before the order-sensitive WA scan (the reference's
    `iW==uintWinBinMax -> return`, assignAlignToWindow.cpp:10).
    Falls back to a chunked per-record window-compare when the dense table
    would be too large (mammal-scale genome x large batch)."""
    B = ws.n_reads
    W = ws.win_alive.shape[1]
    wbits = P.winBinNbits
    n_bins = (int(gi.n_genome) >> wbits) + 2
    if B * 2 * n_bins > (1 << 28):
        return _owner_flat_chunked(P, ws, read, a1, astr)
    wb = np.full((B, 2, n_bins), -1, np.int16)
    wbf = wb.reshape(-1)
    bi, wi = np.nonzero(ws.win_alive & (ws.win_lo <= ws.win_hi))
    if len(bi):
        sw = ws.win_str[bi, wi].astype(np.int64)
        base = (bi.astype(np.int64) * 2 + sw) * n_bins
        lo = ws.win_lo[bi, wi]
        hi = ws.win_hi[bi, wi]
        flo = ws.win_flo[bi, wi]
        fhi = ws.win_fhi[bi, wi]

        def mark(lo_, hi_, base_, wi_):
            ln = np.maximum(hi_ - lo_ + 1, 0)
            tot = int(ln.sum())
            if tot == 0:
                return
            ww = np.repeat(np.arange(len(base_)), ln)
            off = np.arange(tot) - np.repeat(np.cumsum(ln) - ln, ln)
            # duplicate flat indices: numpy fancy assignment keeps the LAST
            # write; rows come b-major w-minor, so within a read later
            # windows win — the reference's marking order
            wbf[np.repeat(base_, ln) + np.repeat(lo_, ln) + off] = \
                wi_[ww].astype(np.int16)

        mark(lo, hi, base, wi)             # cores (disjoint per read/strand)
        # flanks window-major: left+right of window i before any flank of
        # window i+1 (matches the reference's per-window marking loop and
        # _owner_flat_chunked's max-index rule when flank ranges overlap)
        nb = len(bi)
        lo2 = np.empty(2 * nb, lo.dtype)
        hi2 = np.empty(2 * nb, hi.dtype)
        lo2[0::2] = flo
        hi2[0::2] = np.minimum(lo - 1, hi)
        lo2[1::2] = np.maximum(hi + 1, lo)
        hi2[1::2] = fhi
        base2 = np.repeat(base, 2)
        wi2 = np.repeat(wi, 2)
        mark(lo2, hi2, base2, wi2)
    own = wbf[(read.astype(np.int64) * 2 + astr) * n_bins
              + (a1 >> wbits)].astype(np.int64)
    return own


def _owner_flat_chunked(P, ws, read, a1, astr, chunk=None):
    """[N, W]-compare ownership (same semantics), chunked over records"""
    N = len(read)
    W = ws.win_alive.shape[1]
    if chunk is None:
        # bound per-chunk gather memory: ~4 int64 [chunk, W] temporaries
        chunk = max(1, (1 << 24) // max(W, 1))
    out = np.full(N, -1, np.int64)
    wix = np.arange(W)[None, :]
    for c0 in range(0, N, chunk):
        c1 = min(c0 + chunk, N)
        ri = read[c0:c1]
        a_bin = (a1[c0:c1] >> P.winBinNbits)[:, None]
        alive = ws.win_alive[ri] & (ws.win_str[ri] == astr[c0:c1, None])
        core = alive & (ws.win_lo[ri] <= a_bin) & (a_bin <= ws.win_hi[ri])
        flank = alive & (ws.win_flo[ri] <= a_bin) \
            & (a_bin <= ws.win_fhi[ri]) & ~core
        fk = np.where(flank, wix, -1).max(1)
        ck = np.where(core, wix, -1).max(1)
        out[c0:c1] = np.where(fk >= 0, fk, ck)
    return out


@dataclass
class WAStateP:
    """the reference WA[iW][iA][...] table keyed by (read, window) PAIR rows
    — [NP, S] dense instead of [B, W, S], so wide window envelopes cost
    nothing for the (vast majority of) reads with few windows"""
    pb: np.ndarray         # [NP] int32 read index (sorted major)
    pw: np.ndarray         # [NP] int32 window slot (sorted minor)
    wa_len: np.ndarray     # [NP, S] int64
    wa_rs: np.ndarray
    wa_gs: np.ndarray
    wa_nrep: np.ndarray
    wa_anchor: np.ndarray  # [NP, S] int8
    wa_frag: np.ndarray    # int8
    wa_sja: np.ndarray     # int64 (-1 = none)
    wa_n: np.ndarray       # [NP] int32
    wa_n_dense: np.ndarray  # [B, W] int32 (assemble's window budget walk)
    fallback: np.ndarray   # [B] bool


def assign_pairs(gi, P, ws: WindowsState, rr: dict, s_max: int) -> WAStateP:
    """the reference's sequential WA insertion scan (assignAlignToWindow),
    vectorized over (read, window) pair rows: iteration k processes the k-th
    surviving record of every pair concurrently.  rr: flat ownership-filtered
    records (arrival order preserved) with an "own" window-slot field.

    Occupancy after k records is <= k, so every row operation is sliced to
    the live slot width — total traffic is sum_k active(k)*k instead of
    Kmax*NP*S.  The reference's window-full eviction (assignAlignToWindow
    .cpp:70-103: recompute WALrec as the min non-anchor length, drop
    shorter-than-min non-anchors, then gate future records on WALrec) runs
    batched when s_max == seedPerWindowNmax; the too-many-anchors corner
    (MARKER_TOO_MANY_ANCHORS_PER_WINDOW) falls back to the oracle."""
    B = ws.n_reads
    W = ws.win_alive.shape[1]
    fallback = ws.fallback.copy()
    pid = rr["read"].astype(np.int64) * W + rr["own"]
    upid, inv = np.unique(pid, return_inverse=True)
    NP = len(upid)
    counts = np.bincount(inv, minlength=NP) if NP else np.zeros(0, np.int64)
    Kw = int(counts.max()) if NP else 0
    st = WAStateP(
        pb=(upid // W).astype(np.int32), pw=(upid % W).astype(np.int32),
        wa_len=np.zeros((NP, s_max), np.int64),
        wa_rs=np.zeros((NP, s_max), np.int64),
        wa_gs=np.zeros((NP, s_max), np.int64),
        wa_nrep=np.zeros((NP, s_max), np.int64),
        wa_anchor=np.zeros((NP, s_max), np.int8),
        wa_frag=np.zeros((NP, s_max), np.int8),
        wa_sja=np.full((NP, s_max), -1, np.int64),
        wa_n=np.zeros(NP, np.int32),
        wa_n_dense=np.zeros((B, W), np.int32),
        fallback=fallback)
    if NP == 0:
        return st
    # flat records sorted by (pair, arrival): record k of pair p sits at
    # startp[p] + k — no [NP, Kmax] dense materialization
    order = np.argsort(inv, kind="stable")
    startp = np.zeros(NP, np.int64)
    startp[1:] = np.cumsum(counts)[:-1]
    srt = {kname: rr[kname][order]
           for kname in ("a1", "length", "rs", "nrep", "frag", "sja",
                         "anchor")}
    wa_lrec = np.zeros(NP, np.int64)

    # ---- k = 0: the first record of every pair always inserts at slot 0
    f0 = startp
    st.wa_len[:, 0] = srt["length"][f0]
    st.wa_rs[:, 0] = srt["rs"][f0]
    st.wa_gs[:, 0] = srt["a1"][f0]
    st.wa_nrep[:, 0] = srt["nrep"][f0]
    st.wa_anchor[:, 0] = srt["anchor"][f0]
    st.wa_frag[:, 0] = srt["frag"][f0]
    st.wa_sja[:, 0] = srt["sja"][f0]
    st.wa_n[:] = 1

    remaining = np.nonzero(counts > 1)[0]
    for k in range(1, Kw):
        remaining = remaining[(counts[remaining] > k)
                              & ~st.fallback[st.pb[remaining]]]
        if len(remaining) == 0:
            break
        pi = remaining
        fk = startp[pi] + k
        a1 = srt["a1"][fk]
        L = srt["length"][fk]
        rs = srt["rs"][fk]
        nrep = srt["nrep"][fk]
        frag = srt["frag"][fk]
        sja = srt["sja"][fk]
        anchor = srt["anchor"][fk]

        # WALrec entry gate (only meaningful after an eviction)
        lrec = wa_lrec[pi]
        keep = anchor.astype(bool) | ~(L < lrec)
        if not keep.all():
            pi, a1, L, rs, nrep, frag, sja, anchor, lrec = [
                x[keep] for x in (pi, a1, L, rs, nrep, frag, sja, anchor,
                                  lrec)]
            if len(pi) == 0:
                continue

        wk = min(k, s_max)
        srange = np.arange(wk)
        n = st.wa_n[pi]
        rows_len = st.wa_len[pi, :wk]
        rows_rs = st.wa_rs[pi, :wk]
        rows_gs = st.wa_gs[pi, :wk]
        rows_frag = st.wa_frag[pi, :wk]
        rows_sja = st.wa_sja[pi, :wk]
        occupied = srange[None, :] < n[:, None]

        ovl = occupied \
            & (rows_frag == frag[:, None]) & (rows_sja == sja[:, None]) \
            & (a1[:, None] + rows_rs == rows_gs + rs[:, None]) \
            & (((rows_rs <= rs[:, None])
                & (rs[:, None] < rows_rs + rows_len))
               | ((rows_rs <= (rs + L)[:, None])
                  & ((rs + L)[:, None] < rows_rs + rows_len)))
        has_ovl = ovl.any(1)
        ia = np.argmax(ovl, axis=1)

        # ---- replace path: longer seed on the same diagonal
        rep = has_ovl & (L > rows_len[np.arange(len(pi)), ia])
        if rep.any():
            ri = np.nonzero(rep)[0]
            # ia0: first index != ia with rs < rows_rs, default n; if past
            # the removed slot, shift down one (assignAlignToWindow.cpp:27)
            cond = (rs[ri][:, None] < rows_rs[ri]) \
                & (srange[None, :] != ia[ri][:, None]) \
                & (srange[None, :] < n[ri][:, None])
            ia0 = np.where(cond.any(1), np.argmax(cond, axis=1), n[ri])
            ia0 = np.where(ia0 > ia[ri], ia0 - 1, ia0)
            q = srange[None, :] - (srange[None, :] > ia0[:, None])
            src = q + (q >= ia[ri][:, None])
            src = np.clip(src, 0, wk - 1)
            rrn = np.arange(len(ri))[:, None]
            pp = pi[ri]
            is_new = srange[None, :] == ia0[:, None]
            for arr, newv in [
                    (st.wa_len, L), (st.wa_rs, rs), (st.wa_gs, a1),
                    (st.wa_nrep, nrep),
                    (st.wa_anchor, anchor.astype(np.int8)),
                    (st.wa_frag, frag), (st.wa_sja, sja)]:
                rows = arr[pp, :wk]
                out = np.where(is_new, newv[ri][:, None], rows[rrn, src])
                arr[pp, :wk] = out.astype(arr.dtype)

        # ---- insert path
        ins = ~has_ovl
        if ins.any():
            ii = np.nonzero(ins)[0]
            full = n[ii] >= P.seedPerWindowNmax
            if full.any():
                # window-full eviction (assignAlignToWindow.cpp:70-103):
                # WALrec = min non-anchor length (updated for EVERY
                # triggering record); compaction only runs when the new
                # record itself survives the recheck (the reference returns
                # before compacting otherwise)
                fi = ii[full]
                pp = pi[fi]
                rows_a = st.wa_anchor[pp] == 1
                rows_l = st.wa_len[pp]
                big = np.int64(1) << 60
                lrec_new = np.where(rows_a, big, rows_l).min(axis=1)
                all_anchor = lrec_new >= big
                if all_anchor.any():
                    # MARKER_TOO_MANY_ANCHORS_PER_WINDOW -> host oracle
                    st.fallback[st.pb[pp[all_anchor]]] = True
                    FB_STATS['too_many_anchors'] += int(all_anchor.sum())
                wa_lrec[pp] = lrec_new
                do_c = (~all_anchor
                        & (anchor[fi].astype(bool) | ~(L[fi] < lrec_new)))
                if do_c.any():
                    pp = pp[do_c]
                    keep_m = rows_a[do_c] \
                        | (rows_l[do_c] > lrec_new[do_c, None])
                    kn = keep_m.sum(axis=1).astype(np.int32)
                    dst = np.cumsum(keep_m, axis=1) - 1
                    ri_, ci_ = np.nonzero(keep_m)
                    di_ = dst[ri_, ci_]
                    for arr in (st.wa_len, st.wa_rs, st.wa_gs, st.wa_nrep,
                                st.wa_anchor, st.wa_frag, st.wa_sja):
                        rows = arr[pp]
                        out = np.full_like(
                            rows, -1 if arr is st.wa_sja else 0)
                        out[ri_, di_] = rows[ri_, ci_]
                        arr[pp] = out
                    st.wa_n[pp] = kn
                n = st.wa_n[pi]
                # re-load recorded rows for the insert scan below
                rows_rs = st.wa_rs[pi, :wk]
                lrec = wa_lrec[pi]
            # WALrec insert gate (anchor || L > WALrec); equality drops
            gate = anchor[ii].astype(bool) | (L[ii] > lrec[ii])
            ii = ii[gate]
            if len(ii):
                over = n[ii] >= s_max
                # records of pairs already marked fallback (too-many-anchors
                # corner) must NOT insert into a full row (n == s_max would
                # index past the table); keep them out of the insert path and
                # only suppress the FB_STATS double-count
                new_fb = over & ~st.fallback[st.pb[pi[ii]]]
                st.fallback[st.pb[pi[ii[new_fb]]]] = True
                FB_STATS['seed_smax'] += int(new_fb.sum())
                ii = ii[~over]
            if len(ii):
                wk1 = min(k + 1, s_max)
                sr1 = np.arange(wk1)
                cond = (rs[ii][:, None] < rows_rs[ii]) \
                    & (srange[None, :] < n[ii][:, None])
                pos2 = np.where(cond.any(1), np.argmax(cond, axis=1), n[ii])
                pp = pi[ii]
                shift = sr1[None, :] >= pos2[:, None]
                for arr, newv in [
                        (st.wa_len, L), (st.wa_rs, rs), (st.wa_gs, a1),
                        (st.wa_nrep, nrep),
                        (st.wa_anchor, anchor.astype(np.int8)),
                        (st.wa_frag, frag), (st.wa_sja, sja)]:
                    rows = arr[pp, :wk1]
                    out = rows.copy()
                    out[:, 1:] = np.where(shift[:, 1:], rows[:, :-1],
                                          rows[:, 1:])
                    out[np.arange(len(ii)), pos2] = newv[ii]
                    arr[pp, :wk1] = out
                st.wa_n[pp] = n[ii] + 1
    st.wa_n_dense[st.pb, st.pw] = st.wa_n
    return st


# --------------------------------------------------------------------------
# Stage D: subset enumeration (reference stitchWindowAligns DFS order)
# --------------------------------------------------------------------------

@dataclass
class LaneState:
    b: np.ndarray          # [L] read index
    w: np.ndarray          # [L] window slot
    prow: np.ndarray       # [L] WAStateP pair row
    mask: np.ndarray       # [L] subset bitmask
    dfs: np.ndarray        # [L] DFS rank within window (for ordering)
    ex_rs: np.ndarray      # [L, E] int64
    ex_gs: np.ndarray
    ex_len: np.ndarray
    ex_frag: np.ndarray    # [L, E] int8
    ex_sja: np.ndarray     # [L, E] int64
    sj_can: np.ndarray     # [L, E-1] int32
    sj_shl: np.ndarray
    sj_shr: np.ndarray
    sj_annot: np.ndarray
    sj_str: np.ndarray
    n_ex: np.ndarray       # [L] int32
    n_mm: np.ndarray       # [L] int64
    n_match: np.ndarray
    n_gap: np.ndarray
    l_gap: np.ndarray
    n_del: np.ndarray
    l_del: np.ndarray
    n_ins: np.ndarray
    l_ins: np.ndarray
    n_uniq: np.ndarray
    n_anchor: np.ndarray
    score: np.ndarray      # [L] chain score
    tR2: np.ndarray        # [L]
    tG2: np.ndarray
    alive: np.ndarray      # [L] bool


import dataclasses as _dc

_LANE_FIELDS = None


def _lane_fields():
    global _LANE_FIELDS
    if _LANE_FIELDS is None:
        _LANE_FIELDS = [f.name for f in _dc.fields(LaneState)]
    return _LANE_FIELDS


def _lanes_take(lanes: LaneState, idx) -> LaneState:
    return LaneState(**{k: getattr(lanes, k)[idx] for k in _lane_fields()})


def _lanes_concat(a: LaneState, b: LaneState) -> LaneState:
    return LaneState(**{k: np.concatenate([getattr(a, k), getattr(b, k)])
                        for k in _lane_fields()})


def _empty_lanes(bb, ww, prow) -> LaneState:
    L = len(bb)
    E = MAX_N_EXONS
    z64 = lambda *s: np.zeros(s, np.int64)
    z32 = lambda *s: np.zeros(s, np.int32)
    return LaneState(
        b=bb.astype(np.int32), w=ww.astype(np.int32),
        prow=prow.astype(np.int32), mask=z64(L),
        dfs=z32(L),
        ex_rs=z64(L, E), ex_gs=z64(L, E), ex_len=z64(L, E),
        ex_frag=np.zeros((L, E), np.int8), ex_sja=np.full((L, E), -1, np.int64),
        sj_can=z32(L, E), sj_shl=z32(L, E), sj_shr=z32(L, E),
        sj_annot=z32(L, E), sj_str=z32(L, E),
        n_ex=z32(L), n_mm=z64(L), n_match=z64(L), n_gap=z64(L), l_gap=z64(L),
        n_del=z64(L), l_del=z64(L), n_ins=z64(L), l_ins=z64(L),
        n_uniq=z32(L), n_anchor=z32(L),
        score=z64(L), tR2=z64(L), tG2=z64(L),
        alive=np.ones(L, bool))


CHAIN_CAP = 1024   # valid chains per window before host fallback


class _LaneBuf:
    """amortized frontier storage: lanes append into preallocated capacity
    (the per-step whole-frontier _lanes_concat copy was ~10% of stitch time)"""

    def __init__(self, init: LaneState):
        self.n = len(init.b)
        cap = max(1024, 2 * self.n)
        self.arrs = {}
        for k in _lane_fields():
            v = getattr(init, k)
            a = np.empty((cap,) + v.shape[1:], v.dtype)
            a[:self.n] = v
            self.arrs[k] = a

    def append(self, inc: LaneState, idx):
        m = len(idx)
        if m == 0:
            return
        need = self.n + m
        cap = len(self.arrs["b"])
        if need > cap:
            new_cap = max(need, 2 * cap)
            for k, a in self.arrs.items():
                na = np.empty((new_cap,) + a.shape[1:], a.dtype)
                na[:self.n] = a[:self.n]
                self.arrs[k] = na
        for k, a in self.arrs.items():
            a[self.n:need] = getattr(inc, k)[idx]
        self.n = need

    def view(self) -> LaneState:
        return LaneState(**{k: a[:self.n] for k, a in self.arrs.items()})

    def take(self, idx) -> LaneState:
        return LaneState(**{k: a[:self.n][idx] for k, a in self.arrs.items()})


def grow_chains(gi, P, G, RS, st: WAStateP, ws, nmm_max_read, Lpad,
                chain_cap: int = CHAIN_CAP) -> LaneState:
    """DFS-equivalent chain enumeration, output-sensitive: the frontier holds
    every valid partial chain (the recursion's live include-paths); the
    include branch only extends chains whose stitch succeeded, so dead
    subsets never spawn descendants and 2^n masks never materialize
    (reference: the early-return pruning in stitchWindowAligns.cpp:336-351).
    The reference's last-anchor must-include rule (WA_Anchor==2) is dead code
    there — WlastAnchor is initialized to (uint)-1 so the marking never fires
    (ReadAlign_stitchPieces.cpp:117,277) — and is therefore not modeled.
    Returns completed chains sorted in the recursion's DFS visit order."""
    B = ws.n_reads
    live = np.nonzero((st.wa_n > 0) & ~st.fallback[st.pb])[0]
    buf = _LaneBuf(_empty_lanes(st.pb[live], st.pw[live], live))
    NP = len(st.pb)
    smax = int(st.wa_n.max()) if st.wa_n.size else 0
    for s in range(smax):
        fv = buf.view()
        cand = np.nonzero((s < st.wa_n[fv.prow])
                          & ~st.fallback[fv.b])[0]
        if len(cand) == 0:
            continue
        inc = buf.take(cand)
        inc.mask = inc.mask | (np.int64(1) << s)
        pr2 = inc.prow
        bb2 = inc.b
        ww2 = inc.w
        rB = st.wa_rs[pr2, s]
        gB = st.wa_gs[pr2, s]
        L = st.wa_len[pr2, s]
        fragB = st.wa_frag[pr2, s].astype(np.int64)
        sjA = st.wa_sja[pr2, s]
        nrepB = st.wa_nrep[pr2, s]
        anchB = st.wa_anchor[pr2, s].astype(np.int64)
        wstr = ws.win_str[bb2, ww2].astype(np.int64)
        row_all = bb2.astype(np.int64) + B * wstr
        nmm = nmm_max_read[bb2]
        first = inc.n_ex == 0
        fi = np.nonzero(first)[0]
        if len(fi):
            _append_exon(inc, fi, np.zeros(len(fi), np.int64),
                         rB[fi], gB[fi], L[fi], fragB[fi], sjA[fi])
            inc.n_match[fi] = L[fi]
            inc.score[fi] = SCORE_MATCH * L[fi]
            inc.tR2[fi] = rB[fi] + L[fi] - 1
            inc.tG2[fi] = gB[fi] + L[fi] - 1
            inc.n_uniq[fi] += (nrepB[fi] == 1)
            inc.n_anchor[fi] += (anchB[fi] > 0)
        il2 = np.nonzero(~first)[0]
        if len(il2):
            stitch_step_vec(gi, P, G, RS, row_all, inc, il2, rB[il2],
                            gB[il2], L[il2], fragB[il2], sjA[il2],
                            nrepB[il2], anchB[il2], nmm[il2], Lpad)
        buf.append(inc, np.nonzero(inc.alive)[0])
        # frontier cap: combinatorial windows go to the host oracle.
        # Counts include lanes of already-fallback reads (they are only
        # excluded from cand above), matching the pre-buffer behavior of
        # pruning at the step start: a pair crossing the cap always flags.
        fv = buf.view()
        cnt = np.bincount(fv.prow, minlength=NP)
        over = np.nonzero(cnt > chain_cap)[0]
        if len(over):
            st.fallback[st.pb[over]] = True
            FB_STATS['chain_cap'] += len(over)

    fv = buf.view()
    sel = (fv.mask != 0) & ~st.fallback[fv.b]
    lanes = buf.take(np.nonzero(sel)[0])
    # DFS visit order: include-first recursion == descending bit-reversed
    # mask (seed 0 is the most significant decision)
    n = st.wa_n[lanes.prow].astype(np.int64)
    rev = np.zeros(len(lanes.b), np.int64)
    for s in range(int(st.wa_len.shape[1])):
        bit = (lanes.mask >> s) & 1
        rev |= bit << np.maximum(n - 1 - s, 0)
    order = np.lexsort((-rev, lanes.w, lanes.b))
    return _lanes_take(lanes, order)


# --------------------------------------------------------------------------
# vectorized extendAlign (reference extendAlign.cpp:6-92)
# --------------------------------------------------------------------------

def extend_vec(G, RS, row, r0, g0, dR, dG, L, l_prev, nmm_prev, nmm_max,
               p_mm, to_end, Lwin):
    """all args arrays over lanes except dR/dG (python ints), p_mm (float),
    Lwin (static scan width).  Returns (ok, extendL, maxScore, nMatch, nMM)."""
    A = len(r0)
    if A == 0:
        z = np.zeros(0, np.int64)
        return np.zeros(0, bool), z, z, z, z
    k = np.arange(Lwin, dtype=np.int64)
    rix = r0[:, None] + dR * k[None, :]
    gix = g0[:, None] + dG * k[None, :]
    w = RS.shape[1]
    Rv = np.take(RS, row[:, None] * w + rix, mode="clip")
    Rv = np.where((rix < 0) | (rix >= w), PAD_BASE, Rv)
    gin = (gix >= 0) & (gix < len(G))
    Gv = np.where(gin, np.take(G, gix, mode="clip"), 5)
    inL = k[None, :] < L[:, None]
    spac = Rv == MARK_FRAG_SPACER_BASE
    gbad = ~gin | (Gv == 5)
    BIG = np.int64(1 << 40)

    def first_true(cond):
        has = cond.any(1)
        return np.where(has, np.argmax(cond, axis=1), BIG)

    if to_end:
        # catastrophic: genome boundary/spacer inside the scanned span;
        # the genome check precedes the read-spacer break at equal position
        p_cat = first_true(gbad & inL)
        p_spac = first_true(spac)
        p_end = np.minimum(p_spac, L)                # i_ext stop
        cat = (p_cat < L) & (p_cat <= p_spac)
        valid = k[None, :] < p_end[:, None]
        skip = (Rv > 3) | (Gv > 3)
        sc = valid & ~skip
        match = sc & (Gv == Rv)
        mm = sc & (Gv != Rv)
        i_ext = p_end
        score = (match.sum(1) - mm.sum(1)).astype(np.int64)
        n_match = match.sum(1).astype(np.int64)
        n_mm = mm.sum(1).astype(np.int64)
        ok = cat | (i_ext > 0)
        extendL = np.where(cat, 0, np.where(i_ext > 0, i_ext, 0))
        maxScore = np.where(cat, np.int64(-999999999), score)
        n_match = np.where(cat, 0, n_match)
        n_mm = np.where(cat, nmm_max + 1, n_mm)
        return ok, extendL, maxScore, n_match, n_mm

    brk = ~inL | gbad | spac
    p_brk = first_true(brk)
    skip = (Rv > 3) | (Gv > 3)
    match0 = ~skip & (Gv == Rv)
    mm0 = ~skip & (Gv != Rv)
    mm_excl = np.cumsum(mm0, axis=1, dtype=np.int32) - mm0
    cap_brk = np.minimum(p_mm * (l_prev + L).astype(np.float64),
                         nmm_max.astype(np.float64))
    p_mmbrk = first_true(mm0 & ((mm_excl + nmm_prev[:, None])
                                >= cap_brk[:, None]))
    p_stop = np.minimum(p_brk, p_mmbrk)
    valid = k[None, :] < p_stop[:, None]
    match = match0 & valid
    mm = mm0 & valid
    s = np.cumsum(match.astype(np.int32) - mm.astype(np.int32), axis=1)
    cap_rec = np.minimum(p_mm * (l_prev[:, None] + k[None, :] + 1),
                         nmm_max[:, None].astype(np.float64))
    mm_before = np.cumsum(mm, axis=1, dtype=np.int32) - mm
    cond = (mm_before + nmm_prev[:, None]) <= cap_rec
    cand = match & cond
    sm = np.where(cand, s, np.int32(-(1 << 30)))
    M = sm.max(axis=1)
    ok = M > 0
    pos = np.argmax(sm == M[:, None], axis=1)
    cm = np.cumsum(match, axis=1, dtype=np.int32)
    extendL = np.where(ok, pos + 1, 0)
    maxScore = np.where(ok, M, 0)
    n_match = np.where(ok, cm[np.arange(A), pos], 0)
    n_mm = np.where(ok, mm_before[np.arange(A), pos], 0)
    return ok, extendL, maxScore, n_match, n_mm


# --------------------------------------------------------------------------
# vectorized stitchAlignToTranscript (reference stitchAlignToTranscript.cpp)
# --------------------------------------------------------------------------

def _gwin(G, base, off):
    return np.take(G, base[:, None] + off[None, :], mode="clip")


def _rwin(RS, row, base, off):
    idx = base[:, None] + off[None, :]
    w = RS.shape[1]
    oob = (idx < 0) | (idx >= w)
    # out-of-row flat indices land in a neighboring row (or get clipped at
    # the table ends); every such value is masked to PAD_BASE right after
    v = np.take(RS, row[:, None] * w + idx, mode="clip")
    return np.where(oob, PAD_BASE, v)


def _sjdb_tables(gi):
    tbl = getattr(gi, "_sjdb_find_tbl", None)
    if tbl is None and gi.sjdb_n > 0:
        n = gi.sjdb_n
        order = np.lexsort((np.arange(n), gi.sjdb_end[:n], gi.sjdb_start[:n]))
        tbl = (gi.sjdb_start[:n][order], gi.sjdb_end[:n][order], order)
        gi._sjdb_find_tbl = tbl
    return tbl


def sjdb_find_vec(gi, jS, jE):
    """vectorized _sjdb_find (reference binarySearch2 over sjdbStart/End)"""
    if gi.sjdb_n == 0:
        return np.full(len(jS), -1, np.int64)
    s2, e2, idx = _sjdb_tables(gi)
    lo = np.searchsorted(s2, jS, "left")
    hi = np.searchsorted(s2, jS, "right")
    out = np.full(len(jS), -1, np.int64)
    t = 0
    todo = (lo + t < hi) & (out < 0)
    while todo.any():
        cand = np.clip(lo + t, 0, len(s2) - 1)
        good = todo & (e2[cand] == jE)
        out[good] = idx[cand[good]]
        t += 1
        todo = (lo + t < hi) & (out < 0)
    return out


def _append_junction(lanes, gi_idx, jpos, can, shl, shr, annot, sjstr):
    lanes.sj_can[gi_idx, jpos] = can
    lanes.sj_shl[gi_idx, jpos] = shl
    lanes.sj_shr[gi_idx, jpos] = shr
    lanes.sj_annot[gi_idx, jpos] = annot
    lanes.sj_str[gi_idx, jpos] = sjstr


def _append_exon(lanes, gi_idx, epos, rs, gs, ln, frag, sja):
    lanes.ex_rs[gi_idx, epos] = rs
    lanes.ex_gs[gi_idx, epos] = gs
    lanes.ex_len[gi_idx, epos] = ln
    lanes.ex_frag[gi_idx, epos] = frag
    lanes.ex_sja[gi_idx, epos] = sja
    lanes.n_ex[gi_idx] = epos + 1


def stitch_step_vec(gi, P, G, RS, row_all, lanes: LaneState, il, rB, gB, L,
                    fragB, sjA, nrepB, anchorB, nmm_max, Lpad):
    """stitch seed B onto the chains of lanes[il]; mutates lane state.
    Rejected lanes die (alive=False); accepted lanes get score/tR2/tG2 and
    nUnique/nAnchor updates applied by the caller via the returned mask."""
    A = len(il)
    if A == 0:
        return np.zeros(0, bool)
    nE = lanes.n_ex[il].astype(np.int64)
    last = nE - 1
    ar = np.arange(A)
    exlen_last = lanes.ex_len[il, last]
    exgs_last = lanes.ex_gs[il, last]
    last_sja = lanes.ex_sja[il, last]
    last_frag = lanes.ex_frag[il, last].astype(np.int64)
    ex_rs0 = lanes.ex_rs[il, 0]
    ex_gs0 = lanes.ex_gs[il, 0]
    tR2 = lanes.tR2[il]
    tG2 = lanes.tG2[il]
    row = row_all[il]
    nmm = nmm_max
    d_score = np.zeros(A, np.int64)
    dead = np.zeros(A, bool)

    capm = nE >= MAX_N_EXONS
    dead |= capm
    annotb = ~capm & (sjA != -1) & (last_sja == sjA) & (last_frag == fragB) \
        & (rB == tR2 + 1) & (tG2 + 1 < gB)
    samef = ~capm & ~annotb & (last_frag == fragB)
    mate_gate = (gB + ex_rs0 + P.alignEndsProtrudeMax >= ex_gs0) \
        | (ex_gs0 < ex_rs0)
    mateb = ~capm & ~annotb & ~samef & mate_gate
    dead |= ~capm & ~annotb & ~samef & ~mate_gate          # -1000008

    # ---------------------------------------------- annotated-junction path
    ai = np.nonzero(annotb)[0]
    if len(ai):
        sj = sjA[ai]
        motif = gi.sjdb_motif[sj].astype(np.int64)
        shl = gi.sjdb_shift_left[sj].astype(np.int64)
        shr = gi.sjdb_shift_right[sj].astype(np.int64)
        rej = (motif == 0) & ((L[ai] <= shr) | (exlen_last[ai] <= shl))
        dead[ai[rej]] = True                                # -1000006
        ok = ai[~rej]
        if len(ok):
            gidx = il[ok]
            jpos = nE[ok] - 1
            _append_junction(lanes, gidx, jpos,
                             motif[~rej], shl[~rej], shr[~rej], 1,
                             gi.sjdb_strand[sjA[ok]].astype(np.int64))
            _append_exon(lanes, gidx, nE[ok], rB[ok], gB[ok], L[ok],
                         fragB[ok], sjA[ok])
            lanes.n_match[gidx] += L[ok]
            d_score[ok] = SCORE_MATCH * L[ok] + P.sjdbScore

    # --------------------------------------------------- same-fragment path
    si = np.nonzero(samef)[0]
    if len(si):
        _stitch_same_frag(gi, P, G, RS, row, lanes, il, si, rB, gB, L,
                          fragB, sjA, nmm, d_score, dead, tR2, tG2,
                          exlen_last, nE, Lpad)

    # --------------------------------------------------------- mate path
    mi = np.nonzero(mateb)[0]
    if len(mi):
        rej = (P.alignMatesGapMax > 0) \
            & (gB[mi] > exgs_last[mi] + exlen_last[mi] + P.alignMatesGapMax)
        dead[mi[rej]] = True                                # -1000004
        mi = mi[~rej]
    if len(mi):
        gidx = il[mi]
        d = SCORE_MATCH * L[mi].copy()
        extw = np.asarray(P.alignEndsTypeExt, dtype=bool)   # [mate][which]
        # forward extension of the previous mate's end
        te1 = extw[np.clip(last_frag[mi], 0, 1), 1]
        for te in (False, True):
            pick = np.nonzero(te1 == te)[0]
            if len(pick) == 0:
                continue
            sub = mi[pick]
            gs = il[sub]
            ok, eL, ms, nM, nMM_ = extend_vec(
                G, RS, row_all[gs], tR2[sub] + 1, tG2[sub] + 1, 1, 1,
                np.full(len(sub), 650, np.int64),
                lanes.n_match[gs], lanes.n_mm[gs], nmm[sub],
                P.outFilterMismatchNoverLmax, te, Lpad + 2)
            oks = np.nonzero(ok)[0]
            if len(oks):
                gg = gs[oks]
                lanes.n_match[gg] += nM[oks]
                lanes.n_mm[gg] += nMM_[oks]
                d[pick[oks]] += ms[oks]
                lanes.ex_len[gg, lanes.n_ex[gg] - 1] += eL[oks]
        # new exon for mate B
        jpos = nE[mi] - 1
        _append_junction(lanes, gidx, jpos, -3, 0, 0, 0, 0)
        _append_exon(lanes, gidx, nE[mi], rB[mi], gB[mi], L[mi], fragB[mi],
                     sjA[mi])
        lanes.n_match[gidx] += L[mi]
        # backward extension of mate B's start
        te2 = extw[np.clip(fragB[mi].astype(np.int64), 0, 1), 1]
        extlen = np.where(te2, 650, gB[mi] - ex_gs0[mi] + ex_rs0[mi])
        for te in (False, True):
            pick = np.nonzero(te2 == te)[0]
            if len(pick) == 0:
                continue
            sub = mi[pick]
            gs = il[sub]
            ok, eL, ms, nM, nMM_ = extend_vec(
                G, RS, row_all[gs], rB[sub] - 1, gB[sub] - 1, -1, -1,
                extlen[pick], lanes.n_match[gs], lanes.n_mm[gs], nmm[sub],
                P.outFilterMismatchNoverLmax, te, Lpad + 2)
            oks = np.nonzero(ok)[0]
            if len(oks):
                gg = gs[oks]
                lanes.n_match[gg] += nM[oks]
                lanes.n_mm[gg] += nMM_[oks]
                d[pick[oks]] += ms[oks]
                ne = lanes.n_ex[gg] - 1
                lanes.ex_rs[gg, ne] -= eL[oks]
                lanes.ex_gs[gg, ne] -= eL[oks]
                lanes.ex_len[gg, ne] += eL[oks]
        d_score[mi] = d

    # final: set last exon's frag/sjA (all accept paths already do)
    acc = ~dead
    lanes.alive[il[dead]] = False
    ok = np.nonzero(acc)[0]
    if len(ok):
        gidx = il[ok]
        lanes.score[gidx] += d_score[ok]
        lanes.tR2[gidx] = rB[ok] + L[ok] - 1
        lanes.tG2[gidx] = gB[ok] + L[ok] - 1
        lanes.n_uniq[gidx] += (nrepB[ok] == 1)
        lanes.n_anchor[gidx] += (anchorB[ok] > 0)
    return acc


def _sjmm_limit(P):
    v = np.asarray(P.alignSJstitchMismatchNmax, np.int64)
    return np.where(v >= 0, v, np.int64(1) << 30)


def _stitch_same_frag(gi, P, G, RS, row, lanes: LaneState, il, si, rB, gB,
                      L, fragB, sjA, nmm, d_score, dead, tR2, tG2,
                      exlen_last, nE, Lpad):
    """same-fragment stitch: fill/deletion/intron/insertion cases.
    Everything below follows align/stitch.py stitch_align_to_transcript
    (itself bit-faithful to reference stitchAlignToTranscript.cpp) with
    scans turned into masked window ops."""
    S = len(si)
    ra = tR2[si]                       # r_a_end
    ga = tG2[si]                       # g_a_end
    rowS = row[si]
    r_b_end = rB[si] + L[si] - 1
    g_b_end = gB[si] + L[si] - 1
    # rejections -1000001/-1000002
    rej = (r_b_end <= ra) | (g_b_end <= ga)
    # trim overlap on the read side
    trim = np.maximum(ra + 1 - rB[si], 0)
    rb = rB[si] + trim
    gb = gB[si] + trim
    Ls = r_b_end - rb + 1
    base_score = SCORE_MATCH * (r_b_end - rb + 1)
    g_gap = gb - ga - 1
    r_gap = rb - ra - 1
    gb1 = gb - r_gap - 1
    exlen = exlen_last[si]

    delb = ~rej & (g_gap > r_gap)
    insb = ~rej & (r_gap > g_gap)
    # fill/merge cases (g_gap == r_gap) always fail the short-read accept
    # condition (jCan stays 999): -1000007 without any scan
    rej |= ~delb & ~insb

    n_mm = np.zeros(S, np.int64)
    n_match = Ls.copy()
    extra = np.zeros(S, np.int64)      # gap-scan score contributions
    jR = np.zeros(S, np.int64)
    j_can = np.full(S, 999, np.int64)
    jjL = np.zeros(S, np.int64)
    jjR = np.zeros(S, np.int64)
    delv = np.where(delb, g_gap - r_gap, 0)
    insv = np.where(insb, r_gap - g_gap, 0)
    annot_fl = np.zeros(S, np.int64)
    sjstr = np.zeros(S, np.int64)

    # ------------------------------------------------------- deletion/intron
    di = np.nonzero(delb)[0]
    if len(di):
        rej3 = (P.alignIntronMax > 0) & (delv[di] > P.alignIntronMax)
        rej[di[rej3]] = True
        di = di[~rej3]
    if len(di):
        D = len(di)
        intron = delv[di] >= P.alignIntronMin
        W1 = Lpad + 2
        off = np.arange(-W1, Lpad + 3, dtype=np.int64)
        z0 = W1                        # column of offset 0
        Rv = _rwin(RS, rowS[di], ra[di], off)
        Gd = _gwin(G, ga[di], off)
        Ga = _gwin(G, gb1[di], off)
        # 1. lower scan: jR1 start
        neg = off <= 0
        dec = ((Rv != Ga) & (Ga < 4) & (Rv == Gd) & neg[None, :])
        cum_from_right = np.cumsum(dec[:, ::-1], axis=1,
                                   dtype=np.int32)[:, ::-1]
        cd = np.where(neg[None, :], cum_from_right, 0)     # decs in [o..0]
        fail = neg[None, :] & ((cd > P.scoreStitchSJshift)
                               | (exlen[di][:, None] + off[None, :] <= 1))
        # first failing offset going down from 0 = max failing offset
        okey = np.where(fail, off[None, :].astype(np.int32),
                        np.int32(-(1 << 30)))
        jR1s = okey.max(axis=1)
        # 2. main scan: best junction locus
        hi_o = r_b_end[di] - ra[di] - 1
        scan = (off[None, :] >= jR1s[:, None]) & (off[None, :] <= hi_o[:, None])
        up = (Rv == Gd) & (Rv != Ga)
        dn = (Rv != Gd) & (Rv == Ga)
        contrib = np.where(scan, up.astype(np.int32) - dn.astype(np.int32),
                           np.int32(0))
        score1 = np.cumsum(contrib, axis=1)
        d1 = np.concatenate([Gd[:, 1:], Gd[:, -1:]], axis=1)   # G[ga + o + 1]
        d2 = np.concatenate([Gd[:, 2:], Gd[:, -1:], Gd[:, -1:]], axis=1)
        a1v = np.concatenate([Ga[:, :1], Ga[:, :-1]], axis=1)  # G[gb1 + o - 1]
        a2v = Ga
        can = np.full((D, len(off)), 0, np.int32)
        can = np.where((d1 == 2) & (d2 == 3) & (a1v == 0) & (a2v == 2), 1, can)
        can = np.where((can == 0) & (d1 == 1) & (d2 == 3) & (a1v == 0) & (a2v == 1), 2, can)
        can = np.where((can == 0) & (d1 == 2) & (d2 == 1) & (a1v == 0) & (a2v == 2), 3, can)
        can = np.where((can == 0) & (d1 == 1) & (d2 == 3) & (a1v == 2) & (a2v == 1), 4, can)
        can = np.where((can == 0) & (d1 == 0) & (d2 == 3) & (a1v == 0) & (a2v == 1), 5, can)
        can = np.where((can == 0) & (d1 == 2) & (d2 == 3) & (a1v == 0) & (a2v == 3), 6, can)
        pen = np.zeros((D, len(off)), np.int32)
        pen = np.where(can == 0, P.scoreGapNoncan, pen)
        pen = np.where((can == 3) | (can == 4), P.scoreGapGCAG, pen)
        pen = np.where((can == 5) | (can == 6), P.scoreGapATAC, pen)
        can = np.where(intron[:, None], can, -1)
        pen = np.where(intron[:, None], pen, 0)
        score2 = score1 + pen
        sm = np.where(scan, score2, np.int32(-(1 << 30)))
        M = sm.max(axis=1)
        pos = np.argmax(sm == M[:, None], axis=1)
        ar = np.arange(D)
        jR[di] = off[pos]
        j_can[di] = can[ar, pos]
        j_pen = pen[ar, pos]
        # 3. repeat (micro-homology) scans
        jj = np.arange(RPT + 1, dtype=np.int64)
        gd_idx = ga[di][:, None] + jR[di][:, None] - jj[None, :]
        ga_idx = gb1[di][:, None] + jR[di][:, None] - jj[None, :]
        gdv = np.take(G, gd_idx, mode="clip")
        gav = np.take(G, ga_idx, mode="clip")
        cl = (gd_idx >= 0) & (gdv == gav) & (gdv < 4) & (jj[None, :] <= 255)
        jjL[di] = np.argmax(~cl, axis=1)
        gd_idx = ga[di][:, None] + jj[None, :] + jR[di][:, None] + 1
        ga_idx = gb1[di][:, None] + jj[None, :] + jR[di][:, None] + 1
        gdv = np.take(G, gd_idx, mode="clip")
        gav = np.take(G, ga_idx, mode="clip")
        cl = (gd_idx < len(G)) & (gdv == gav) & (gdv < 4) & (jj[None, :] <= 255)
        jjR[di] = np.argmax(~cl, axis=1)
        # 4. flush deletions/non-canonical junctions left
        flush = j_can[di] <= 0
        jR[di] = np.where(flush, jR[di] - jjL[di], jR[di])
        rej5 = flush & (exlen[di] + jR[di] < 1)
        jjR[di] = np.where(flush, jjR[di] + jjL[di], jjR[di])
        jjL[di] = np.where(flush, 0, jjL[di])
        rej[di[rej5]] = True
        # 5. mismatch-fill scan around the junction
        lo_ii = np.minimum(1, jR[di] + 1)
        hi_ii = np.maximum(r_gap[di], jR[di])
        inr = (off[None, :] >= lo_ii[:, None]) & (off[None, :] <= hi_ii[:, None])
        g1v = np.where(off[None, :] <= jR[di][:, None], Gd, Ga)
        scor = inr & (g1v < 4) & (Rv < 4)
        eq = scor & (Rv == g1v)
        in_rgap = (off[None, :] >= 1) & (off[None, :] <= r_gap[di][:, None])
        n_match[di] += (eq & in_rgap).sum(axis=1)
        extra[di] += (eq & in_rgap).sum(axis=1)
        mm = scor & ~eq
        n_mm[di] += mm.sum(axis=1)
        extra[di] -= mm.sum(axis=1)
        out_mm = mm & ~in_rgap
        extra[di] -= out_mm.sum(axis=1)
        n_match[di] -= out_mm.sum(axis=1)
        # 6. sjdb-annotated override + gap scoring
        jS = ga[di] + jR[di] + 1
        jE = gb1[di] + jR[di]
        ind = sjdb_find_vec(gi, jS, jE) if gi.sjdb_n > 0 \
            else np.full(len(di), -1, np.int64)
        found = ind >= 0
        nf = ~found
        intron_d = delv[di] >= P.alignIntronMin
        extra[di] += np.where(nf & intron_d, P.scoreGap + j_pen, 0)
        extra[di] += np.where(nf & ~intron_d,
                              delv[di] * P.scoreDelBase + P.scoreDelOpen, 0)
        j_can[di] = np.where(nf & ~intron_d, -1, j_can[di])
        annot_fl[di] = np.where(found, 1, 0)
        if found.any():
            fi = di[found]
            indf = ind[found]
            motif = gi.sjdb_motif[indf].astype(np.int64)
            shl = gi.sjdb_shift_left[indf].astype(np.int64)
            shr = gi.sjdb_shift_right[indf].astype(np.int64)
            j_can[fi] = motif
            m0 = motif == 0
            rej6 = m0 & ((Ls[fi] <= shl) | (exlen[fi] <= shl))
            jR[fi] = np.where(m0, jR[fi] + shl, jR[fi])
            rej6 |= m0 & (ra[fi] + jR[fi] >= r_b_end[fi])
            jjL[fi] = np.where(m0, shl, jjL[fi])
            jjR[fi] = np.where(m0, shr, jjR[fi])
            rej[fi[rej6]] = True
            sjstr[fi] = gi.sjdb_strand[indf].astype(np.int64)
            extra[fi] += P.sjdbScore
        sjstr[di] = np.where(annot_fl[di] == 0,
                             np.where(j_can[di] > 0, 2 - j_can[di] % 2, 0),
                             sjstr[di])

    # ------------------------------------------------------------ insertion
    ii_ = np.nonzero(insb & ~rej)[0]
    if len(ii_):
        NI = len(ii_)
        offp = np.arange(0, Lpad + 2, dtype=np.int64)   # ii from 0..
        Rv = _rwin(RS, rowS[ii_], ra[ii_], offp)
        Rv2 = _rwin(RS, rowS[ii_], ra[ii_] + insv[ii_], offp)
        Gd = _gwin(G, ga[ii_], offp)
        # scan jR1 in [1, g_gap]
        inr = (offp[None, :] >= 1) & (offp[None, :] <= g_gap[ii_][:, None])
        gok = Gd < 4
        c1 = np.where(inr & gok, np.where(Rv == Gd, 1, -1)
                      + np.where(Rv2 == Gd, -1, 1), 0)
        score1 = np.cumsum(c1, axis=1)
        smask = np.where(inr, score1, np.int32(-(1 << 30)))
        M = np.maximum(smask.max(axis=1), 0)
        if P.alignInsertionFlushRight:
            # sequential: ties update too -> last offset achieving max;
            # max starts at 0 (jR=0 when nothing reaches it)
            hit = smask == M[:, None]
            last_pos = np.where(hit.any(1),
                                len(offp) - 1 - np.argmax(hit[:, ::-1], 1), 0)
            jR[ii_] = np.where(M > 0, offp[last_pos],
                               np.where(hit.any(1) & (M == 0), offp[last_pos], 0))
        else:
            first_pos = np.argmax(smask == M[:, None], axis=1)
            jR[ii_] = np.where(M > 0, offp[first_pos], 0)
        # g_gap < 0 penalty
        extra[ii_] += np.where(g_gap[ii_] < 0, SCORE_MATCH * g_gap[ii_], 0)
        # fill scan ii in [1, g_gap]
        rsel = np.where(offp[None, :] <= jR[ii_][:, None], Rv, Rv2)
        scor = inr & gok & (rsel < 4)
        eq = scor & (rsel == Gd)
        n_match[ii_] += eq.sum(axis=1)
        extra[ii_] += eq.sum(axis=1)
        mm = scor & ~eq
        n_mm[ii_] += mm.sum(axis=1)
        extra[ii_] -= mm.sum(axis=1)
        if P.alignInsertionFlushRight:
            # flush the insertion right through matching bases
            lim = r_b_end[ii_] - ra[ii_] - insv[ii_]
            tt = np.arange(Lpad + 2, dtype=np.int64)
            Rv3 = _rwin(RS, rowS[ii_], ra[ii_] + jR[ii_] + 1, tt)
            Gd3 = _gwin(G, ga[ii_] + jR[ii_] + 1, tt)
            fail = (jR[ii_][:, None] + tt[None, :] >= lim[:, None]) \
                | (Rv3 != Gd3) | (Gd3 == 4)
            adv = np.argmax(fail, axis=1)
            jR[ii_] = jR[ii_] + adv
            rej9 = jR[ii_] == lim
            rej[ii_[rej9]] = True
        extra[ii_] += insv[ii_] * P.scoreInsBase + P.scoreInsOpen
        j_can[ii_] = -2

    # -------------------------------------------------------- accept block
    sjmm_tab = _sjmm_limit(P)
    lim = sjmm_tab[np.clip((j_can + 1) // 2, 0, 3)]
    acc = ~rej & (lanes.n_mm[il[si]] + n_mm <= nmm[si]) \
        & ((j_can < 0) | ((j_can < 7) & (n_mm <= lim)))
    dead[si[~acc]] = True
    ok = np.nonzero(acc)[0]
    if len(ok) == 0:
        return
    so = si[ok]
    gidx = il[so]
    d_score[so] = base_score[ok] + extra[ok]
    lanes.n_mm[gidx] += n_mm[ok]
    lanes.n_match[gidx] += n_match[ok]
    Del = delv[ok]
    Ins = insv[ok]
    intron = Del >= P.alignIntronMin
    lanes.n_gap[gidx] += np.where(intron & (Del > 0), 1, 0)
    lanes.l_gap[gidx] += np.where(intron, Del, 0)
    lanes.n_del[gidx] += np.where(~intron & (Del > 0), 1, 0)
    lanes.l_del[gidx] += np.where(~intron, Del, 0)
    # deletion/intron: split into two exons at jR
    # (dd indexes the si-relative arrays; sda = A-space; gd = lane space)
    dd = ok[Del > 0]
    if len(dd):
        sda = si[dd]
        gd = il[sda]
        ne = nE[sda]
        lanes.ex_len[gd, ne - 1] += jR[dd]
        _append_junction(lanes, gd, ne - 1, j_can[dd], jjL[dd], jjR[dd],
                         annot_fl[dd], sjstr[dd])
        _append_exon(lanes, gd, ne, ra[dd] + jR[dd] + 1,
                     gb1[dd] + jR[dd] + 1, r_b_end[dd] - ra[dd] - jR[dd],
                     fragB[sda], sjA[sda])
    ddi = ok[Ins > 0]
    if len(ddi):
        sda = si[ddi]
        gd = il[sda]
        ne = nE[sda]
        lanes.n_ins[gd] += 1
        lanes.l_ins[gd] += insv[ddi]
        lanes.ex_len[gd, ne - 1] += jR[ddi]
        _append_junction(lanes, gd, ne - 1, -2, 0, 0, 0, 0)
        _append_exon(lanes, gd, ne, ra[ddi] + jR[ddi] + insv[ddi] + 1,
                     ga[ddi] + 1 + jR[ddi],
                     r_b_end[ddi] - ra[ddi] - jR[ddi] - insv[ddi],
                     fragB[sda], sjA[sda])


# --------------------------------------------------------------------------
# chain replay: run every lane's included seeds through the stitcher
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# finalization (reference stitchWindowAligns.cpp:56-265 per completed chain)
# --------------------------------------------------------------------------

def _glog2_score(glen, scale):
    # int(ceil(log2(glen) * scale - 0.5)) with float64 exactly like the host
    g = np.maximum(glen, 1).astype(np.float64)
    return np.ceil(np.log2(g) * scale - 0.5).astype(np.int64)


def finalize_lanes(gi, P, G, RS, lanes: LaneState, ws, nmm_max_read,
                   read_len, lread, Lpad, sj_novel=None):
    """end extensions + transcript filters for all completed chains.
    Returns (accept, score, extra per-lane fields); lanes' exon arrays are
    updated in place by the extensions."""
    B = ws.n_reads
    al = np.nonzero(lanes.alive & (lanes.n_ex > 0))[0]
    NL = len(lanes.b)
    accept = np.zeros(NL, bool)
    if len(al) == 0:
        return accept
    bb = lanes.b[al]
    wstr = ws.win_str[bb, lanes.w[al]].astype(np.int64)
    row = bb.astype(np.int64) + B * wstr
    nmm = nmm_max_read[bb]
    Lread = lread[bb]
    extw = np.asarray(P.alignEndsTypeExt, dtype=bool)
    p_mm = P.outFilterMismatchNoverLmax

    nE = lanes.n_ex[al].astype(np.int64)
    last = nE - 1
    ar = np.arange(len(al))

    def ext_left(sub):
        """extend past exon[0] start (which == 0)"""
        ss = al[sub]
        rS = lanes.ex_rs[ss, 0]
        gS = lanes.ex_gs[ss, 0]
        go = rS > 0
        sub = sub[go]
        ss = ss[go]
        if len(ss) == 0:
            return
        rS = rS[go]
        gS = gS[go]
        imate = lanes.ex_frag[ss, 0].astype(np.int64)
        te = extw[np.clip(imate, 0, 1),
                  (wstr[sub] != imate).astype(np.int64)]
        l_prev = lanes.tR2[ss] - rS + 1
        for tev in (False, True):
            pick = np.nonzero(te == tev)[0]
            if len(pick) == 0:
                continue
            p = ss[pick]
            ok, eL, ms, nM, nMM_ = extend_vec(
                G, RS, row[sub[pick]], rS[pick] - 1, gS[pick] - 1, -1, -1,
                rS[pick], l_prev[pick], lanes.n_mm[p], nmm[sub[pick]],
                p_mm, tev, Lpad + 2)
            oks = np.nonzero(ok)[0]
            if len(oks):
                g = p[oks]
                lanes.score[g] += ms[oks]
                lanes.n_match[g] += nM[oks]
                lanes.n_mm[g] += nMM_[oks]
                lanes.ex_rs[g, 0] -= eL[oks]
                lanes.ex_gs[g, 0] -= eL[oks]
                lanes.ex_len[g, 0] += eL[oks]

    def ext_right(sub):
        ss = al[sub]
        go = lanes.tR2[ss] < Lread[sub] - 1
        sub = sub[go]
        ss = ss[go]
        if len(ss) == 0:
            return
        ne1 = lanes.n_ex[ss].astype(np.int64) - 1
        imate = lanes.ex_frag[ss, ne1].astype(np.int64)
        te = extw[np.clip(imate, 0, 1), (imate == wstr[sub]).astype(np.int64)]
        rS0 = lanes.ex_rs[ss, 0]
        l_prev = lanes.tR2[ss] - rS0 + 1
        Lx = Lread[sub] - lanes.tR2[ss] - 1
        for tev in (False, True):
            pick = np.nonzero(te == tev)[0]
            if len(pick) == 0:
                continue
            p = ss[pick]
            ok, eL, ms, nM, nMM_ = extend_vec(
                G, RS, row[sub[pick]], lanes.tR2[p] + 1, lanes.tG2[p] + 1,
                1, 1, Lx[pick], l_prev[pick], lanes.n_mm[p], nmm[sub[pick]],
                p_mm, tev, Lpad + 2)
            oks = np.nonzero(ok)[0]
            if len(oks):
                g = p[oks]
                lanes.score[g] += ms[oks]
                lanes.n_match[g] += nM[oks]
                lanes.n_mm[g] += nMM_[oks]
                lanes.ex_len[g, lanes.n_ex[g] - 1] += eL[oks]
                lanes.tR2[g] += eL[oks]
                lanes.tG2[g] += eL[oks]

    fwd = np.nonzero(wstr == 0)[0]
    rev = np.nonzero(wstr == 1)[0]
    ext_left(fwd)
    ext_right(fwd)
    ext_right(rev)
    ext_left(rev)

    nE = lanes.n_ex[al].astype(np.int64)
    last = nE - 1
    rS0 = lanes.ex_rs[al, 0]
    gS0 = lanes.ex_gs[al, 0]
    rSl = lanes.ex_rs[al, last]
    gSl = lanes.ex_gs[al, last]
    lenl = lanes.ex_len[al, last]
    keep = np.ones(len(al), bool)

    # soft-clip at chromosome boundary check
    if P.alignSoftClipAtReferenceEnds != "Yes":
        chrw = ws.win_chr[bb, lanes.w[al]].astype(np.int64)
        chr_end = gi.chr_start[chrw] + gi.chr_length[chrw]
        keep &= ~((gSl + Lread - rSl > chr_end) | (gS0 < gi.chr_start[chrw] + rS0))

    ex_len = lanes.ex_len[al]
    occ = np.arange(MAX_N_EXONS)[None, :] < nE[:, None]
    rLength = np.where(occ, ex_len, 0).sum(axis=1)
    gLength = lanes.tG2[al] + 1 - gS0

    can = lanes.sj_can[al]
    annot = lanes.sj_annot[al]
    shl = lanes.sj_shl[al]
    shr = lanes.sj_shr[al]
    sstr = lanes.sj_str[al]
    jocc = np.arange(MAX_N_EXONS)[None, :] < (nE - 1)[:, None]

    # junction overhang filters (vector over junction slots)
    E = MAX_N_EXONS
    exl = lanes.ex_len[al]
    can_prev = np.concatenate([np.full((len(al), 1), -4), can[:, :-1]], axis=1)
    annot_prev = np.concatenate([np.zeros((len(al), 1), can.dtype),
                                 annot[:, :-1]], axis=1)
    first_j = np.arange(E)[None, :] == 0
    last_j = np.arange(E)[None, :] == (nE - 2)[:, None]
    can_next = np.concatenate([can[:, 1:], np.full((len(al), 1), -4)], axis=1)
    annot_next = np.concatenate([annot[:, 1:],
                                 np.zeros((len(al), 1), can.dtype)], axis=1)
    exl_next = np.concatenate([exl[:, 1:], np.zeros((len(al), 1), exl.dtype)],
                              axis=1)
    sj = jocc & (can >= 0)
    ann1 = sj & (annot == 1)
    bad_a = ann1 & (
        ((exl < P.alignSJDBoverhangMin)
         & (first_j | (can_prev == -3) | ((annot_prev == 0) & (can_prev >= 0))))
        | ((exl_next < P.alignSJDBoverhangMin)
           & (last_j | (can_next == -3) | ((annot_next == 0) & (can_next >= 0)))))
    ann0 = sj & (annot == 0)
    bad_b = ann0 & ((exl < P.alignSJoverhangMin + shl)
                    | (exl_next < P.alignSJoverhangMin + shr))
    keep &= ~(bad_a | bad_b).any(axis=1)
    # terminal annotated-junction overhang
    has2 = nE > 1
    lastj = np.clip(nE - 2, 0, E - 1)
    keep &= ~(has2 & (annot[ar, lastj] == 1)
              & (lanes.ex_len[al, last] < P.alignSJDBoverhangMin))

    # strand consistency + motif filters
    m1 = (sj & (sstr == 1)).sum(axis=1)
    m2 = (sj & (sstr == 2)).sum(axis=1)
    sjN = sj.sum(axis=1)
    motif_strand = np.where((m1 > 0) & (m2 == 0), 1,
                            np.where((m1 == 0) & (m2 > 0), 2, 0))
    if P.outFilterIntronStrands == "RemoveInconsistentStrands":
        keep &= ~((m1 > 0) & (m2 > 0))
    if P.outSAMstrandField == "intronMotif":
        keep &= ~((sjN > 0) & (motif_strand == 0))
    if P.outFilterIntronMotifs == "RemoveNoncanonical":
        keep &= ~(sj & (can == 0)).any(axis=1)
    elif P.outFilterIntronMotifs == "RemoveNoncanonicalUnannotated":
        keep &= ~(sj & (can == 0) & (annot == 0)).any(axis=1)

    # spliced-mate mapped-length filter: per mate segment (split at -3)
    if True:
        exl_i = np.where(occ, exl, 0)
        seg_end = (np.arange(E)[None, :] == (nE - 1)[:, None]) \
            | (jocc & (can == -3))
        # walk segments with a short host-side loop over exon slots
        exsum = np.zeros(len(al), np.int64)
        nsj = np.zeros(len(al), np.int64)
        bad = np.zeros(len(al), bool)
        for iex in range(E):
            on = iex < nE
            exsum = np.where(on, exsum + exl_i[:, iex], exsum)
            end_here = on & seg_end[:, iex]
            fragx = lanes.ex_frag[al, np.minimum(iex, last)].astype(np.int64)
            lim = np.maximum(
                P.alignSplicedMateMapLmin,
                np.floor(P.alignSplicedMateMapLminOverLmate
                         * read_len[bb, np.clip(fragx, 0, 1)]).astype(np.int64))
            bad |= end_here & (nsj > 0) & (exsum < lim)
            exsum = np.where(end_here, 0, exsum)
            nsj = np.where(end_here, 0,
                           np.where(on & jocc[:, iex] & (can[:, iex] >= 0),
                                    nsj + 1, nsj))
        keep &= ~bad

    # BySJout stage-2 junction whitelist
    if P.outFilterBySJoutStage == 2 and sj_novel is not None:
        novel = sj & (annot == 0)
        if novel.any():
            jS = lanes.ex_gs[al] + exl
            jE = np.concatenate([lanes.ex_gs[al][:, 1:],
                                 np.zeros((len(al), 1), np.int64)], axis=1) - 1
            li, ji = np.nonzero(novel)
            starts, ends = sj_novel
            okj = np.zeros(len(li), bool)
            if len(starts):
                pos = np.searchsorted(starts, jS[li, ji], "left")
                # scan forward over equal starts (tiny runs)
                t = 0
                rem = np.ones(len(li), bool)
                while rem.any():
                    cand = np.clip(pos + t, 0, len(starts) - 1)
                    inb = (pos + t < len(starts)) & (starts[cand] == jS[li, ji])
                    okj |= rem & inb & (ends[cand] == jE[li, ji])
                    rem &= inb & ~okj
                    t += 1
            badl = np.zeros(len(al), bool)
            np.logical_or.at(badl, li, ~okj)
            keep &= ~badl

    # PE overlap consistency (rare; host check per lane)
    fr0 = lanes.ex_frag[al, 0]
    frl = lanes.ex_frag[al, last]
    pe = fr0 != frl
    if pe.any():
        keep &= ~(pe & (gSl + lenl <= gS0))
        cand = np.nonzero(pe & keep)[0]
        for c in cand:
            g = al[c]
            ne = int(lanes.n_ex[g])
            exons = [[int(lanes.ex_rs[g, e]), int(lanes.ex_gs[g, e]),
                      int(lanes.ex_len[g, e])] for e in range(ne)]
            canv = [int(lanes.sj_can[g, e]) for e in range(ne - 1)]
            iexM2 = ne
            for iex in range(ne - 1):
                if canv[iex] == -3:
                    iexM2 = iex + 1
                    break
            if exons[iexM2 - 1][1] + exons[iexM2 - 1][2] > exons[iexM2][1]:
                if exons[0][1] > exons[iexM2][1] + exons[0][0] \
                        + P.alignEndsProtrudeMax:
                    keep[c] = False
                    continue
                if (exons[iexM2 - 1][1] + exons[iexM2 - 1][2]
                        > exons[-1][1] + int(Lread[c]) - exons[-1][0]
                        + P.alignEndsProtrudeMax):
                    keep[c] = False
                    continue
                iex1 = 1
                iex2 = iexM2 + 1
                while iex1 < iexM2:
                    if exons[iex1][1] >= exons[iex2 - 1][1] + exons[iex2 - 1][2]:
                        break
                    iex1 += 1
                while iex1 < iexM2 and iex2 < ne:
                    if canv[iex1 - 1] < 0:
                        iex1 += 1
                        continue
                    if canv[iex2 - 1] < 0:
                        iex2 += 1
                        continue
                    if (exons[iex1][1] != exons[iex2][1]
                            or exons[iex1 - 1][1] + exons[iex1 - 1][2]
                            != exons[iex2 - 1][1] + exons[iex2 - 1][2]):
                        keep[c] = False
                        break
                    iex1 += 1
                    iex2 += 1

    # genomic-length score
    if P.scoreGenomicLengthLog2scale != 0:
        glen = gSl + lenl - gS0
        lanes.score[al] = np.maximum(
            lanes.score[al] + _glog2_score(glen, P.scoreGenomicLengthLog2scale),
            0)

    accept[al[keep]] = True
    return accept


# --------------------------------------------------------------------------
# assembly: window top-lists in reference order (engine + stitchWindowAligns
# transcript recording/dedup), producing host Transcript objects
# --------------------------------------------------------------------------

class _LaneTr:
    """lazy stand-in for a Transcript during assemble/multMapSelect: holds
    only the scalars those stages read (duck-typed so blocks_overlap and the
    top-list comparisons work unchanged); the full Transcript — exon and
    junction lists, ~20 python objects each — is materialized on demand,
    i.e. only for reads whose output actually needs it.  A 500-window junk
    read that ends 'mapped to too many loci' materializes ONE transcript
    instead of 500."""
    __slots__ = ("lanes", "ws", "li", "nExons", "maxScore", "iFrag", "b",
                 "w", "Lread", "mappedLength", "gLength", "nMatch", "nMM",
                 "_exons")

    def __init__(self, lanes, ws, li, ne, score, ifrag, b, w, Lread,
                 ml, gl, nmatch, nmm):
        self.lanes = lanes
        self.ws = ws
        self.li = li
        self.nExons = ne
        self.maxScore = score
        self.iFrag = ifrag
        self.b = b
        self.w = w
        self.Lread = Lread
        self.mappedLength = ml
        self.gLength = gl
        self.nMatch = nmatch
        self.nMM = nmm
        self._exons = None

    @property
    def exons(self):
        if self._exons is None:
            l = self.lanes
            li = self.li
            self._exons = [[int(l.ex_rs[li, e]), int(l.ex_gs[li, e]),
                            int(l.ex_len[li, e])] for e in range(self.nExons)]
        return self._exons

    def materialize(self, gi, P):
        return _lane_to_transcript(gi, P, self.lanes, self.li, self.nExons,
                                   self.maxScore, self.iFrag, self.ws,
                                   self.b, self.w, self.Lread)


def assemble(gi, P, lanes: LaneState, accept, ws: WindowsState,
             wa_n_dense, fallback, lread, lazy=False, over=None):
    """returns {read_i: (all_win_tr, maxScoreMate[, over_flag])} for
    non-fallback reads.  `over` (device classification): reads proven
    'mapped to too many loci' on device arrive with only their trBest lane;
    their result carries over_flag=True and a single-window single-lane
    list that _fast_finish consumes without the admission replay.

    Replays the engine's window loop and stitchWindowAligns' transcript
    recording (maxScoreMate gate, overlap dedup, sorted top-list) over the
    accepted lanes, which arrive already in (read, window, DFS) order.  All
    per-lane fields are bulk-extracted to python lists first: the loop itself
    is tiny (one accepted lane per read for most reads)."""
    from ..align.transcript import blocks_overlap

    ok = accept & lanes.alive
    oi = np.nonzero(ok)[0]
    results = {}
    if len(oi) == 0:
        for b in np.nonzero(~fallback)[0]:
            results[int(b)] = ([], [0, 0])
        return results

    # bulk per-lane field extraction (python lists; no np scalar indexing)
    l_b = lanes.b[oi].tolist()
    l_w = lanes.w[oi].tolist()
    l_ne = lanes.n_ex[oi].tolist()
    l_score = lanes.score[oi].tolist()
    fr0 = lanes.ex_frag[oi, 0].astype(np.int64)
    frl = lanes.ex_frag[oi, lanes.n_ex[oi] - 1].astype(np.int64)
    l_ifrag = np.where(fr0 == frl, fr0, -1).tolist()
    if lazy:
        nE = lanes.n_ex[oi].astype(np.int64)
        occ = np.arange(MAX_N_EXONS)[None, :] < nE[:, None]
        l_ml = np.where(occ, lanes.ex_len[oi], 0).sum(axis=1).tolist()
        l_gl = (lanes.tG2[oi] + 1 - lanes.ex_gs[oi, 0]).tolist()
        l_nmatch = lanes.n_match[oi].tolist()
        l_nmm = lanes.n_mm[oi].tolist()
    win_n_l = ws.win_n.tolist()
    wa_n_l = wa_n_dense.tolist()
    fb_l = fallback.tolist()
    rng = P.outFilterMultimapScoreRange
    chim = P.chimSegmentMin > 0
    cap_possible = ws.win_alive.shape[1] * P.alignTranscriptsPerWindowNmax \
        >= P.alignTranscriptsPerReadNmax
    over_l = over.tolist() if over is not None else None

    NA = len(oi)
    i = 0
    B = ws.n_reads
    for b in range(B):
        if fb_l[b]:
            while i < NA and l_b[i] == b:
                i += 1
            continue
        if over_l is not None and over_l[b]:
            # device-classified too-many-loci read: exactly its trBest lane
            # was downloaded — no admission replay needed
            assert i < NA and l_b[i] == b
            li = int(oi[i])
            tr = _LaneTr(lanes, ws, li, l_ne[i], l_score[i], l_ifrag[i],
                         b, l_w[i], int(lread[b]), l_ml[i], l_gl[i],
                         l_nmatch[i], l_nmm[i])
            while i < NA and l_b[i] == b:
                i += 1
            results[b] = ([[tr]], [0, 0], True)
            continue
        msm = [0, 0]
        all_win_tr = []
        if i >= NA or l_b[i] != b:
            results[b] = (all_win_tr, msm)
            continue
        n_total = 0
        wan = wa_n_l[b]
        w_cursor = 0
        stop = False
        while i < NA and l_b[i] == b:
            w = l_w[i]
            # engine window loop: per-read transcript budget check runs for
            # every nonempty window before its lanes (incl. skipped ones)
            if cap_possible and not stop:
                while w_cursor <= w:
                    if wan[w_cursor] > 0 and n_total \
                            + P.alignTranscriptsPerWindowNmax \
                            >= P.alignTranscriptsPerReadNmax:
                        stop = True
                        break
                    w_cursor += 1
            if stop:
                while i < NA and l_b[i] == b:
                    i += 1
                break
            win_tr = []
            while i < NA and l_b[i] == b and l_w[i] == w:
                score = l_score[i]
                ifrag = l_ifrag[i]
                if ifrag >= 0 and score > msm[ifrag]:
                    msm[ifrag] = score
                # record gate (stitchWindowAligns.cpp top-list admission)
                if (score + rng >= (win_tr[0].maxScore if win_tr else 0)
                        or (ifrag >= 0 and score + rng >= msm[ifrag])
                        or chim):
                    li = int(oi[i])
                    if lazy:
                        tr = _LaneTr(lanes, ws, li, l_ne[i], score, ifrag,
                                     b, w, int(lread[b]), l_ml[i], l_gl[i],
                                     l_nmatch[i], l_nmm[i])
                    else:
                        tr = _lane_to_transcript(gi, P, lanes, li, l_ne[i],
                                                 score, ifrag, ws, b, w,
                                                 int(lread[b]))
                    iTr = 0
                    while iTr < len(win_tr):
                        n_ov = blocks_overlap(tr, win_tr[iTr])
                        u_new = tr.mappedLength - n_ov
                        u_old = win_tr[iTr].mappedLength - n_ov
                        if u_new == 0 and score < win_tr[iTr].maxScore:
                            break
                        elif u_old == 0:
                            del win_tr[iTr]
                        elif u_old > 0 and (u_new > 0
                                            or score >= win_tr[iTr].maxScore):
                            iTr += 1
                    if iTr == len(win_tr):
                        ins = 0
                        while ins < len(win_tr):
                            if (score > win_tr[ins].maxScore
                                    or (score == win_tr[ins].maxScore
                                        and tr.gLength < win_tr[ins].gLength)):
                                break
                            ins += 1
                        win_tr.insert(ins, tr)
                        if len(win_tr) > P.alignTranscriptsPerWindowNmax:
                            win_tr.pop()
                i += 1
            if win_tr:
                n_total += len(win_tr)
                all_win_tr.append(win_tr)
        results[b] = (all_win_tr, msm)
    # reads with zero lanes at all
    for b in np.nonzero(~fallback)[0]:
        if int(b) not in results:
            results[int(b)] = ([], [0, 0])
    return results


def _lane_to_transcript(gi, P, lanes, li, ne, score, ifrag, ws, b, w, Lread):
    from ..align.transcript import Transcript
    tr = Transcript()
    tr.exons = [[int(lanes.ex_rs[li, e]), int(lanes.ex_gs[li, e]),
                 int(lanes.ex_len[li, e]), int(lanes.ex_frag[li, e]),
                 int(lanes.ex_sja[li, e])] for e in range(ne)]
    tr.canonSJ = [int(lanes.sj_can[li, j]) for j in range(ne - 1)]
    tr.shiftSJ = [[int(lanes.sj_shl[li, j]), int(lanes.sj_shr[li, j])]
                  for j in range(ne - 1)]
    tr.sjAnnot = [int(lanes.sj_annot[li, j]) for j in range(ne - 1)]
    tr.sjStr = [int(lanes.sj_str[li, j]) for j in range(ne - 1)]
    tr.nExons = ne
    tr.rStart = tr.exons[0][0]
    tr.gStart = tr.exons[0][1]
    tr.rLength = sum(e[2] for e in tr.exons)
    tr.mappedLength = tr.rLength
    tr.gLength = int(lanes.tG2[li]) + 1 - tr.gStart
    tr.nMatch = int(lanes.n_match[li])
    tr.nMM = int(lanes.n_mm[li])
    tr.nGap = int(lanes.n_gap[li])
    tr.lGap = int(lanes.l_gap[li])
    tr.nDel = int(lanes.n_del[li])
    tr.lDel = int(lanes.l_del[li])
    tr.nIns = int(lanes.n_ins[li])
    tr.lIns = int(lanes.l_ins[li])
    tr.nUnique = int(lanes.n_uniq[li])
    tr.nAnchor = int(lanes.n_anchor[li])
    tr.maxScore = score
    tr.iFrag = ifrag
    tr.Lread = Lread
    tr.Chr = int(ws.win_chr[b, w])
    tr.Str = int(ws.win_str[b, w])
    tr.roStr = tr.Str
    tr.roStart = tr.rStart if tr.roStr == 0 else Lread - tr.rStart - tr.rLength
    sjN = 0
    tr.intronMotifs = [0, 0, 0]
    for j in range(ne - 1):
        if tr.canonSJ[j] >= 0:
            sjN += 1
            tr.intronMotifs[tr.sjStr[j]] += 1
    tr.sjYes = sjN > 0
    if tr.intronMotifs[1] > 0 and tr.intronMotifs[2] == 0:
        tr.sjMotifStrand = 1
    elif tr.intronMotifs[1] == 0 and tr.intronMotifs[2] > 0:
        tr.sjMotifStrand = 2
    else:
        tr.sjMotifStrand = 0
    return tr


# --------------------------------------------------------------------------
# top-level driver
# --------------------------------------------------------------------------

def fast_path_config_ok(gi, P) -> bool:
    """configs the batched path reproduces exactly; everything else takes
    the host oracle (still byte-identical, just slower)"""
    if P.chimSegmentMin > 0:
        return False
    if getattr(P, "longReads", False):
        # STARlong uses the seed-chain DP (align/stitch.py
        # stitch_window_seeds), not the short-read recursion this batched
        # engine reproduces
        return False
    if getattr(P, "waspYes", False) or getattr(gi, "var", None) is not None:
        return False
    if P.outFilterBySJoutStage == 2:
        return False
    return True


def _stitch_level(gi, P, recs, lread, read_fwd_u8, read_rc_u8, read_len2,
                  nmm_max_read, w_max, s_max, chain_cap, lazy=False,
                  device=None):
    """run the full windows->assign->grow->finalize->assemble pipeline on one
    (sub-)batch at the given envelope.  Returns (fallback[B], results)."""
    from .pipeline import _tick
    with _tick(f"stitch_level_W{w_max}"):
        return _stitch_level_inner(gi, P, recs, lread, read_fwd_u8,
                                   read_rc_u8, read_len2, nmm_max_read,
                                   w_max, s_max, chain_cap, lazy=lazy,
                                   device=device)


# per escalation level w: (w, "runs"), (w, "reads"), (w, "records": the
# owned seed records the grow consumes) and (w, "device"): the runs whose
# grow ran on the device engine
LEVEL_STATS = _collections.Counter()


def level_state(gi, P, recs, B, read_fwd_u8, read_rc_u8, w_max, s_max):
    """windows and WA pair tables of one escalation level: the grow's
    inputs.  Returns (ws, st, n_records, RS, Lpad)."""
    wbits = P.winBinNbits
    n_bins = (int(gi.n_genome) >> wbits) + 2

    # window creation consumes only the FIRST occurrence of each
    # (read, strand, bin): window intervals only grow, so a bin seen before
    # is always already contained (a no-op create).  Dedup collapses the
    # dense scan width for repeat-heavy reads.
    am = np.nonzero(recs["anchor"])[0]
    key = ((recs["read"][am].astype(np.int64) * 2 + recs["strand"][am])
           * n_bins + (recs["a1"][am] >> wbits))
    _, firsts = np.unique(key, return_index=True)
    cmask = np.zeros(len(recs["read"]), bool)
    cmask[am[firsts]] = True
    crec, cc = densify(recs, B, mask=cmask)
    ws = build_windows(gi, P, crec, cc, B, w_max=w_max)

    own = compute_owner(P, gi, ws, recs["read"], recs["a1"], recs["strand"])
    keep = (own >= 0) & ~ws.fallback[recs["read"]]
    recs_k = {k: v[keep] for k, v in recs.items()}
    recs_k["own"] = own[keep]
    st = assign_pairs(gi, P, ws, recs_k, s_max)
    RS = np.concatenate([read_fwd_u8, read_rc_u8], axis=0)
    Lpad = read_fwd_u8.shape[1] + 2
    return ws, st, len(recs_k["read"]), RS, Lpad


def _stitch_level_inner(gi, P, recs, lread, read_fwd_u8, read_rc_u8,
                        read_len2, nmm_max_read, w_max, s_max, chain_cap,
                        lazy=False, device=None):
    from .pipeline import _tick
    B = len(lread)
    with _tick(f"windows_W{w_max}"):
        ws, st, n_rec, RS, Lpad = level_state(gi, P, recs, B, read_fwd_u8,
                                              read_rc_u8, w_max, s_max)
    G = gi.G if gi.G.dtype == np.uint8 else gi.G.view(np.uint8)
    on_device = _use_device_stitch(gi, s_max, n_rec)
    for k, v in (("runs", 1), ("reads", B), ("records", n_rec),
                 ("device", on_device)):
        LEVEL_STATS[w_max, k] += int(v)
    over = None
    if on_device:
        # grow, finalize and (single-end) select on the device
        from .device_stitch import grow_chains_device
        from .fetch import resolve_device
        with _tick(f"grow_dev_W{w_max}"):
            lanes, accept, over = grow_chains_device(
                gi, P, st, ws, RS, nmm_max_read, Lpad, s_max, chain_cap,
                resolve_device(device), lread=lread, read_len2=read_len2,
                classify=lazy)
    else:
        with _tick(f"grow_host_W{w_max}"):
            lanes = grow_chains(gi, P, G, RS, st, ws, nmm_max_read, Lpad,
                                chain_cap=chain_cap)
        with _tick(f"finalize_W{w_max}"):
            accept = finalize_lanes(gi, P, G, RS, lanes, ws, nmm_max_read,
                                    read_len2, lread, Lpad)
    with _tick(f"assemble_W{w_max}"):
        results = assemble(gi, P, lanes, accept, ws, st.wa_n_dense,
                           st.fallback, lread, lazy=lazy, over=over)
    return st.fallback, results


# escalation levels: (W, S, chain cap).  Level 0 covers ~99% of reads with
# tight shapes; overflow reads re-run at level 1 (wide W is cheap because
# the WA table is pair-keyed); only reads beyond level 1 take the per-read
# host oracle.
LEVELS = ((W_MAX, S_MAX, CHAIN_CAP),
          (512, 50, 16384))


def _slice_seed_recs(recs, read_mask, new_index):
    sel = read_mask[recs["read"]]
    out = {k: v[sel] for k, v in recs.items()}
    out["read"] = new_index[out["read"]].astype(np.int32)
    return out


def fast_finish_config_ok(P) -> bool:
    """configs where the array-native finish path (pipeline._fast_finish)
    replaces ReadAligner.finish_read for batched reads: everything
    fast_path_config_ok allows except PE-overlap merge-remap, which consumes
    materialized window transcript objects (finish_read._pe_overlap_merge_map)"""
    return P.peOverlapNbasesMin == 0


def stitch_batch(gi, P, seeds: SeedArrays, read_fwd_u8, read_rc_u8,
                 lread, read_len2, nmm_max_read, lazy=False, device=None):
    """full batched post-seeding pipeline with envelope escalation.
    read_fwd_u8/read_rc_u8: [B, Lmax] uint8, PAD_BASE-padded.
    read_len2: [B, 2] per-mate readLength.  nmm_max_read: [B].
    device: the torch device of the grow engine (cuda unless named; see
    _use_device_stitch for which levels take it).
    Returns (fallback[B] bool, {read: (all_win_tr, maxScoreMate)})."""
    B = len(lread)
    recs = expand_hits(gi, P, seeds, lread, B)

    fallback = np.ones(B, bool)
    results = {}
    todo = np.ones(B, bool)
    for li, (w_max, s_max, chain_cap) in enumerate(LEVELS):
        idx = np.nonzero(todo)[0]
        if len(idx) == 0:
            break
        if len(idx) == B:
            sub = recs
            fb_s, res_s = _stitch_level(
                gi, P, sub, lread, read_fwd_u8, read_rc_u8, read_len2,
                nmm_max_read, w_max, s_max, chain_cap, lazy=lazy,
                device=device)
        else:
            new_index = np.zeros(B, np.int64)
            new_index[idx] = np.arange(len(idx))
            sub = _slice_seed_recs(recs, todo, new_index)
            fb_s, res_s = _stitch_level(
                gi, P, sub, lread[idx], read_fwd_u8[idx], read_rc_u8[idx],
                read_len2[idx], nmm_max_read[idx], w_max, s_max, chain_cap,
                lazy=lazy, device=device)
        done_s = ~fb_s
        done_idx = idx[done_s]
        fallback[done_idx] = False
        for bsub, v in res_s.items():
            if done_s[bsub]:
                results[int(idx[bsub])] = v
        todo[done_idx] = False
        if li + 1 == len(LEVELS):
            FB_STATS["env_final"] += int(fb_s.sum())
    return fallback, results
