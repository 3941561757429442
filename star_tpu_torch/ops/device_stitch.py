"""Device-resident chain growth (the grow half of the stitch engine).

A PyTorch port of the grow stage of star_tpu/ops/device_stitch.py, which is
itself the array form of the numpy batch engine's grow (ops/batch_engine.py
grow_chains + stitch_step_vec + _stitch_same_frag + extend_vec): every branch
mirrors the numpy code (bit-faithful to reference stitchWindowAligns.cpp:
336-351, stitchAlignToTranscript.cpp:106-232, extendAlign.cpp:6-92) with
masked full-width tensor ops over a chunk of lanes.  The numpy engine stays
the oracle: the tests require equal LaneStates.

Design:
  * Lane state lives on the device as three packed int32 row matrices (SCAL,
    EX and SJ blocks).  The active lanes form one contiguous queue; each
    step stitches seed s onto every active lane in chunks of at most A_CAP
    lanes, appends the chains that grew, and at the step's end compacts the
    queue and moves completed chains to an append-only retired buffer.
  * The step/chunk loop runs on the host (a lax.while_loop in the JAX
    package): it waits for the device once per chunk (how many chains
    grew) and once more at each step's end (how many lanes stay and retire).
    A chunk holds only live lanes, so the fixed-size nonzero of the JAX
    engine becomes a plain nonzero, and only its rows are written.
  * The window layer is the JAX engine's fetch layer: every per-lane window
    (the read region, two genome regions, the u16 mismatch-cap table) and
    every lane-row move is cut from aligned 2 KiB rows of fetch.fetch_rows,
    which on a CUDA tensor is the hand-written kernel ops/csrc/fetch_rows.cu
    and on a CPU tensor its plain version.  The JAX engine's gather layer
    (plain per-window gathers, what star_tpu runs off the TPU) is not
    ported.
  * Genome positions are int32: the engine is gated on n_genome < 2^30.
  * The reference's float mismatch caps (outFilterMismatchNoverLmax * len
    in double) are exact host-precomputed integer floor/ceil tables.

Dropped from the JAX engine because they only served the TPU: the
optimization barrier around window gathers (_barrier), the barrel shifter
_shift_cut (one gather here), the FET + TILE zero concatenation of every
_rowcopy (the lane blocks are allocated once with that slack), the _ABLATE
profiling switches, power-of-two shape ladders and the id()-keyed engine
and table caches (there is no jit; device tables live on the index object).

Capacity overflows (state or retired buffer, or the iteration cap) retry
with doubled capacities and split the group on a read boundary at the hard
cap, as the JAX host wrapper does.  Three faults of the JAX engine are not
repeated: its genome regions are too narrow for reads longer than about 250
(region_spans), its loop can stop at IT_MAX and report success (here
overflow 2), and two differences from the numpy engine (the nMatch of an
annotated-junction join, the sign of the low mask word) are the numpy
engine's here.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import MARK_FRAG_SPACER_BASE, MAX_N_EXONS, SCORE_MATCH
from . import fetch
from .fetch import FET, TILE

E = MAX_N_EXONS
RPT = 256
PAD_BASE = 255
NEG = -(1 << 30)
FRONT_PAD = 1024     # tables are front-padded so fetch offsets never clamp
I32 = torch.int32

# grow counters of the process: calls, iterations (chunks), steps and the
# fetch_rows launches made inside the grow
GROW_STATS = collections.Counter()


def _prep_table(raw_bytes: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(raw_bytes).view(np.int8).ravel()
    return fetch.pad_table(np.concatenate([np.zeros(FRONT_PAD, np.int8), b]))


# ---- SCAL block column layout (per-lane scalars, int32)
(C_MASK_LO, C_MASK_HI, C_PROW, C_NEX, C_NMM, C_NMATCH, C_NGAP, C_LGAP,
 C_NDEL, C_LDEL, C_NINS, C_LINS, C_NUNIQ, C_NANCH, C_SCORE, C_TR2, C_TG2,
 C_WAN, C_ROW, C_NMMMAX, C_PB, C_PW, C_WSTR, C_ACCEPT) = range(24)
NSCAL = 24

# EX block: e*5 + {rs, gs, len, frag, sja}, e < E
EX_RS, EX_GS, EX_LEN, EX_FRAG, EX_SJA = range(5)
NEXB = E * 5
# SJ block: j*5 + {can, shl, shr, annot, str}, j < E
SJ_CAN, SJ_SHL, SJ_SHR, SJ_ANNOT, SJ_STR = range(5)
NSJB = E * 5


def _ceil_div(a, b):
    return (a + b - 1) // b


def _round_up(n, q):
    return max(q, _ceil_div(n, q) * q)


@dataclass(frozen=True)
class StitchConfig:
    """static parameters of the engine"""
    Lpad: int                 # read padding (scan half-width)
    s_max: int                # seeds per window cap of this level
    chain_cap: int
    has_pe: bool              # any lane can hit the mate path
    has_sjdb: bool
    ends_ext: tuple           # alignEndsTypeExt as ((b,b),(b,b))
    ins_flush_right: bool
    intron_min: int
    intron_max: int
    mates_gap_max: int
    protrude_max: int
    score_gap: int
    score_gap_noncan: int
    score_gap_gcag: int
    score_gap_atac: int
    score_del_open: int
    score_del_base: int
    score_ins_open: int
    score_ins_base: int
    sjdb_score: int
    stitch_sj_shift: int
    sjmm: tuple               # alignSJstitchMismatchNmax (4 ints, -1 -> big)


def make_config(gi, P, Lpad, s_max, chain_cap, has_pe) -> StitchConfig:
    sjmm = tuple(int(v) if v >= 0 else (1 << 30)
                 for v in P.alignSJstitchMismatchNmax)
    ext = P.alignEndsTypeExt
    return StitchConfig(
        Lpad=int(Lpad), s_max=int(s_max), chain_cap=int(chain_cap),
        has_pe=bool(has_pe), has_sjdb=gi.sjdb_n > 0,
        ends_ext=(tuple(bool(x) for x in ext[0]),
                  tuple(bool(x) for x in ext[1])),
        ins_flush_right=bool(P.alignInsertionFlushRight),
        intron_min=int(P.alignIntronMin), intron_max=int(P.alignIntronMax),
        mates_gap_max=int(P.alignMatesGapMax),
        protrude_max=int(P.alignEndsProtrudeMax),
        score_gap=int(P.scoreGap), score_gap_noncan=int(P.scoreGapNoncan),
        score_gap_gcag=int(P.scoreGapGCAG),
        score_gap_atac=int(P.scoreGapATAC),
        score_del_open=int(P.scoreDelOpen),
        score_del_base=int(P.scoreDelBase),
        score_ins_open=int(P.scoreInsOpen),
        score_ins_base=int(P.scoreInsBase),
        sjdb_score=int(P.sjdbScore),
        stitch_sj_shift=int(P.scoreStitchSJshift),
        sjmm=sjmm)


def mm_cap_tables(p_mm: float, tl_max: int):
    """exact integer forms of the reference's double-precision mismatch caps:
    for integer m,   m <  p*tl  <=>  m <  ceil_tab[tl]
                     m >= p*tl  <=>  m >= ceil_tab[tl]
                     m <= p*tl  <=>  m <= floor_tab[tl]
    where p*tl is computed in float64 exactly as the host does."""
    tl = np.arange(tl_max, dtype=np.float64)
    prod = np.float64(p_mm) * tl
    floor_tab = np.floor(prod).astype(np.int32)
    ceil_tab = np.ceil(prod).astype(np.int32)
    return floor_tab, ceil_tab


def region_spans(Lpad: int):
    """(read span, genome span) of the per-lane fetch regions of one chunk:
    the widest column any window of _stitch_chunk cuts from them.  The JAX
    engine's GSPAN = 2*Lpad+520 misses the flush-right insertion window
    (3*Lpad+262) once Lpad > 258."""
    return 3 * Lpad + 12, max(2 * Lpad + 520, 3 * Lpad + 263)


# --------------------------------------------------------------------------
# window layer
# --------------------------------------------------------------------------

def _ar(n, dev):
    return torch.arange(n, dtype=I32, device=dev)


def _cut(x, col0, width):
    """x[i, col0_i : col0_i + width] (one gather; the columns must lie in x)"""
    idx = col0[:, None].long() + torch.arange(width, device=x.device)
    return torch.gather(x, 1, idx)


def _fetch_region(tabf, byte_off, span):
    """[A, span] uint8 region starting at logical byte_off of a _prep_table'd
    table (the front pad absorbs offsets down to -FRONT_PAD, so the position
    <-> column mapping is exact).  A span wider than one 2 KiB row allows
    (TILE + 1 bytes from any alignment) takes further rows, 2 KiB apart, in
    the same fetch_rows launch.  Each row start is clamped into the table;
    a row holding any real byte (below the table's unpadded end) never is,
    so clamping touches only junk lanes and bytes the callers mask."""
    n = tabf.numel()
    m = _ceil_div(TILE - 1 + span, FET)
    off = (byte_off.long() + FRONT_PAD).clamp_(0, n - FET)
    if m == 1:
        rows = fetch.fetch_rows(tabf, off)
    else:
        offs = off[:, None] + FET * torch.arange(m, device=off.device)
        rows = fetch.fetch_rows(tabf, offs.clamp_(max=n - FET).reshape(-1))
        rows = rows.reshape(off.shape[0], m * FET)
    return _cut(rows.view(torch.uint8), off % TILE, span)


def _gcut(region, col0, width, g0, n_g, g_first, g_last):
    """cut [A, width] from a genome region whose column c maps to genome
    position g0 + c; replicate numpy clip semantics at the table edges.
    col0 is a per-lane int32 tensor or a static int."""
    dev = region.device
    if isinstance(col0, int):
        w = region[:, col0:col0 + width].to(I32)
        pos = g0[:, None] + col0 + _ar(width, dev)[None, :]
    else:
        w = _cut(region, col0, width).to(I32)
        pos = (g0 + col0)[:, None] + _ar(width, dev)[None, :]
    w = torch.where(pos < 0, g_first, w)
    return torch.where(pos >= n_g, g_last, w)


def _rcut(region, col0, width, r0, lmax):
    """cut [A, width] from a read region whose column c maps to read
    position r0 + c; PAD_BASE outside [0, lmax) (numpy _rwin semantics)."""
    dev = region.device
    if isinstance(col0, int):
        w = region[:, col0:col0 + width].to(I32)
        pos = r0[:, None] + col0 + _ar(width, dev)[None, :]
    else:
        w = _cut(region, col0, width).to(I32)
        pos = (r0 + col0)[:, None] + _ar(width, dev)[None, :]
    return torch.where((pos < 0) | (pos >= lmax), PAD_BASE, w)


def _first_true(cond, big):
    idx = cond.to(torch.uint8).argmax(dim=1).to(I32)
    return torch.where(cond.any(dim=1), idx, big)


def _argmax_first(cond):
    """jnp.argmax over a bool row: the first True, 0 where there is none"""
    return cond.to(torch.uint8).argmax(dim=1).to(I32)


def _ex_get(exr, e_idx, field):
    """column e_idx*5+field per lane; 0 where the column does not exist"""
    col = e_idx * 5 + field
    v = torch.gather(exr, 1, col.long().clamp(0, exr.shape[1] - 1)[:, None])
    return torch.where((col >= 0) & (col < exr.shape[1]), v[:, 0], 0)


def _ex_set(exr, e_idx, field, val, mask):
    col = e_idx * 5 + field
    sel = (_ar(exr.shape[1], exr.device)[None, :] == col[:, None]) \
        & mask[:, None]
    return torch.where(sel, val[:, None], exr)


_sj_set = _ex_set


def _sjdb_find_dev(sj_s2, sj_e2, sj_idx, jS, jE):
    """first junction with (start, end) == (jS, jE): lexicographic lower
    bound over the (start, end)-sorted tables, then an equality check
    (numpy sjdb_find_vec semantics; int32-safe, no int64 keys)."""
    n = sj_s2.shape[0]
    lo = torch.zeros_like(jS)
    hi = torch.full_like(jS, n)
    for _ in range(max(int(n).bit_length(), 1)):
        run = lo < hi
        mid = (lo + hi) // 2
        midc = mid.long().clamp(0, n - 1)
        ms = sj_s2[midc]
        me = sj_e2[midc]
        lt = (ms < jS) | ((ms == jS) & (me < jE))
        lo = torch.where(run & lt, mid + 1, lo)
        hi = torch.where(run & ~lt, mid, hi)
    pos = lo.long().clamp(0, n - 1)
    found = (lo < n) & (sj_s2[pos] == jS) & (sj_e2[pos] == jE)
    return torch.where(found, sj_idx[pos], -1)


# --------------------------------------------------------------------------
# extend (reference extendAlign.cpp:6-92), per-lane to_end + both directions
# --------------------------------------------------------------------------

def extend_dev(Gf, n_g, RSf, lmax, floor16f, ceil_tab, ntab, row, r0, g0,
               dR, dG, L, l_prev, nmm_prev, nmm_max, to_end, Lwin):
    """dR/dG: +1/-1 python ints.  to_end: [A] bool.  Returns
    (ok, extendL, maxScore, nMatch, nMM) int32 tensors.  Mirrors numpy
    extend_vec; the float64 mismatch caps are exact u16 floor-table
    entries and ceil-table entries."""
    dev = row.device
    k = _ar(Lwin, dev)[None, :]
    rix = r0[:, None] + dR * k
    gix = g0[:, None] + dG * k
    gin = (gix >= 0) & (gix < n_g)
    rout = (rix < 0) | (rix >= lmax)
    if dR == 1:
        Rreg = _fetch_region(RSf, row * lmax + r0, Lwin)
    else:
        Rreg = torch.flip(_fetch_region(RSf, row * lmax + r0 - (Lwin - 1),
                                        Lwin), [1])
    Rv = torch.where(rout, PAD_BASE, Rreg.to(I32))
    if dG == 1:
        Greg = _fetch_region(Gf, g0, Lwin)
    else:
        Greg = torch.flip(_fetch_region(Gf, g0 - (Lwin - 1), Lwin), [1])
    Gv = torch.where(gin, Greg.to(I32), 5)
    inL = k < L[:, None]
    spac = Rv == MARK_FRAG_SPACER_BASE
    gbad = ~gin | (Gv == 5)
    BIG = 1 << 29

    skip = (Rv > 3) | (Gv > 3)
    match0 = ~skip & (Gv == Rv)
    mm0 = ~skip & (Gv != Rv)

    # ---------------- to_end branch
    p_cat = _first_true(gbad & inL, BIG)
    p_spac = _first_true(spac, BIG)
    p_end = torch.minimum(p_spac, L)
    cat = (p_cat < L) & (p_cat <= p_spac)
    valid_e = k < p_end[:, None]
    sc = valid_e & ~skip
    match_e = sc & (Gv == Rv)
    mm_e = sc & (Gv != Rv)
    i_ext = p_end
    nmatch_e = match_e.sum(dim=1).to(I32)
    nmm_e = mm_e.sum(dim=1).to(I32)
    score_e = nmatch_e - nmm_e
    ok_e = cat | (i_ext > 0)
    extl_e = torch.where(cat, 0, torch.where(i_ext > 0, i_ext, 0))
    ms_e = torch.where(cat, -999999999, score_e)
    nmatch_e = torch.where(cat, 0, nmatch_e)
    nmm_e = torch.where(cat, nmm_max + 1, nmm_e)

    # ---------------- local branch
    brk = ~inL | gbad | spac
    p_brk = _first_true(brk, BIG)
    mm0i = mm0.to(I32)
    mm_excl = mm0i.cumsum(dim=1, dtype=I32) - mm0i
    # cap_brk = min(p_mm*(l_prev+L) [f64], nmm_max); int m >= cap <=> m >= ceil
    tl_brk = (l_prev + L).clamp(0, ntab - 1)
    cap_brk_c = torch.minimum(ceil_tab[tl_brk.long()], nmm_max)
    # cap_rec entries come from the u16 floor table
    tl0 = (l_prev + 1).clamp(0, ntab - 1)
    freg = _fetch_region(floor16f, 2 * tl0, 2 * Lwin).to(I32)
    floor_win = freg[:, 0::2] | (freg[:, 1::2] << 8)
    # entries past the table end never matter (ntab covers every legal
    # l_prev + k + 1; only masked junk lanes can index past it)
    over_end = (tl0[:, None] + k) > (ntab - 1)
    p_mmbrk = _first_true(
        mm0 & ((mm_excl + nmm_prev[:, None]) >= cap_brk_c[:, None]), BIG)
    p_stop = torch.minimum(p_brk, p_mmbrk)
    valid = k < p_stop[:, None]
    match = match0 & valid
    mm = mm0 & valid
    matchi = match.to(I32)
    mmi = mm.to(I32)
    s = (matchi - mmi).cumsum(dim=1, dtype=I32)
    # cap_rec = min(p_mm*(l_prev+k+1), nmm_max); int m <= cap <=> m <= floor
    cap_rec_f = torch.minimum(torch.where(over_end, 65535, floor_win),
                              nmm_max[:, None])
    mm_before = mmi.cumsum(dim=1, dtype=I32) - mmi
    cond = (mm_before + nmm_prev[:, None]) <= cap_rec_f
    cand = match & cond
    sm = torch.where(cand, s, -BIG)
    M = sm.amax(dim=1)
    ok_l = M > 0
    pos = _argmax_first(sm == M[:, None])
    cm = matchi.cumsum(dim=1, dtype=I32)
    cm_pos = torch.gather(cm, 1, pos.long()[:, None])[:, 0]
    mb_pos = torch.gather(mm_before, 1, pos.long()[:, None])[:, 0]
    extl_l = torch.where(ok_l, pos + 1, 0)
    ms_l = torch.where(ok_l, M, 0)
    nmatch_l = torch.where(ok_l, cm_pos, 0)
    nmm_l = torch.where(ok_l, mb_pos, 0)

    pick = to_end
    return (torch.where(pick, ok_e, ok_l),
            torch.where(pick, extl_e, extl_l),
            torch.where(pick, ms_e, ms_l),
            torch.where(pick, nmatch_e, nmatch_l),
            torch.where(pick, nmm_e, nmm_l))


# --------------------------------------------------------------------------
# one candidate chunk: stitch seed s onto [A] lanes
# (mirrors batch_engine.stitch_step_vec + _stitch_same_frag + the first-exon
#  branch of grow_chains, masked full-width)
# --------------------------------------------------------------------------

def _int32_bit(b: int) -> int:
    """1 << b as the value of a two's-complement int32 (b < 32)"""
    v = 1 << b
    return v - (1 << 32) if v >= 1 << 31 else v


def _stitch_chunk(cfg: StitchConfig, Gf, n_g, RSf, lmax,
                  floor16f, ceil_tab, ntab, sjdb, sc, ex, sj, seed, s: int,
                  out):
    """sc [A, NSCAL], ex [A, NEXB], sj [A, NSJB] lane rows;
    seed [A, 8] = (rs, gs, len, frag, sja, nrep, anchor, _).  Writes the lane
    rows with seed s applied into out = (sc, ex, sj) views and returns ok."""
    A = sc.shape[0]
    dev = sc.device
    Lpad = cfg.Lpad
    z = torch.zeros(A, dtype=I32, device=dev)

    rB = seed[:, 0]
    gB = seed[:, 1]
    L = seed[:, 2]
    fragB = seed[:, 3]
    sjA = seed[:, 4]
    nrepB = seed[:, 5]
    anchB = seed[:, 6]

    nE = sc[:, C_NEX]
    last = torch.clamp(nE - 1, min=0)
    tR2 = sc[:, C_TR2]
    tG2 = sc[:, C_TG2]
    row = sc[:, C_ROW]
    nmm_max = sc[:, C_NMMMAX]
    exlen_last = _ex_get(ex, last, EX_LEN)
    exgs_last = _ex_get(ex, last, EX_GS)
    last_sja = _ex_get(ex, last, EX_SJA)
    last_frag = _ex_get(ex, last, EX_FRAG)
    ex_rs0 = ex[:, EX_RS]
    ex_gs0 = ex[:, EX_GS]

    first = nE == 0
    # ---- first-exon branch result (computed unconditionally, cheap)
    sc_f = sc.clone()
    sc_f[:, C_NMATCH] = L
    sc_f[:, C_SCORE] = SCORE_MATCH * L
    sc_f[:, C_TR2] = rB + L - 1
    sc_f[:, C_TG2] = gB + L - 1
    sc_f[:, C_NUNIQ] = (nrepB == 1).to(I32)
    sc_f[:, C_NANCH] = (anchB > 0).to(I32)
    sc_f[:, C_NEX] = 1
    ex_f = ex.clone()
    for fld, val in ((EX_RS, rB), (EX_GS, gB), (EX_LEN, L),
                     (EX_FRAG, fragB), (EX_SJA, sjA)):
        ex_f[:, fld] = val

    # ---- stitch branch
    capm = nE >= E
    dead = capm
    annotb = ~capm & (sjA != -1) & (last_sja == sjA) \
        & (last_frag == fragB) & (rB == tR2 + 1) & (tG2 + 1 < gB)
    samef = ~capm & ~annotb & (last_frag == fragB)
    mate_gate = (gB + ex_rs0 + cfg.protrude_max >= ex_gs0) \
        | (ex_gs0 < ex_rs0)
    mateb = ~capm & ~annotb & ~samef & mate_gate
    dead = dead | (~capm & ~annotb & ~samef & ~mate_gate)

    d_score = z
    # accumulated per-branch structural edits
    ex_s = ex
    sj_s = sj
    sc_s = sc.clone()

    def add(c, condv, v):
        sc_s[:, c] = torch.where(condv, sc_s[:, c] + v, sc_s[:, c])

    # ================= annotated-junction path =================
    if cfg.has_sjdb:
        sj_s2, sj_e2, sj_ordidx, sj_motif, sj_shl, sj_shr, sj_strand = sjdb
        sjc = sjA.long().clamp(0, sj_motif.shape[0] - 1)
        a_motif = sj_motif[sjc]
        a_shl = sj_shl[sjc]
        a_shr = sj_shr[sjc]
        a_str = sj_strand[sjc]
        a_rej = (a_motif == 0) & ((L <= a_shr) | (exlen_last <= a_shl))
        dead = dead | (annotb & a_rej)
        a_ok = annotb & ~a_rej
        jpos = last
        sj_s = _sj_set(sj_s, jpos, SJ_CAN, a_motif, a_ok)
        sj_s = _sj_set(sj_s, jpos, SJ_SHL, a_shl, a_ok)
        sj_s = _sj_set(sj_s, jpos, SJ_SHR, a_shr, a_ok)
        sj_s = _sj_set(sj_s, jpos, SJ_ANNOT, z + 1, a_ok)
        sj_s = _sj_set(sj_s, jpos, SJ_STR, a_str, a_ok)
        for fld, val in ((EX_RS, rB), (EX_GS, gB), (EX_LEN, L),
                         (EX_FRAG, fragB), (EX_SJA, sjA)):
            ex_s = _ex_set(ex_s, nE, fld, val, a_ok)
        sc_s[:, C_NEX] = torch.where(a_ok, nE + 1, sc_s[:, C_NEX])
        # the new exon's bases count as matches (numpy stitch_step_vec; the
        # JAX engine computes this sum and drops it)
        add(C_NMATCH, a_ok, L)
        d_score = torch.where(a_ok, SCORE_MATCH * L + cfg.sjdb_score, d_score)

    # ================= same-fragment path =================
    ra = tR2
    ga = tG2
    r_b_end = rB + L - 1
    rej = (r_b_end <= ra) | (gB + L - 1 <= ga)
    trim = torch.clamp(ra + 1 - rB, min=0)
    rb = rB + trim
    gb = gB + trim
    Ls = r_b_end - rb + 1
    base_score = SCORE_MATCH * Ls
    g_gap = gb - ga - 1
    r_gap = rb - ra - 1
    gb1 = gb - r_gap - 1
    exlen = exlen_last

    delb = ~rej & (g_gap > r_gap)
    insb = ~rej & (r_gap > g_gap)
    rej = rej | (~delb & ~insb)            # fill/merge: -1000007

    n_mm = z
    n_match = Ls
    extra = z
    jR = z
    j_can = z + 999
    jjL = z
    jjR = z
    delv = torch.where(delb, g_gap - r_gap, 0)
    insv = torch.where(insb, r_gap - g_gap, 0)
    annot_fl = z
    sjstr = z

    W1 = Lpad + 2
    WSC = 2 * Lpad + 5
    WI = Lpad + 2
    offk = _ar(WSC, dev)[None, :] - W1    # off = -W1 .. Lpad+2

    # ---- per-lane window layer: three fetched regions per lane, every
    # window cut out of them
    p0r = ra - W1
    pgd = ga - W1 - 257
    pga = gb1 - W1 - 257
    RSPAN, GSPAN = region_spans(Lpad)
    g_first = Gf[FRONT_PAD].to(I32)
    g_last = Gf[FRONT_PAD + n_g - 1].to(I32)
    Rreg = _fetch_region(RSf, row * lmax + p0r, RSPAN)
    Dreg = _fetch_region(Gf, pgd, GSPAN)
    Areg = _fetch_region(Gf, pga, GSPAN)

    # ------------------------- deletion / intron -------------------------
    di = delb
    if cfg.intron_max > 0:
        rej3 = di & (delv > cfg.intron_max)
        rej = rej | rej3
        di = di & ~rej3
    intron = delv >= cfg.intron_min
    Rv = _rcut(Rreg, 0, WSC, p0r, lmax)
    Gd = _gcut(Dreg, 257, WSC, pgd, n_g, g_first, g_last)
    Ga = _gcut(Areg, 257, WSC, pga, n_g, g_first, g_last)
    neg = offk <= 0
    dec = (Rv != Ga) & (Ga < 4) & (Rv == Gd) & neg
    cum_fr = torch.flip(torch.flip(dec, [1]).to(I32).cumsum(dim=1, dtype=I32),
                        [1])
    cd = torch.where(neg, cum_fr, 0)
    fail = neg & ((cd > cfg.stitch_sj_shift)
                  | (exlen[:, None] + offk <= 1))
    okey = torch.where(fail, offk, NEG)
    jR1s = okey.amax(dim=1)
    hi_o = r_b_end - ra - 1
    scan = (offk >= jR1s[:, None]) & (offk <= hi_o[:, None])
    up = (Rv == Gd) & (Rv != Ga)
    dn = (Rv != Gd) & (Rv == Ga)
    contrib = torch.where(scan, up.to(I32) - dn.to(I32), 0)
    score1 = contrib.cumsum(dim=1, dtype=I32)
    d1 = torch.cat([Gd[:, 1:], Gd[:, -1:]], dim=1)
    d2 = torch.cat([Gd[:, 2:], Gd[:, -1:], Gd[:, -1:]], dim=1)
    a1v = torch.cat([Ga[:, :1], Ga[:, :-1]], dim=1)
    a2v = Ga
    can = torch.zeros((A, WSC), dtype=I32, device=dev)
    can = torch.where((d1 == 2) & (d2 == 3) & (a1v == 0) & (a2v == 2), 1, can)
    can = torch.where((can == 0) & (d1 == 1) & (d2 == 3) & (a1v == 0)
                      & (a2v == 1), 2, can)
    can = torch.where((can == 0) & (d1 == 2) & (d2 == 1) & (a1v == 0)
                      & (a2v == 2), 3, can)
    can = torch.where((can == 0) & (d1 == 1) & (d2 == 3) & (a1v == 2)
                      & (a2v == 1), 4, can)
    can = torch.where((can == 0) & (d1 == 0) & (d2 == 3) & (a1v == 0)
                      & (a2v == 1), 5, can)
    can = torch.where((can == 0) & (d1 == 2) & (d2 == 3) & (a1v == 0)
                      & (a2v == 3), 6, can)
    pen = torch.zeros((A, WSC), dtype=I32, device=dev)
    pen = torch.where(can == 0, cfg.score_gap_noncan, pen)
    pen = torch.where((can == 3) | (can == 4), cfg.score_gap_gcag, pen)
    pen = torch.where((can == 5) | (can == 6), cfg.score_gap_atac, pen)
    can = torch.where(intron[:, None], can, -1)
    pen = torch.where(intron[:, None], pen, 0)
    score2 = score1 + pen
    sm = torch.where(scan, score2, NEG)
    M = sm.amax(dim=1)
    pos = _argmax_first(sm == M[:, None])
    jR_d = pos - W1
    can_d = torch.gather(can, 1, pos.long()[:, None])[:, 0]
    j_pen = torch.gather(pen, 1, pos.long()[:, None])[:, 0]
    jR = torch.where(di, jR_d, jR)
    j_can = torch.where(di, can_d, j_can)
    # repeat scans
    jj = _ar(RPT + 1, dev)[None, :]
    gd_i = (ga + jR)[:, None] - jj
    # descending windows: ascending cut from the region, then flip
    gdv = torch.flip(_gcut(Dreg, jR + W1 + 1, RPT + 1, pgd, n_g,
                           g_first, g_last), [1])
    gav = torch.flip(_gcut(Areg, jR + W1 + 1, RPT + 1, pga, n_g,
                           g_first, g_last), [1])
    cl = (gd_i >= 0) & (gdv == gav) & (gdv < 4) & (jj <= 255)
    jjL_d = _argmax_first(~cl)
    gd_i = (ga + jR + 1)[:, None] + jj
    gdv = _gcut(Dreg, jR + W1 + 258, RPT + 1, pgd, n_g, g_first, g_last)
    gav = _gcut(Areg, jR + W1 + 258, RPT + 1, pga, n_g, g_first, g_last)
    cl = (gd_i < n_g) & (gdv == gav) & (gdv < 4) & (jj <= 255)
    jjR_d = _argmax_first(~cl)
    jjL = torch.where(di, jjL_d, jjL)
    jjR = torch.where(di, jjR_d, jjR)
    # flush left
    flush = di & (j_can <= 0)
    jR = torch.where(flush, jR - jjL, jR)
    rej5 = flush & (exlen + jR < 1)
    jjR = torch.where(flush, jjR + jjL, jjR)
    jjL = torch.where(flush, 0, jjL)
    rej = rej | rej5
    # mismatch-fill scan around the junction
    lo_ii = torch.clamp(jR + 1, max=1)
    hi_ii = torch.maximum(r_gap, jR)
    inr = (offk >= lo_ii[:, None]) & (offk <= hi_ii[:, None])
    g1v = torch.where(offk <= jR[:, None], Gd, Ga)
    scor = inr & (g1v < 4) & (Rv < 4)
    eq = scor & (Rv == g1v)
    in_rgap = (offk >= 1) & (offk <= r_gap[:, None])
    eq_in = (eq & in_rgap).sum(dim=1).to(I32)
    mm_all = (scor & ~eq).sum(dim=1).to(I32)
    out_mm = (scor & ~eq & ~in_rgap).sum(dim=1).to(I32)
    n_match = torch.where(di, n_match + eq_in - out_mm, n_match)
    extra = torch.where(di, extra + eq_in - mm_all - out_mm, extra)
    n_mm = torch.where(di, n_mm + mm_all, n_mm)
    # sjdb-annotated override + gap scoring
    jS = ga + jR + 1
    jE = gb1 + jR
    if cfg.has_sjdb:
        ind = _sjdb_find_dev(sj_s2, sj_e2, sj_ordidx, jS, jE)
        found = di & (ind >= 0)
    else:
        found = torch.zeros(A, dtype=torch.bool, device=dev)
    nf = di & ~found
    extra = extra + torch.where(nf & intron, cfg.score_gap + j_pen, 0)
    extra = extra + torch.where(
        nf & ~intron, delv * cfg.score_del_base + cfg.score_del_open, 0)
    j_can = torch.where(nf & ~intron, -1, j_can)
    annot_fl = torch.where(found, 1, annot_fl)
    if cfg.has_sjdb:
        indc = ind.long().clamp(0, sj_motif.shape[0] - 1)
        f_motif = sj_motif[indc]
        f_shl = sj_shl[indc]
        f_shr = sj_shr[indc]
        f_str = sj_strand[indc]
        j_can = torch.where(found, f_motif, j_can)
        m0 = found & (f_motif == 0)
        rej6 = m0 & ((Ls <= f_shl) | (exlen <= f_shl))
        jR = torch.where(m0, jR + f_shl, jR)
        rej6 = rej6 | (m0 & (ra + jR >= r_b_end))
        jjL = torch.where(m0, f_shl, jjL)
        jjR = torch.where(m0, f_shr, jjR)
        rej = rej | rej6
        sjstr = torch.where(found, f_str, sjstr)
        extra = extra + torch.where(found, cfg.sjdb_score, 0)
    sjstr = torch.where(di & (annot_fl == 0),
                        torch.where(j_can > 0, 2 - j_can % 2, 0), sjstr)

    # ----------------------------- insertion -----------------------------
    ii_b = insb & ~rej
    offp = _ar(WI, dev)[None, :]
    Rvp = _rcut(Rreg, W1, WI, p0r, lmax)
    Rv2p = _rcut(Rreg, W1 + insv.clamp(0, Lpad), WI, p0r, lmax)
    Gdp = _gcut(Dreg, 257 + W1, WI, pgd, n_g, g_first, g_last)
    inrp = (offp >= 1) & (offp <= g_gap[:, None])
    gok = Gdp < 4
    c1 = torch.where(inrp & gok,
                     2 * (Rvp == Gdp).to(I32) - 2 * (Rv2p == Gdp).to(I32), 0)
    score1p = c1.cumsum(dim=1, dtype=I32)
    smaskp = torch.where(inrp, score1p, NEG)
    Mp = torch.clamp(smaskp.amax(dim=1), min=0)
    hit = smaskp == Mp[:, None]
    if cfg.ins_flush_right:
        has_hit = hit.any(dim=1)
        last_pos = torch.where(
            has_hit, WI - 1 - _argmax_first(torch.flip(hit, [1])), 0)
        jR_i = torch.where((Mp > 0) | (has_hit & (Mp == 0)), last_pos, 0)
    else:
        jR_i = torch.where(Mp > 0, _argmax_first(hit), 0)
    extra = extra + torch.where(ii_b & (g_gap < 0), SCORE_MATCH * g_gap, 0)
    rsel = torch.where(offp <= jR_i[:, None], Rvp, Rv2p)
    scorp = inrp & gok & (rsel < 4)
    eqp = scorp & (rsel == Gdp)
    eq_n = eqp.sum(dim=1).to(I32)
    mm_n = (scorp & ~eqp).sum(dim=1).to(I32)
    n_match = torch.where(ii_b, n_match + eq_n, n_match)
    extra = torch.where(ii_b, extra + eq_n - mm_n, extra)
    n_mm = torch.where(ii_b, n_mm + mm_n, n_mm)
    if cfg.ins_flush_right:
        lim = r_b_end - ra - insv
        jRc = jR_i.clamp(0, Lpad)
        Rv3 = _rcut(Rreg, W1 + 1 + jRc, WI, p0r, lmax)
        Gd3 = _gcut(Dreg, W1 + 258 + jRc, WI, pgd, n_g, g_first, g_last)
        failf = (jR_i[:, None] + offp >= lim[:, None]) | (Rv3 != Gd3) \
            | (Gd3 == 4)
        jR_i = jR_i + _argmax_first(failf)
        rej = rej | (ii_b & (jR_i == lim))
    extra = torch.where(
        ii_b, extra + insv * cfg.score_ins_base + cfg.score_ins_open, extra)
    jR = torch.where(ii_b, jR_i, jR)
    j_can = torch.where(ii_b, -2, j_can)

    # ----------------------------- accept -----------------------------
    cls = ((j_can + 1) // 2).clamp(0, 3)
    lim_mm = torch.tensor(cfg.sjmm, dtype=I32, device=dev)[cls.long()]
    acc_sf = samef & ~rej & (sc[:, C_NMM] + n_mm <= nmm_max) \
        & ((j_can < 0) | ((j_can < 7) & (n_mm <= lim_mm)))
    dead = dead | (samef & ~acc_sf)

    # apply same-frag accepted edits
    d_score = torch.where(acc_sf, base_score + extra, d_score)
    add(C_NMM, acc_sf, n_mm)
    add(C_NMATCH, acc_sf, n_match)
    is_int = delv >= cfg.intron_min
    add(C_NGAP, acc_sf & is_int & (delv > 0), 1)
    add(C_LGAP, acc_sf & is_int, delv)
    add(C_NDEL, acc_sf & ~is_int & (delv > 0), 1)
    add(C_LDEL, acc_sf & ~is_int, delv)
    # deletion/intron: split exon at jR
    dd = acc_sf & (delv > 0)
    ne1 = last
    cur_len = _ex_get(ex_s, ne1, EX_LEN)
    ex_s = _ex_set(ex_s, ne1, EX_LEN, cur_len + jR, dd)
    sj_s = _sj_set(sj_s, ne1, SJ_CAN, j_can, dd)
    sj_s = _sj_set(sj_s, ne1, SJ_SHL, jjL, dd)
    sj_s = _sj_set(sj_s, ne1, SJ_SHR, jjR, dd)
    sj_s = _sj_set(sj_s, ne1, SJ_ANNOT, annot_fl, dd)
    sj_s = _sj_set(sj_s, ne1, SJ_STR, sjstr, dd)
    for fld, val in ((EX_RS, ra + jR + 1), (EX_GS, gb1 + jR + 1),
                     (EX_LEN, r_b_end - ra - jR), (EX_FRAG, fragB),
                     (EX_SJA, sjA)):
        ex_s = _ex_set(ex_s, nE, fld, val, dd)
    # insertion: split exon at jR
    ddi = acc_sf & (insv > 0)
    add(C_NINS, ddi, 1)
    add(C_LINS, ddi, insv)
    cur_len = _ex_get(ex_s, ne1, EX_LEN)
    ex_s = _ex_set(ex_s, ne1, EX_LEN, cur_len + torch.where(ddi, jR, 0), ddi)
    sj_s = _sj_set(sj_s, ne1, SJ_CAN, z - 2, ddi)
    for fld in (SJ_SHL, SJ_SHR, SJ_ANNOT, SJ_STR):
        sj_s = _sj_set(sj_s, ne1, fld, z, ddi)
    for fld, val in ((EX_RS, ra + jR + insv + 1), (EX_GS, ga + 1 + jR),
                     (EX_LEN, r_b_end - ra - jR - insv), (EX_FRAG, fragB),
                     (EX_SJA, sjA)):
        ex_s = _ex_set(ex_s, nE, fld, val, ddi)
    grew = dd | ddi
    sc_s[:, C_NEX] = torch.where(grew, nE + 1, sc_s[:, C_NEX])

    # ================= mate path (PE only) =================
    if cfg.has_pe:
        mrej = torch.zeros(A, dtype=torch.bool, device=dev)
        if cfg.mates_gap_max > 0:
            mrej = mateb & (gB > exgs_last + exlen_last + cfg.mates_gap_max)
            dead = dead | mrej
        mb = mateb & ~mrej
        d_m = SCORE_MATCH * L
        ext_end = torch.tensor([cfg.ends_ext[0][1], cfg.ends_ext[1][1]],
                               device=dev)
        te1 = ext_end[last_frag.long().clamp(0, 1)]
        ok1, eL1, ms1, nM1, nMM1 = extend_dev(
            Gf, n_g, RSf, lmax, floor16f, ceil_tab, ntab, row,
            tR2 + 1, tG2 + 1, 1, 1, z + 650,
            sc_s[:, C_NMATCH], sc_s[:, C_NMM], nmm_max, te1, Lpad + 2)
        u1 = mb & ok1
        add(C_NMATCH, u1, nM1)
        add(C_NMM, u1, nMM1)
        d_m = d_m + torch.where(u1, ms1, 0)
        ne_last = torch.clamp(sc_s[:, C_NEX] - 1, min=0)
        cur = _ex_get(ex_s, ne_last, EX_LEN)
        ex_s = _ex_set(ex_s, ne_last, EX_LEN, cur + eL1, u1)
        # junction -3 + new exon for mate B
        jpos = last
        sj_s = _sj_set(sj_s, jpos, SJ_CAN, z - 3, mb)
        for fld in (SJ_SHL, SJ_SHR, SJ_ANNOT, SJ_STR):
            sj_s = _sj_set(sj_s, jpos, fld, z, mb)
        for fld, val in ((EX_RS, rB), (EX_GS, gB), (EX_LEN, L),
                         (EX_FRAG, fragB), (EX_SJA, sjA)):
            ex_s = _ex_set(ex_s, nE, fld, val, mb)
        sc_s[:, C_NEX] = torch.where(mb, nE + 1, sc_s[:, C_NEX])
        add(C_NMATCH, mb, L)
        # backward extension of mate B start
        te2 = ext_end[fragB.long().clamp(0, 1)]
        extlen = torch.where(te2, 650, gB - ex_gs0 + ex_rs0)
        ok2, eL2, ms2, nM2, nMM2 = extend_dev(
            Gf, n_g, RSf, lmax, floor16f, ceil_tab, ntab, row,
            rB - 1, gB - 1, -1, -1, extlen,
            sc_s[:, C_NMATCH], sc_s[:, C_NMM], nmm_max, te2, Lpad + 2)
        u2 = mb & ok2
        add(C_NMATCH, u2, nM2)
        add(C_NMM, u2, nMM2)
        d_m = d_m + torch.where(u2, ms2, 0)
        ne_last = torch.clamp(sc_s[:, C_NEX] - 1, min=0)
        for fld, dv in ((EX_RS, -eL2), (EX_GS, -eL2), (EX_LEN, eL2)):
            cur = _ex_get(ex_s, ne_last, fld)
            ex_s = _ex_set(ex_s, ne_last, fld, cur + dv, u2)
        d_score = torch.where(mb, d_m, d_score)

    # ================= final accept =================
    acc = ~dead & ~first
    sc_s[:, C_SCORE] = torch.where(acc, sc_s[:, C_SCORE] + d_score,
                                   sc_s[:, C_SCORE])
    sc_s[:, C_TR2] = torch.where(acc, rB + L - 1, sc_s[:, C_TR2])
    sc_s[:, C_TG2] = torch.where(acc, gB + L - 1, sc_s[:, C_TG2])
    add(C_NUNIQ, acc & (nrepB == 1), 1)
    add(C_NANCH, acc & (anchB > 0), 1)

    # merge first-exon and stitch branches
    sc_out, ex_out, sj_out = out
    f2 = first[:, None]
    torch.where(f2, sc_f, sc_s, out=sc_out)
    torch.where(f2, ex_f, ex_s, out=ex_out)
    torch.where(f2, sj, sj_s, out=sj_out)
    # set mask bit s on the new lane
    word = C_MASK_LO if s < 32 else C_MASK_HI
    sc_out[:, word] |= torch.tensor(_int32_bit(s % 32), dtype=I32, device=dev)
    return first | acc


# --------------------------------------------------------------------------
# the two-queue grow engine
# --------------------------------------------------------------------------

def _alloc_rows(n: int, C: int, dev):
    """an [n, C] int32 row matrix and the int8 table that backs it: 16-byte
    aligned, a multiple of 1024 bytes, with FET + TILE bytes of slack past
    the last row, so the table is a valid fetch_rows table as it is"""
    nb = _round_up(n * C * 4 + FET + TILE, TILE)
    tab = torch.zeros(nb, dtype=torch.int8, device=dev)
    return tab[:n * C * 4].view(I32).view(n, C), tab


def _rowcopy(M, tab, idx):
    """M[idx] for an int32 row matrix backed by the fetch table tab: one
    aligned fetch_rows row per lane, the lane's bytes cut out of it"""
    rb = M.shape[1] * 4
    off = idx.long() * rb
    rows = fetch.fetch_rows(tab, off)
    return _cut(rows, off % TILE, rb).view(I32)


def make_grow_engine2(cfg: StitchConfig, AMAX: int, RMAX: int, A_CAP: int,
                      NP: int, B: int, lmax: int, n_g: int, ntab: int):
    """two-queue grow engine: the ACTIVE lanes live in a contiguous queue
    (a chunk is a slice of it, at most A_CAP lanes), and completed chains
    move to an append-only RETIRED buffer at each step boundary.

    Returns grow(Gf, RSf, rows [NW, 8], pm [NP, 8], floor16f, ceil_tab,
                 sjdb (7 tensors), fb0 [B], s_hi)
        -> (R_SC [n_ret, NSCAL], R_EX, R_SJ, n_ret, fb, cnt, overflow,
            n_iter).
    overflow: 0 done; 1 the active queue or the retired buffer overflowed;
    2 the iteration cap stopped the loop before the last step."""
    s_max = cfg.s_max
    ATOT = AMAX + A_CAP       # append slack
    RTOT = RMAX + AMAX        # retirement-block slack
    IT_MAX = s_max * (ATOT // A_CAP + 3) + 8

    def grow(Gf, RSf, rows, pm, floor16f, ceil_tab, sjdb, fb0, s_hi):
        dev = Gf.device
        NW = rows.shape[0]
        A_SC, A_SCt = _alloc_rows(ATOT, NSCAL, dev)
        A_EX, A_EXt = _alloc_rows(ATOT, NEXB, dev)
        A_SJ, A_SJt = _alloc_rows(ATOT, NSJB, dev)
        R_SC = torch.zeros((RTOT, NSCAL), dtype=I32, device=dev)
        R_EX = torch.zeros((RTOT, NEXB), dtype=I32, device=dev)
        R_SJ = torch.zeros((RTOT, NSJB), dtype=I32, device=dev)
        S_SC, S_SCt = _alloc_rows(A_CAP, NSCAL, dev)      # chunk output
        S_EX, S_EXt = _alloc_rows(A_CAP, NEXB, dev)
        S_SJ, S_SJt = _alloc_rows(A_CAP, NSJB, dev)

        A_SC[:NP, C_PROW] = _ar(NP, dev)
        for col, src in ((C_WAN, 1), (C_PB, 2), (C_PW, 3), (C_WSTR, 4),
                         (C_ROW, 5), (C_NMMMAX, 6)):
            A_SC[:NP, col] = pm[:, src]
        A_EX[:NP, EX_SJA::5] = -1

        n_act = NP        # lanes valid for the CURRENT step
        n_app = NP        # total incl. this step's appends
        n_ret = 0
        cnt = (pm[:, 1] > 0).to(I32)
        fb = fb0.to(I32).clone()
        pb_all = pm[:, 2].long().clamp(0, B - 1)
        waoff = pm[:, 0]
        s = c = overflow = it = 0

        while s < s_hi and n_act > 0 and overflow == 0 and it < IT_MAX:
            # ---- one chunk of the current step
            base = c * A_CAP
            n = min(A_CAP, n_act - base)
            sc = A_SC[base:base + n]
            prow = sc[:, C_PROW].long().clamp(0, NP - 1)
            fb_l = fb[sc[:, C_PB].long().clamp(0, B - 1)] > 0
            # the initial queue holds one lane per (possibly already
            # exhausted) pair; only pairs with seed s may stitch
            act = ~fb_l & (s < sc[:, C_WAN])
            seed = rows[(waoff[prow] + s).long().clamp(0, NW - 1)]
            ok = _stitch_chunk(cfg, Gf, n_g, RSf, lmax, floor16f,
                               ceil_tab, ntab, sjdb, sc, A_EX[base:base + n],
                               A_SJ[base:base + n], seed, s,
                               (S_SC[:n], S_EX[:n], S_SJ[:n])) & act
            aidx = ok.nonzero()[:, 0]
            n_new = aidx.numel()
            if n_new:
                new = slice(n_app, n_app + n_new)
                A_SC[new] = _rowcopy(S_SC, S_SCt, aidx)
                A_EX[new] = _rowcopy(S_EX, S_EXt, aidx)
                A_SJ[new] = _rowcopy(S_SJ, S_SJt, aidx)
                n_app += n_new
                if n_app > AMAX:
                    overflow = 1
                cnt.index_add_(0, A_SC[new, C_PROW].long().clamp(0, NP - 1),
                               torch.ones(n_new, dtype=I32, device=dev))
                fb.scatter_reduce_(0, pb_all, (cnt > cfg.chain_cap).to(I32),
                                   "amax", include_self=True)
            c += 1
            it += 1
            if overflow or c * A_CAP < n_act:
                continue
            # ---- step end: compact the queue, retire completed chains
            live = A_SC[:n_app]
            fb_l = fb[live[:, C_PB].long().clamp(0, B - 1)] > 0
            more = live[:, C_WAN] > s + 1
            mask_nz = (live[:, C_MASK_LO] != 0) | (live[:, C_MASK_HI] != 0)
            kidx = (~fb_l & more).nonzero()[:, 0]
            ridx = (~fb_l & ~more & mask_nz).nonzero()[:, 0]
            n_keep, n_r = kidx.numel(), ridx.numel()
            if n_r:
                # the retired rows come from the pre-compaction queue
                ret = slice(n_ret, n_ret + n_r)
                R_SC[ret] = _rowcopy(A_SC, A_SCt, ridx)
                R_EX[ret] = _rowcopy(A_EX, A_EXt, ridx)
                R_SJ[ret] = _rowcopy(A_SJ, A_SJt, ridx)
                n_ret += n_r
                if n_ret > RMAX:
                    overflow = 1
            if n_keep:
                kept = [_rowcopy(M, t, kidx) for M, t in
                        ((A_SC, A_SCt), (A_EX, A_EXt), (A_SJ, A_SJt))]
                A_SC[:n_keep], A_EX[:n_keep], A_SJ[:n_keep] = kept
            n_act = n_app = n_keep
            s += 1
            c = 0
        if overflow == 0 and s < s_hi and n_act > 0:
            overflow = 2      # stopped by IT_MAX, not by the last step
        GROW_STATS["iterations"] += it
        GROW_STATS["steps"] += s
        return (R_SC[:n_ret], R_EX[:n_ret], R_SJ[:n_ret], n_ret, fb, cnt,
                overflow, it)

    return grow


# --------------------------------------------------------------------------
# host wrapper: numpy WA tables in -> numpy LaneState out
# --------------------------------------------------------------------------

def device_tables(gi, device):
    """the genome and sjdb tables on `device`, cached on the index object"""
    key = ("stitch", str(device))
    ent = gi._device_cache.get(key)
    if ent is None:
        G = gi.G if gi.G.dtype == np.int8 else gi.G.view(np.int8)
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        Gf = put(_prep_table(G))
        if gi.sjdb_n > 0:
            n = gi.sjdb_n
            order = np.lexsort((np.arange(n), gi.sjdb_end[:n],
                                gi.sjdb_start[:n]))
            sjt = tuple(put(x.astype(np.int32)) for x in (
                gi.sjdb_start[:n][order], gi.sjdb_end[:n][order], order,
                gi.sjdb_motif[:n], gi.sjdb_shift_left[:n],
                gi.sjdb_shift_right[:n], gi.sjdb_strand[:n]))
        else:
            sjt = (put(np.zeros(1, np.int32)),) * 7
        ent = (Gf, sjt)
        gi._device_cache[key] = ent
    return ent


# hard capacity of the active queue and the retired buffer (rows of 896 B):
# about 1.9 and 7.5 GB, well inside an 80 GB card
A_HARD = 1 << 21
R_HARD = 1 << 23


def grow_chains_device(gi, P, st, ws, RS, nmm_max_read, Lpad, s_max,
                       chain_cap, device):
    """the device grow replacing batch_engine.grow_chains for one level run.
    st: WAStateP (numpy), ws: WindowsState.  Mutates st.fallback exactly like
    the numpy engine (chain_cap overflows); capacity overflows retry with
    doubled capacities.  Returns the LaneState in DFS visit order."""
    from .batch_engine import _empty_lanes, _lanes_concat, _lanes_take

    live_pair = (st.wa_n > 0) & ~st.fallback[st.pb]
    if not live_pair.any():
        z = np.zeros(0, np.int64)
        return _lanes_take(_empty_lanes(z, z, z), z)
    GROW_STATS["calls"] += 1
    launches0 = fetch.LAUNCHES
    ctx = grow_context(gi, P, st, ws, RS, nmm_max_read, Lpad, s_max,
                       chain_cap, device)
    pm, wan = ctx.pm, ctx.wan
    NP = len(wan)
    # ---- partition pairs into read-aligned groups bounded by seed budget
    # (pairs of one read stay together so chain-cap suppression matches the
    # numpy engine)
    BUDGET = 1 << 17 if s_max > 16 else 1 << 20
    groups = []
    g0 = 0
    acc = 0
    for i in range(NP):
        acc += int(wan[i])
        if acc >= BUDGET and (i + 1 == NP or pm[i + 1, 2] != pm[i, 2]):
            groups.append((g0, i + 1))
            g0 = i + 1
            acc = 0
    if g0 < NP:
        groups.append((g0, NP))

    out = None
    for (a, b_) in groups:
        part = _run_group(ctx, a, b_)
        out = part if out is None else _lanes_concat(out, part)
    GROW_STATS["fetch_launches"] += fetch.LAUNCHES - launches0
    return out


def grow_context(gi, P, st, ws, RS, nmm_max_read, Lpad, s_max, chain_cap,
                 device):
    """the engine configuration and the tables of one grow call, the WA
    tables of its live pairs flattened (rows [NW, 8]: rs, gs, len, frag, sja,
    nrep, anchor, _; pm [NP, 8]: waoff, wan, pb, pw, wstr, row, nmm, _) and
    everything the device needs uploaded"""
    from .pipeline import _tick

    device = torch.device(device)
    B = ws.n_reads
    has_pe = bool((RS == MARK_FRAG_SPACER_BASE).any())
    cfg = make_config(gi, P, Lpad, s_max, chain_cap, has_pe)

    # ---- flat WA tables (only live pairs)
    live_pair = (st.wa_n > 0) & ~st.fallback[st.pb]
    NP = int(live_pair.sum())
    pidx = np.nonzero(live_pair)[0]
    wan = st.wa_n[pidx].astype(np.int32)
    NW = int(wan.sum())
    waoff = np.zeros(NP, np.int32)
    waoff[1:] = np.cumsum(wan)[:-1]
    rows = np.zeros((NW, 8), np.int32)
    src_p = np.repeat(pidx, wan)
    src_s = np.arange(NW) - np.repeat(waoff, wan)
    rows[:, 0] = st.wa_rs[src_p, src_s]
    rows[:, 1] = st.wa_gs[src_p, src_s]
    rows[:, 2] = st.wa_len[src_p, src_s]
    rows[:, 3] = st.wa_frag[src_p, src_s]
    rows[:, 4] = st.wa_sja[src_p, src_s]
    rows[:, 5] = np.minimum(st.wa_nrep[src_p, src_s], 1 << 30)
    rows[:, 6] = st.wa_anchor[src_p, src_s]

    pm = np.zeros((NP, 8), np.int32)
    pm[:, 0] = waoff
    pm[:, 1] = wan
    pm[:, 2] = st.pb[pidx]
    pm[:, 3] = st.pw[pidx]
    wstr = ws.win_str[st.pb[pidx], st.pw[pidx]].astype(np.int32)
    pm[:, 4] = wstr
    pm[:, 5] = st.pb[pidx].astype(np.int32) + B * wstr
    pm[:, 6] = nmm_max_read[st.pb[pidx]].astype(np.int32)

    ntab = 4 * (Lpad + 16)
    floor_tab, ceil_tab = mm_cap_tables(P.outFilterMismatchNoverLmax, ntab)
    Gf, sjt = device_tables(gi, device)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    with _tick("dev_upload"):
        rs_dev = put(_prep_table(RS.reshape(-1)))
        # the 2-D mismatch-cap lookups read the floor table as little-endian
        # u16 byte regions (see extend_dev)
        ft_dev = put(_prep_table(np.minimum(floor_tab, 65535).astype("<u2")))
        ct_dev = put(ceil_tab)
    return _GrowCtx(gi, st, cfg, rows, pm, wan, pidx, B, RS.shape[1], ntab,
                    Gf, rs_dev, ft_dev, ct_dev, sjt, s_max)


@dataclass
class _GrowCtx:
    """what every group of one grow call shares"""
    gi: object
    st: object
    cfg: StitchConfig
    rows: np.ndarray
    pm: np.ndarray
    wan: np.ndarray
    pidx: np.ndarray
    B: int
    lmax: int
    ntab: int
    Gf: torch.Tensor
    rs_dev: torch.Tensor
    ft_dev: torch.Tensor
    ct_dev: torch.Tensor
    sjt: tuple
    s_max: int


def _run_group(ctx: _GrowCtx, a: int, b_: int):
    from .batch_engine import FB_STATS, _lanes_concat
    from .pipeline import _tick

    pm, wan, st = ctx.pm, ctx.wan, ctx.st
    dev = ctx.Gf.device
    NPg = b_ - a
    lo_w = int(pm[a, 0])
    hi_w = int(pm[b_ - 1, 0] + wan[b_ - 1])
    pm_g = pm[a:b_].copy()
    pm_g[:, 0] -= lo_w
    NWg = hi_w - lo_w
    # active-queue / retired-buffer capacities (see make_grow_engine2),
    # sized from the group; an overflow doubles them
    AMAX = min(_round_up(2 * NPg + NWg // 2, 1 << 14), A_HARD)
    RMAX = min(_round_up(NPg + 2 * NWg, 1 << 16), R_HARD)
    A_CAP = 1 << (14 if ctx.s_max <= 16 else 16)

    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    fb0 = st.fallback.astype(np.int32)
    with _tick("dev_upload"):
        rows_dev = put(ctx.rows[lo_w:hi_w])
        pm_dev = put(pm_g)
        fb_dev = put(fb0)
    while True:
        eng = make_grow_engine2(ctx.cfg, AMAX, RMAX, A_CAP, NPg, ctx.B,
                                ctx.lmax, int(ctx.gi.n_genome), ctx.ntab)
        with _tick("dev_grow"):
            SCAL, EXB, SJB, n_lanes, fb, cnt, overflow, n_iter = eng(
                ctx.Gf, ctx.rs_dev, rows_dev, pm_dev, ctx.ft_dev, ctx.ct_dev,
                ctx.sjt, fb_dev, int(wan[a:b_].max()))
        if overflow == 0:
            break
        FB_STATS['dev_retry_capacity'] += 1
        at_cap = AMAX >= A_HARD and RMAX >= R_HARD
        AMAX = min(AMAX * 2, A_HARD)
        RMAX = min(RMAX * 2, R_HARD)
        if at_cap:
            if NPg > 1:
                mid = a + NPg // 2
                # split on a read boundary
                while mid < b_ - 1 and pm[mid, 2] == pm[mid - 1, 2]:
                    mid += 1
                return _lanes_concat(_run_group(ctx, a, mid),
                                     _run_group(ctx, mid, b_))
            raise MemoryError(
                f"device grow: the chains of read {int(pm[a, 2])} (pair "
                f"{int(ctx.pidx[a])}) overflow the hard caps A_HARD={A_HARD} "
                f"active and R_HARD={R_HARD} retired lanes")

    # ---- download the completed chains and order them on the host
    with _tick("dev_download"):
        fb_new = fb.cpu().numpy().astype(bool)
        SCALh = SCAL.cpu().numpy()
        EXh = EXB.cpu().numpy()
        SJh = SJB.cpu().numpy()
    newly = fb_new & ~st.fallback
    if newly.any():
        FB_STATS['chain_cap'] += int(newly.sum())
    st.fallback |= fb_new
    with _tick("dev_order"):
        return lanes_from_blocks(SCALh, EXh, SJh, ctx.pidx[a:b_], st,
                                 ctx.s_max)


def lanes_from_blocks(SCALh, EXh, SJh, pidx, st, s_max):
    """packed device blocks -> numpy LaneState in DFS visit order
    (mirrors the tail of batch_engine.grow_chains)"""
    from .batch_engine import LaneState

    # the low word is unsigned: an int32 with bit 31 set (seed 31 of a
    # window of >= 32 seeds) must not sign-extend over the high word
    mask = (SCALh[:, C_MASK_LO].astype(np.int64) & 0xFFFFFFFF) \
        | (SCALh[:, C_MASK_HI].astype(np.int64) << 32)
    prow_l = pidx[np.clip(SCALh[:, C_PROW], 0, max(len(pidx) - 1, 0))] \
        if len(pidx) else SCALh[:, C_PROW].astype(np.int64)
    sel = (mask != 0) & ~st.fallback[st.pb[prow_l]]
    si = np.nonzero(sel)[0]
    SCALh = SCALh[si]
    EXh = EXh[si]
    SJh = SJh[si]
    mask = mask[si]
    prow_l = prow_l[si]

    n = st.wa_n[prow_l].astype(np.int64)
    rev = np.zeros(len(si), np.int64)
    for s in range(s_max):
        bit = (mask >> s) & 1
        rev |= bit << np.maximum(n - 1 - s, 0)
    b = st.pb[prow_l].astype(np.int32)
    w = st.pw[prow_l].astype(np.int32)
    order = np.lexsort((-rev, w, b))
    SCALh = SCALh[order]
    EXh = EXh[order]
    SJh = SJh[order]

    exv = EXh.reshape(len(order), E, 5).astype(np.int64)
    sjv = SJh.reshape(len(order), E, 5).astype(np.int64)
    g = lambda c: SCALh[:, c].astype(np.int64)
    return LaneState(
        b=b[order], w=w[order], prow=prow_l[order].astype(np.int32),
        mask=mask[order], dfs=np.zeros(len(order), np.int32),
        ex_rs=exv[:, :, EX_RS], ex_gs=exv[:, :, EX_GS],
        ex_len=exv[:, :, EX_LEN],
        ex_frag=exv[:, :, EX_FRAG].astype(np.int8),
        ex_sja=exv[:, :, EX_SJA],
        sj_can=sjv[:, :, SJ_CAN].astype(np.int32),
        sj_shl=sjv[:, :, SJ_SHL].astype(np.int32),
        sj_shr=sjv[:, :, SJ_SHR].astype(np.int32),
        sj_annot=sjv[:, :, SJ_ANNOT].astype(np.int32),
        sj_str=sjv[:, :, SJ_STR].astype(np.int32),
        n_ex=g(C_NEX).astype(np.int32), n_mm=g(C_NMM), n_match=g(C_NMATCH),
        n_gap=g(C_NGAP), l_gap=g(C_LGAP), n_del=g(C_NDEL), l_del=g(C_LDEL),
        n_ins=g(C_NINS), l_ins=g(C_LINS),
        n_uniq=g(C_NUNIQ).astype(np.int32),
        n_anchor=g(C_NANCH).astype(np.int32),
        score=g(C_SCORE), tR2=g(C_TR2), tG2=g(C_TG2),
        alive=np.ones(len(order), bool))
