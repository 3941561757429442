"""Device-resident stitch engine: chain growth, finalize, select and pack.

A PyTorch port of star_tpu/ops/device_stitch.py, which is itself the array
form of the numpy batch engine's grow and finalize (ops/batch_engine.py
grow_chains + stitch_step_vec + _stitch_same_frag + extend_vec, and
finalize_lanes): every branch mirrors the numpy code (bit-faithful to
reference stitchWindowAligns.cpp:56-351, stitchAlignToTranscript.cpp:106-232,
extendAlign.cpp:6-92) with masked full-width tensor ops over a chunk of
lanes.  The numpy engine stays the oracle: the tests require equal
LaneStates and accept flags.

Design:
  * Lane state lives on the device as three packed int32 row matrices (SCAL,
    EX and SJ blocks).  The active lanes form one contiguous queue; each
    step stitches seed s onto every active lane in chunks of at most A_CAP
    lanes (chunk_lanes), appends the chains that grew, and at the step's
    end compacts the queue and moves completed chains to an append-only
    retired buffer.
  * A chunk (stitch_chunk) is on CUDA tensors one launch of the
    hand-written kernel ops/csrc/stitch_chunk.cu, one warp a lane, which
    reads its regions from the tables itself; on CPU tensors it is the
    plain version, _stitch_chunk: masked full-width tensor code, the
    kernel's oracle.
  * The step/chunk loop runs on the host (a lax.while_loop in the JAX
    package): it waits for the device once per chunk (how many chains
    grew) and once more at each step's end (how many lanes stay and retire).
    A chunk holds only live lanes, so the fixed-size nonzero of the JAX
    engine becomes a plain nonzero, and only its rows are written.
  * The retired chains stay on the device: the finalize extends, filters
    and scores them there (FIN_CHUNK lanes at a time, in place), and on
    single-end runs the select classifies the reads that map to too many
    loci and keeps, of such a read, only its best lane.  The pack moves the
    selected rows together, so one download carries only the lanes the host
    assembly reads.  Paired-end runs download every retired lane with its
    accept flag, because the host's PE-overlap check runs after the grow.
  * The window layer: every lane-row move, the finalize's regions and, in
    the plain chunk, every per-lane region (the read region, two genome
    regions, the u16 mismatch-cap table) is one byte window of
    fetch.fetch_window, which on a CUDA tensor is the hand-written kernel
    ops/csrc/fetch_rows.cu and on a CPU tensor its plain version.  The
    JAX engine fetches aligned 2 KiB rows and cuts the window out of them
    (a TPU DMA constraint); its gather layer (plain per-window gathers,
    what star_tpu runs off the TPU) is not ported.
  * Genome positions are int32: the engine is gated on n_genome < 2^30.
  * The reference's float mismatch caps (outFilterMismatchNoverLmax * len
    in double) are exact host-precomputed integer floor/ceil tables, and
    its log2 genomic-length score an exact integer breakpoint table.

Dropped from the JAX engine because they only served the TPU: the
optimization barrier around window gathers (_barrier), the barrel shifter
_shift_cut (one gather here), the FET + TILE zero concatenation of every
_rowcopy (a row move is one window of the lane's own bytes), the _ABLATE
profiling switches, power-of-two shape ladders and buckets (pair, read and
download counts are exact here), the id()-keyed engine and table caches
(there is no jit; device tables live on the index object) and the classify
threshold STAR_TPU_DEV_CLASSIFY_MIN (every single-end device level
classifies).

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
import ctypes
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

# counters of the process, keyed (window cap W of the level, name): grow
# "calls", "iterations" (chunks), "steps"; "retired" chains, "accepted" by
# the finalize, "downloaded" lanes, reads classified "over" the multimap
# limit; the chunk kernel's launches ("chunk_launches"); and the fetch
# kernel's launches of the grow ("fetch_launches"), the finalize
# ("finalize_launches") and the pack ("pack_launches")
GROW_STATS = collections.Counter()
LAUNCHES = 0       # stitch_chunk kernel launches (CUDA tensors only)


def region_spans(Lpad: int):
    """(read span, genome span) of the per-lane fetch regions of one chunk:
    the widest column any window of _stitch_chunk cuts from them.  The JAX
    engine's GSPAN = 2*Lpad+520 misses the flush-right insertion window
    (3*Lpad+262) once Lpad > 258."""
    return 3 * Lpad + 12, max(2 * Lpad + 520, 3 * Lpad + 263)


# the widest region the engine fetches: the genome span at the longest read
# a run admits (two mates of readSeqLengthMax = 650 bases and the spacer,
# Lpad = 1303); _prep_table pads every table's tail by at least this much
SPAN_MAX = region_spans(2 * 650 + 1 + 2)[1]


def _prep_table(raw_bytes: np.ndarray) -> np.ndarray:
    """FRONT_PAD zero bytes, the table, and at least SPAN_MAX bytes of tail
    padding, so a window that starts at a real byte never reaches the end of
    the table (where fetch_window would clamp it)"""
    b = np.ascontiguousarray(raw_bytes).view(np.int8).ravel()
    tail = np.full(max(SPAN_MAX - FET, 0), 5, np.int8)
    return fetch.pad_table(np.concatenate([np.zeros(FRONT_PAD, np.int8), b,
                                           tail]))


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
    table: one fetch_window launch (the front pad absorbs offsets down to
    -FRONT_PAD, so the position <-> column mapping is exact).  Starts below
    the table clamp to 0 and starts past it to its end; since the tail
    padding holds SPAN_MAX bytes, a window that starts at a real byte is
    never clamped, so clamping touches only junk lanes the callers mask."""
    if span > SPAN_MAX:
        raise ValueError(f"fetch region of {span} bytes exceeds the tables' "
                         f"tail padding ({SPAN_MAX})")
    start = (byte_off.long() + FRONT_PAD).clamp_(min=0)
    return fetch.fetch_window(tabf, start, span).view(torch.uint8)


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


def _stitch_chunk_plain(cfg: StitchConfig, Gf, n_g, RSf, lmax, floor16f,
                        ceil_tab, ntab, sjdb, sc, ex, sj, rows, pm, fb,
                        s: int, out):
    """the plain version of stitch_chunk: the chunk's prologue (each lane's
    seed row and whether its pair may stitch seed s), then _stitch_chunk"""
    prow = sc[:, C_PROW].long().clamp(0, pm.shape[0] - 1)
    fb_l = fb[sc[:, C_PB].long().clamp(0, fb.shape[0] - 1)] > 0
    # the initial queue holds one lane per (possibly already exhausted)
    # pair; only pairs with seed s may stitch
    act = ~fb_l & (s < sc[:, C_WAN])
    seed = rows[(pm[:, 0][prow] + s).long().clamp(0, rows.shape[0] - 1)]
    return _stitch_chunk(cfg, Gf, n_g, RSf, lmax, floor16f, ceil_tab, ntab,
                         sjdb, sc, ex, sj, seed, s, out) & act


# the int32 scalars of csrc/stitch_chunk.cu's Cfg, in its order; _lib holds
# this against the field names the library gives
KERNEL_CONFIG = (
    "Lpad", "has_pe", "has_sjdb", "ext_end0", "ext_end1", "ins_flush_right",
    "intron_min", "intron_max", "mates_gap_max", "protrude_max", "score_gap",
    "score_gap_noncan", "score_gap_gcag", "score_gap_atac", "score_del_open",
    "score_del_base", "score_ins_open", "score_ins_base", "sjdb_score",
    "stitch_sj_shift", "sjmm0", "sjmm1", "sjmm2", "sjmm3", "n_g", "lmax",
    "ntab")


def _kernel_config(cfg: StitchConfig, n_g: int, lmax: int, ntab: int):
    """the values of KERNEL_CONFIG, in its order"""
    v = dict(vars(cfg), ext_end0=cfg.ends_ext[0][1],
             ext_end1=cfg.ends_ext[1][1], n_g=n_g, lmax=lmax, ntab=ntab,
             **{f"sjmm{i}": m for i, m in enumerate(cfg.sjmm)})
    return [int(v[f]) for f in KERNEL_CONFIG]


def _check_chunk(cfg, Gf, RSf, floor16f, ceil_tab, ntab, sjdb, sc, ex, sj,
                 rows, pm, fb, out):
    """the kernel's inputs: one device, int32 rows and tables of the
    engine's shapes, contiguous; raises ValueError on anything else"""
    def want(name, t, dtype, ndim, cols=None):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or t.dim() != ndim or not t.is_contiguous() \
                or t.device != Gf.device \
                or (cols is not None and t.shape[1] != cols):
            raise ValueError(f"stitch_chunk: {name} must be a contiguous "
                             f"{ndim}-D {dtype} tensor"
                             + (f" of {cols} columns" if cols else "")
                             + f" on {Gf.device}")
    for name, t in (("Gf", Gf), ("RSf", RSf), ("floor16f", floor16f)):
        want(name, t, torch.int8, 1)
    want("ceil_tab", ceil_tab, I32, 1)
    if ceil_tab.numel() < ntab:
        raise ValueError("stitch_chunk: ceil_tab is shorter than ntab")
    if len(sjdb) != 7:
        raise ValueError("stitch_chunk: sjdb must hold the 7 junction tables")
    for t in sjdb:
        want("an sjdb table", t, I32, 1)
        if t.numel() != sjdb[0].numel() or t.numel() < 1:
            raise ValueError("stitch_chunk: the sjdb tables differ in length")
    n = sc.shape[0] if sc.dim() == 2 else -1
    for name, t, cols in (("sc", sc, NSCAL), ("ex", ex, NEXB),
                          ("sj", sj, NSJB), ("sc out", out[0], NSCAL),
                          ("ex out", out[1], NEXB), ("sj out", out[2], NSJB)):
        want(name, t, I32, 2, cols)
        if t.shape[0] != n:
            raise ValueError(f"stitch_chunk: {name} holds {t.shape[0]} "
                             f"lanes, sc {n}")
    want("rows", rows, I32, 2, 8)
    want("pm", pm, I32, 2, 8)
    want("fb", fb, I32, 1)
    if min(rows.shape[0], pm.shape[0], fb.shape[0]) < 1:
        raise ValueError("stitch_chunk: rows, pm and fb must not be empty")
    if region_spans(cfg.Lpad)[1] > SPAN_MAX:
        raise ValueError(f"stitch_chunk: Lpad {cfg.Lpad} needs regions wider "
                         f"than the tables' tail padding ({SPAN_MAX})")


def _stitch_chunk_cuda(cfg, Gf, n_g, RSf, lmax, floor16f, ceil_tab, ntab,
                       sjdb, sc, ex, sj, rows, pm, fb, s, out):
    global LAUNCHES
    _check_chunk(cfg, Gf, RSf, floor16f, ceil_tab, ntab, sjdb, sc, ex, sj,
                 rows, pm, fb, out)
    lib = _lib()
    vals = _kernel_config(cfg, n_g, lmax, ntab)
    conf = (ctypes.c_int32 * len(vals))(*vals)
    sjt = (ctypes.c_void_p * 7)(*[t.data_ptr() for t in sjdb])
    n = sc.shape[0]
    ok = torch.empty(n, dtype=torch.bool, device=Gf.device)
    if n:
        rc = lib.stitch_chunk_launch(
            conf, Gf.data_ptr(), Gf.numel(), RSf.data_ptr(), RSf.numel(),
            floor16f.data_ptr(), floor16f.numel(), ceil_tab.data_ptr(), sjt,
            sjdb[0].numel(), sc.data_ptr(), ex.data_ptr(), sj.data_ptr(),
            rows.data_ptr(), rows.shape[0], pm.data_ptr(), pm.shape[0],
            fb.data_ptr(), fb.shape[0], out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), ok.data_ptr(), n, int(s),
            torch.cuda.current_stream(Gf.device).cuda_stream)
        if rc != 0:
            raise RuntimeError("stitch_chunk kernel launch failed: "
                               + lib.stitch_chunk_error_string(rc).decode())
        LAUNCHES += 1
    return ok


def stitch_chunk(cfg: StitchConfig, Gf, n_g, RSf, lmax, floor16f, ceil_tab,
                 ntab, sjdb, sc, ex, sj, rows, pm, fb, s: int, out):
    """one chunk of step s of the grow: the lanes' rows sc [A, NSCAL], ex
    [A, NEXB], sj [A, NSJB] with seed s of their pair applied are written
    into out = (sc, ex, sj) views; returns ok [A] bool, the lanes that
    accept the seed and whose pair may stitch it.  rows [NW, 8]: the seed
    rows; pm [NP, 8]: the pair table (column 0 the pair's first seed row);
    fb [B] int32: the reads' fallback flags.  On CUDA tensors one launch of
    the hand-written kernel csrc/stitch_chunk.cu (LAUNCHES counts them); on
    CPU tensors its plain version, _stitch_chunk_plain."""
    if Gf.is_cuda:
        return _stitch_chunk_cuda(cfg, Gf, n_g, RSf, lmax, floor16f,
                                  ceil_tab, ntab, sjdb, sc, ex, sj, rows, pm,
                                  fb, s, out)
    return _stitch_chunk_plain(cfg, Gf, n_g, RSf, lmax, floor16f, ceil_tab,
                               ntab, sjdb, sc, ex, sj, rows, pm, fb, s, out)


_LIB = None


def check_config_fields(lib):
    """raise unless the library's Cfg fields are KERNEL_CONFIG, in order"""
    lib.stitch_chunk_config_fields.restype = ctypes.c_char_p
    lib.stitch_chunk_config_fields.argtypes = []
    got = tuple(lib.stitch_chunk_config_fields().decode().split())
    if got != KERNEL_CONFIG:
        raise RuntimeError(f"csrc/stitch_chunk.cu's Cfg fields {got} are not "
                           f"device_stitch.KERNEL_CONFIG {KERNEL_CONFIG}")


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("stitch_chunk")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        check_config_fields(lib)
        lib.stitch_chunk_launch.restype = ctypes.c_int
        lib.stitch_chunk_launch.argtypes = [
            p, p, i64, p, i64, p, i64, p, p, i64, p, p, p, p, i64, p, i64,
            p, i64, p, p, p, p, i64, i64, p]
        lib.stitch_chunk_error_string.restype = ctypes.c_char_p
        lib.stitch_chunk_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


# --------------------------------------------------------------------------
# the two-queue grow engine
# --------------------------------------------------------------------------

def _alloc_rows(n: int, C: int, dev):
    """an [n, C] int32 row matrix and the int8 table that backs it: 16-byte
    aligned, a multiple of 1024 bytes and at least FET, so the table is a
    valid fetch table as it is (a row move reads whole rows, never past the
    last)"""
    nb = _round_up(max(n * C * 4, FET), TILE)
    tab = torch.zeros(nb, dtype=torch.int8, device=dev)
    return tab[:n * C * 4].view(I32).view(n, C), tab


def _rowcopy(M, tab, idx):
    """M[idx] for an int32 row matrix backed by the fetch table tab: one
    fetch_window of the row's bytes per lane.  The rows are 96 or 400 bytes,
    multiples of 16, so the kernel's output is dense and views as int32."""
    rb = M.shape[1] * 4
    assert rb % 16 == 0, rb
    return fetch.fetch_window(tab, idx.long() * rb, rb).view(I32)


def make_grow_engine2(cfg: StitchConfig, AMAX: int, RMAX: int, A_CAP: int,
                      NP: int, B: int, lmax: int, n_g: int, ntab: int):
    """two-queue grow engine: the ACTIVE lanes live in a contiguous queue
    (a chunk is a slice of it, at most A_CAP lanes), and completed chains
    move to an append-only RETIRED buffer at each step boundary.

    Returns grow(Gf, RSf, rows [NW, 8], pm [NP, 8], floor16f, ceil_tab,
                 sjdb (7 tensors), fb0 [B], s_hi)
        -> (R_SC [n_ret, NSCAL], R_EX, R_SJ, n_ret, fb, cnt, overflow,
            n_iter, n_steps, (the fetch tables backing R_SC, R_EX, R_SJ)).
    overflow: 0 done; 1 the active queue or the retired buffer overflowed;
    2 the iteration cap stopped the loop before the last step."""
    s_max = cfg.s_max
    ATOT = AMAX + A_CAP       # append slack
    RTOT = RMAX + AMAX        # retirement-block slack
    IT_MAX = s_max * (ATOT // A_CAP + 3) + 8

    def grow(Gf, RSf, rows, pm, floor16f, ceil_tab, sjdb, fb0, s_hi):
        dev = Gf.device
        A_SC, A_SCt = _alloc_rows(ATOT, NSCAL, dev)
        A_EX, A_EXt = _alloc_rows(ATOT, NEXB, dev)
        A_SJ, A_SJt = _alloc_rows(ATOT, NSJB, dev)
        R_SC, R_SCt = _alloc_rows(RTOT, NSCAL, dev)      # retired chains
        R_EX, R_EXt = _alloc_rows(RTOT, NEXB, dev)
        R_SJ, R_SJt = _alloc_rows(RTOT, NSJB, dev)
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
        s = c = overflow = it = 0

        while s < s_hi and n_act > 0 and overflow == 0 and it < IT_MAX:
            # ---- one chunk of the current step
            base = c * A_CAP
            n = min(A_CAP, n_act - base)
            ok = stitch_chunk(cfg, Gf, n_g, RSf, lmax, floor16f, ceil_tab,
                              ntab, sjdb, A_SC[base:base + n],
                              A_EX[base:base + n], A_SJ[base:base + n], rows,
                              pm, fb, s, (S_SC[:n], S_EX[:n], S_SJ[:n]))
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
        return (R_SC[:n_ret], R_EX[:n_ret], R_SJ[:n_ret], n_ret, fb, cnt,
                overflow, it, s, (R_SCt, R_EXt, R_SJt))

    return grow


# --------------------------------------------------------------------------
# finalize (reference stitchWindowAligns.cpp:56-265 per chain): end
# extensions + transcript filters over the retired chains
# --------------------------------------------------------------------------

def glog2_breakpoints(scale: float):
    """exact integer form of _glog2_score: f(g) = ceil(log2(g)*scale - 0.5)
    as f(1) plus a count of threshold crossings, thresholds computed with
    the same float64 arithmetic as the host."""
    if scale == 0:
        return 0, ()

    def f(g):
        return int(np.ceil(np.log2(np.float64(max(g, 1))) * np.float64(scale)
                           - 0.5))

    f1 = f(1)
    bounds = []
    gmax = 1 << 33
    cur = f1
    g = 1
    while g < gmax:
        # binary search the largest g' with f(g') == cur
        lo, hi = g, gmax
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if f(mid) == cur:
                lo = mid
            else:
                hi = mid - 1
        if lo >= gmax - 1:
            break
        bounds.append(lo + 1)    # first g with the next value
        cur = f(lo + 1)
        g = lo + 1
        if len(bounds) > 256:
            raise ValueError("glog2 scale produces too many breakpoints")
    step = -1 if scale < 0 else 1
    return f1, tuple(int(b) for b in bounds), step


@dataclass(frozen=True)
class FinalCfg:
    Lpad: int
    has_pe: bool
    ends_ext: tuple
    soft_clip_ends: bool        # alignSoftClipAtReferenceEnds == Yes
    sj_ovh_min: int             # alignSJoverhangMin
    sjdb_ovh_min: int           # alignSJDBoverhangMin
    rm_inconsistent_strands: bool
    strand_field_intron: bool
    intron_motifs_filter: int   # 0 none, 1 RemoveNoncanonical, 2 RemoveNoncanonicalUnannotated
    glog2: tuple                # (f1, bounds, step) or (0, ()) if scale==0
    glog2_on: bool


def make_final_config(gi, P, Lpad, has_pe) -> FinalCfg:
    ext = P.alignEndsTypeExt
    imf = {"None": 0, "RemoveNoncanonical": 1,
           "RemoveNoncanonicalUnannotated": 2}.get(P.outFilterIntronMotifs, 0)
    scale = P.scoreGenomicLengthLog2scale
    glog2 = glog2_breakpoints(scale) if scale != 0 else (0, (), 0)
    return FinalCfg(
        Lpad=int(Lpad), has_pe=bool(has_pe),
        ends_ext=(tuple(bool(x) for x in ext[0]),
                  tuple(bool(x) for x in ext[1])),
        soft_clip_ends=P.alignSoftClipAtReferenceEnds == "Yes",
        sj_ovh_min=int(P.alignSJoverhangMin),
        sjdb_ovh_min=int(P.alignSJDBoverhangMin),
        rm_inconsistent_strands=(P.outFilterIntronStrands
                                 == "RemoveInconsistentStrands"),
        strand_field_intron=P.outSAMstrandField == "intronMotif",
        intron_motifs_filter=imf,
        glog2=glog2, glog2_on=scale != 0)


def glog2_dev(glen, glog2):
    """the genomic-length log2 score of int32 lengths glen, exactly
    _glog2_score, from glog2 = glog2_breakpoints(scale)"""
    f1, bounds, step = glog2
    glen = glen.clamp(min=1)
    fval = torch.full_like(glen, f1)
    for bnd in bounds:
        if bnd < 1 << 31:       # an int32 length reaches no larger bound
            fval += torch.where(glen >= bnd, step, 0)
    return fval


# lanes per finalize chunk: bounds the [n, Lpad + 2] window temporaries of
# the extensions (every filter is per lane, so chunking changes no result)
FIN_CHUNK = 1 << 16


def _extend_end(ctx, sc, ex, which, go, lread, wstr, ext_tab):
    """one end extension of the finalize (numpy finalize_lanes ext_left /
    ext_right) on the lanes of `go`, in place on the row views sc, ex"""
    nE = sc[:, C_NEX]
    last = (nE - 1).clamp(min=0)
    tR2 = sc[:, C_TR2]
    if which == "left":
        rS = ex[:, EX_RS]
        go = go & (rS > 0)
        imate = ex[:, EX_FRAG].clamp(0, 1)
        which_col = (wstr != imate).to(I32)
        l_prev = tR2 - rS + 1
        r0, g0, Lx, d = rS - 1, ex[:, EX_GS] - 1, rS, -1
    else:
        go = go & (tR2 < lread - 1)
        imate = _ex_get(ex, last, EX_FRAG).clamp(0, 1)
        which_col = (imate == wstr).to(I32)
        l_prev = tR2 - ex[:, EX_RS] + 1
        r0, g0, Lx, d = tR2 + 1, sc[:, C_TG2] + 1, lread - tR2 - 1, 1
    te = ext_tab[(imate * 2 + which_col).long()]
    ok, eL, ms, nM, nMM = extend_dev(
        ctx.Gf, int(ctx.gi.n_genome), ctx.rs_dev, ctx.lmax, ctx.ft_dev,
        ctx.ct_dev, ctx.ntab, sc[:, C_ROW], r0, g0, d, d, Lx, l_prev,
        sc[:, C_NMM], sc[:, C_NMMMAX], te, ctx.cfg.Lpad + 2)
    u = go & ok
    eL = torch.where(u, eL, 0)
    sc[:, C_SCORE] += torch.where(u, ms, 0)
    sc[:, C_NMATCH] += torch.where(u, nM, 0)
    sc[:, C_NMM] += torch.where(u, nMM, 0)
    if which == "left":
        ex[:, EX_RS] -= eL
        ex[:, EX_GS] -= eL
        ex[:, EX_LEN] += eL
    else:
        ex.scatter_add_(1, (last * 5 + EX_LEN).long()[:, None], eL[:, None])
        sc[:, C_TR2] += eL
        sc[:, C_TG2] += eL


def _finalize_rows(ctx, sc, ex, sj, fb, pm2):
    """the finalize of one chunk of retired lanes (JAX make_finalize_engine,
    numpy finalize_lanes): sc/ex/sj are [n, C] row views of the retired
    blocks, updated in place (score, nMM, nMatch, the first and last exon,
    tR2/tG2, C_ACCEPT); pm2 [NPg, 5] per pair (chr start, chr end, Lread,
    spliced-mate minimum of mate 0, of mate 1).  Returns (accept, pe) [n]
    bool: pe marks accepted mate-spanning lanes, whose overlap the host
    checks (_pe_overlap_keep_fix)."""
    fc = ctx.fc
    dev = sc.device
    n = sc.shape[0]
    nE = sc[:, C_NEX]
    mask_nz = (sc[:, C_MASK_LO] != 0) | (sc[:, C_MASK_HI] != 0)
    fb_l = fb[sc[:, C_PB].long().clamp(0, ctx.B - 1)] > 0
    al = mask_nz & ~fb_l & (nE > 0)
    pmr = pm2[sc[:, C_PROW].long().clamp(0, pm2.shape[0] - 1)]
    cs, ce, lread, lim0, lim1 = pmr.unbind(1)
    wstr = sc[:, C_WSTR]

    # four end extensions, each reading what the one before wrote: left then
    # right on forward windows, right then left on reverse ones
    (t00, t01), (t10, t11) = fc.ends_ext
    ext_tab = torch.tensor([t00, t01, t10, t11], device=dev)
    fwd = al & (wstr == 0)
    rev = al & (wstr == 1)
    for which, go in (("left", fwd), ("right", fwd), ("right", rev),
                      ("left", rev)):
        _extend_end(ctx, sc, ex, which, go, lread, wstr, ext_tab)

    last = (nE - 1).clamp(min=0)
    rS0 = ex[:, EX_RS]
    gS0 = ex[:, EX_GS]
    rSl = _ex_get(ex, last, EX_RS)
    gSl = _ex_get(ex, last, EX_GS)
    lenl = _ex_get(ex, last, EX_LEN)
    keep = al.clone()
    if not fc.soft_clip_ends:
        keep &= ~((gSl + lread - rSl > ce) | (gS0 < cs + rS0))

    # junction overhangs over the [n, E] exon/junction field matrices
    ecols = _ar(E, dev)[None, :]
    jocc = ecols < (nE - 1)[:, None]
    exv = ex.view(n, E, 5)
    sjv = sj.view(n, E, 5)
    exl = exv[:, :, EX_LEN]
    can = sjv[:, :, SJ_CAN]
    shl = sjv[:, :, SJ_SHL]
    shr = sjv[:, :, SJ_SHR]
    annot = sjv[:, :, SJ_ANNOT]
    sstr = sjv[:, :, SJ_STR]
    neg4 = torch.full((n, 1), -4, dtype=I32, device=dev)
    zero = torch.zeros((n, 1), dtype=I32, device=dev)
    can_prev = torch.cat([neg4, can[:, :-1]], dim=1)
    annot_prev = torch.cat([zero, annot[:, :-1]], dim=1)
    can_next = torch.cat([can[:, 1:], neg4], dim=1)
    annot_next = torch.cat([annot[:, 1:], zero], dim=1)
    exl_next = torch.cat([exl[:, 1:], zero], dim=1)
    first_j = ecols == 0
    last_j = ecols == (nE - 2)[:, None]
    sjm = jocc & (can >= 0)
    bad_a = sjm & (annot == 1) & (
        ((exl < fc.sjdb_ovh_min)
         & (first_j | (can_prev == -3)
            | ((annot_prev == 0) & (can_prev >= 0))))
        | ((exl_next < fc.sjdb_ovh_min)
           & (last_j | (can_next == -3)
              | ((annot_next == 0) & (can_next >= 0)))))
    bad_b = sjm & (annot == 0) & ((exl < fc.sj_ovh_min + shl)
                                  | (exl_next < fc.sj_ovh_min + shr))
    keep &= ~(bad_a | bad_b).any(dim=1)
    # terminal annotated-junction overhang
    lastj = (nE - 2).clamp(0, E - 1)
    keep &= ~((nE > 1) & (_ex_get(sj, lastj, SJ_ANNOT) == 1)
              & (lenl < fc.sjdb_ovh_min))

    # strand consistency and intron-motif filters
    m1 = (sjm & (sstr == 1)).any(dim=1)
    m2 = (sjm & (sstr == 2)).any(dim=1)
    if fc.rm_inconsistent_strands:
        keep &= ~(m1 & m2)
    if fc.strand_field_intron:
        # a junction, but no single motif strand
        keep &= ~(sjm.any(dim=1) & (m1 == m2))
    if fc.intron_motifs_filter == 1:
        keep &= ~(sjm & (can == 0)).any(dim=1)
    elif fc.intron_motifs_filter == 2:
        keep &= ~(sjm & (can == 0) & (annot == 0)).any(dim=1)

    # spliced-mate mapped-length filter: walk the exon slots, one mate
    # segment (ended by the last exon or a -3 junction) at a time
    exfrag = exv[:, :, EX_FRAG]
    frag_last = _ex_get(ex, last, EX_FRAG).clamp(0, 1)
    exsum = torch.zeros(n, dtype=I32, device=dev)
    nsj = torch.zeros(n, dtype=I32, device=dev)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for iex in range(E):
        on = iex < nE
        exsum = torch.where(on, exsum + exl[:, iex], exsum)
        end_here = on & ((nE - 1 == iex) | (jocc[:, iex] & (can[:, iex] == -3)))
        fragx = torch.where(on, exfrag[:, iex].clamp(0, 1), frag_last)
        lim = torch.where(fragx == 0, lim0, lim1)
        bad |= end_here & (nsj > 0) & (exsum < lim)
        exsum = torch.where(end_here, 0, exsum)
        nsj = torch.where(end_here, 0,
                          torch.where(on & jocc[:, iex] & (can[:, iex] >= 0),
                                      nsj + 1, nsj))
    keep &= ~bad

    # PE overlap consistency: the cheap part here, the rare part on the host
    pe = al & (exv[:, 0, EX_FRAG] != _ex_get(ex, last, EX_FRAG))
    if fc.has_pe:
        keep &= ~(pe & (gSl + lenl <= gS0))

    if fc.glog2_on:
        sc[:, C_SCORE] = torch.where(
            al, (sc[:, C_SCORE] + glog2_dev(gSl + lenl - gS0, fc.glog2))
            .clamp(min=0), sc[:, C_SCORE])
    sc[:, C_ACCEPT] = keep.to(I32)
    return keep, pe & keep


def finalize_blocks(ctx, SC, EX, SJ, fb, pm2):
    """finalize every retired lane of one group, FIN_CHUNK lanes at a time,
    in place on the retired blocks.  Returns (accept, pe) [n_ret] bool."""
    n = SC.shape[0]
    acc = torch.zeros(n, dtype=torch.bool, device=SC.device)
    pe = torch.zeros_like(acc)
    for c0 in range(0, n, FIN_CHUNK):
        c = slice(c0, min(n, c0 + FIN_CHUNK))
        acc[c], pe[c] = _finalize_rows(ctx, SC[c], EX[c], SJ[c], fb, pm2)
    return acc, pe


# --------------------------------------------------------------------------
# select and pack: classify too-many-loci reads on the device and download
# only the lanes the host assembly reads
# --------------------------------------------------------------------------

def select_lanes(ctx, SC, EX, accept, pm, rng_mm: int, nmax_mm: int):
    """post-finalize selection (JAX make_select_engine).  A read whose
    accepted lanes span more than outFilterMultimapNmax score-proximate
    windows is provably 'mapped to too many loci' (each such window retains
    >= 1 transcript through assembly dedup), so only its single best lane
    (the reference's trBest tie-break: score desc, gLength asc, window asc,
    DFS-first) is needed on the host.  pm [NPg, 8]: the group's pair table.
    Returns (download [n] bool, over [B] bool)."""
    dev = SC.device
    B = ctx.B
    NP = pm.shape[0]
    NEGI = NEG
    BIGI = 1 << 30
    acc = accept
    score = SC[:, C_SCORE]
    prow = SC[:, C_PROW].long().clamp(0, NP - 1)
    pb = SC[:, C_PB].long().clamp(0, B - 1)
    pb_p = pm[:, 2].long().clamp(0, B - 1)

    def per(n, init, idx, val, how):
        out = torch.full((n,), init, dtype=I32, device=dev)
        return out.scatter_reduce_(0, idx, val, how, include_self=True)

    wmax_p = per(NP, NEGI, prow, torch.where(acc, score, NEGI), "amax")
    rmax_b = per(B, NEGI, pb_p, wmax_p, "amax")
    prox_p = (wmax_p > NEGI) & (wmax_p + rng_mm >= rmax_b[pb_p])
    nwin_b = torch.zeros(B, dtype=I32, device=dev).index_add_(
        0, pb_p, prox_p.to(I32))
    # soundness gate: assembly dedup can delete a higher-score list head
    # only when a window holds accepted chains of DIFFERENT mappedLength
    # (strict block coverage); with uniform mappedLength per proximate
    # window, every window head == its max accepted score and the
    # per-window >=1-retained-transcript bound holds exactly
    occ = _ar(E, dev)[None, :] < SC[:, C_NEX][:, None]
    mlen = torch.where(occ, EX.view(-1, E, 5)[:, :, EX_LEN], 0).sum(
        dim=1, dtype=I32)
    mlmax_p = per(NP, NEGI, prow, torch.where(acc, mlen, NEGI), "amax")
    mlmin_p = per(NP, BIGI, prow, torch.where(acc, mlen, BIGI), "amin")
    unsafe_p = prox_p & (mlmax_p != mlmin_p)
    unsafe_b = per(B, 0, pb_p, unsafe_p.to(I32), "amax")
    over_b = (nwin_b > nmax_mm) & (unsafe_b == 0)

    # trBest per read: score desc, gLength asc, w asc, earliest DFS.
    # DFS-first within (b, w): larger bit-reversed mask first; the reversed
    # mask fits 50 bits -> compare via two 25-bit words.
    glen = SC[:, C_TG2] + 1 - EX[:, EX_GS]
    t = acc & (score == rmax_b[pb])
    gmin_b = per(B, BIGI, pb, torch.where(t, glen, BIGI), "amin")
    t &= glen == gmin_b[pb]
    pw = SC[:, C_PW]
    wmin_b = per(B, BIGI, pb, torch.where(t, pw, BIGI), "amin")
    t &= pw == wmin_b[pb]
    # DFS-first == max bit-reversed mask (distinct per lane of a window).
    # The arithmetic shift of the int32 low word gives bit s for s < 32
    # whatever its sign.
    n_seeds = SC[:, C_WAN]
    rev_hi = torch.zeros_like(score)
    rev_lo = torch.zeros_like(score)
    for s in range(ctx.s_max):
        word = SC[:, C_MASK_LO] if s < 32 else SC[:, C_MASK_HI]
        bit = (word >> (s % 32)) & 1
        pos = (n_seeds - 1 - s).clamp(min=0)
        rev_hi |= torch.where(pos >= 25, bit << (pos - 25).clamp(0, 24), 0)
        rev_lo |= torch.where(pos < 25, bit << pos.clamp(0, 24), 0)
    rhmax_b = per(B, NEGI, pb, torch.where(t, rev_hi, NEGI), "amax")
    t &= rev_hi == rhmax_b[pb]
    rlmax_b = per(B, NEGI, pb, torch.where(t, rev_lo, NEGI), "amax")
    t &= rev_lo == rlmax_b[pb]
    return acc & (~over_b[pb] | t), over_b


def pack_rows(blocks, tables, idx):
    """the rows idx of the three retired blocks, moved together through
    fetch_window (JAX make_pack_engine)"""
    return [_rowcopy(M, tab, idx) for M, tab in zip(blocks, tables)]


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
# bytes of one [lanes, 2 * Lpad + 5] int32 scan tensor of a W512 grow chunk
# of the plain version
CHUNK_SCAN_BYTES = 1 << 26


def chunk_lanes(s_max: int, Lpad: int, device) -> int:
    """A_CAP, the lanes one grow chunk stitches at once: 2^14 at level 0.
    At the W512 level on a CUDA device 2^16 at every read length: the chunk
    kernel holds no per-column tensors, so a chunk's memory is its fixed
    output rows (2^16 x 896 B).  On CPU tensors the plain version's
    [lanes, 2 * Lpad + 5] int32 scans bound it: the largest power of two
    from 2^10 to 2^16 whose scan fits CHUNK_SCAN_BYTES, 2^16 lanes for
    reads up to 123 bases, 2^15 up to 251 (2 x 100 pairs with their
    spacer)."""
    if s_max <= 16:
        return 1 << 14
    if torch.device(device).type == "cuda":
        return 1 << 16
    fit = CHUNK_SCAN_BYTES // (4 * (2 * Lpad + 5))
    return 1 << min(16, max(fit.bit_length() - 1, 10))


def grow_chains_device(gi, P, st, ws, RS, nmm_max_read, Lpad, s_max,
                       chain_cap, device, lread=None, read_len2=None,
                       classify=False):
    """the device grow (+ finalize when lread/read_len2 are given) replacing
    batch_engine.grow_chains (+ finalize_lanes) for one level run.
    st: WAStateP (numpy), ws: WindowsState.  Mutates st.fallback exactly
    like the numpy engine (chain_cap overflows); capacity overflows retry
    with doubled capacities.  classify (single-end runs only): select the
    reads that map to too many loci on the device and download only the
    lanes the assembly reads.  Returns (LaneState in DFS visit order,
    accept [L] bool or None without a finalize, over [B] bool or None
    without a classify)."""
    from .batch_engine import _empty_lanes, _lanes_take

    live_pair = (st.wa_n > 0) & ~st.fallback[st.pb]
    if not live_pair.any():
        z = np.zeros(0, np.int64)
        return (_lanes_take(_empty_lanes(z, z, z), z),
                None if lread is None else np.zeros(0, bool), None)
    ctx = grow_context(gi, P, st, ws, RS, nmm_max_read, Lpad, s_max,
                       chain_cap, device, lread=lread, read_len2=read_len2,
                       classify=classify)
    GROW_STATS[ctx.W, "calls"] += 1
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
    return _concat_parts([_run_group(ctx, a, b_) for a, b_ in groups])


def _concat_parts(parts):
    """(lanes, accept, over) of consecutive groups -> one triple"""
    from .batch_engine import _lanes_concat
    out, acc, over = parts[0]
    for lanes, a, o in parts[1:]:
        out = _lanes_concat(out, lanes)
        if a is not None:
            acc = np.concatenate([acc, a])
        if o is not None:
            over = o if over is None else over | o
    return out, acc, over


def grow_context(gi, P, st, ws, RS, nmm_max_read, Lpad, s_max, chain_cap,
                 device, lread=None, read_len2=None, classify=False):
    """the engine configuration and the tables of one grow call, the WA
    tables of its live pairs flattened (rows [NW, 8]: rs, gs, len, frag, sja,
    nrep, anchor, _; pm [NP, 8]: waoff, wan, pb, pw, wstr, row, nmm, _; with
    lread, the finalize table pm2 [NP, 5]: chr start, chr end, Lread and
    the spliced-mate minimum of each mate) and everything the device needs
    uploaded"""
    from .pipeline import _tick

    device = torch.device(device)
    B = ws.n_reads
    W = ws.win_alive.shape[1]
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

    pb_g = st.pb[pidx]
    pm = np.zeros((NP, 8), np.int32)
    pm[:, 0] = waoff
    pm[:, 1] = wan
    pm[:, 2] = pb_g
    pm[:, 3] = st.pw[pidx]
    wstr = ws.win_str[pb_g, st.pw[pidx]].astype(np.int32)
    pm[:, 4] = wstr
    pm[:, 5] = pb_g.astype(np.int32) + B * wstr
    pm[:, 6] = nmm_max_read[pb_g].astype(np.int32)

    pm2 = fc = None
    if lread is not None:
        chrw = ws.win_chr[pb_g, st.pw[pidx]].astype(np.int64)
        cs = gi.chr_start[chrw].astype(np.int64)
        ce = cs + gi.chr_length[chrw].astype(np.int64)
        lim = np.maximum(
            P.alignSplicedMateMapLmin,
            np.floor(P.alignSplicedMateMapLminOverLmate
                     * read_len2.astype(np.float64)).astype(np.int64))
        pm2 = np.stack([cs, np.minimum(ce, np.iinfo(np.int32).max),
                        lread[pb_g], lim[pb_g, 0], lim[pb_g, 1]],
                       axis=1).astype(np.int32)
        fc = make_final_config(gi, P, Lpad, has_pe)

    ntab = 4 * (Lpad + 16)
    floor_tab, ceil_tab = mm_cap_tables(P.outFilterMismatchNoverLmax, ntab)
    Gf, sjt = device_tables(gi, device)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    with _tick(f"dev_upload_W{W}"):
        rs_dev = put(_prep_table(RS.reshape(-1)))
        # the 2-D mismatch-cap lookups read the floor table as little-endian
        # u16 byte regions (see extend_dev)
        ft_dev = put(_prep_table(np.minimum(floor_tab, 65535).astype("<u2")))
        ct_dev = put(ceil_tab)
    return _GrowCtx(gi, P, st, cfg, rows, pm, wan, pidx, B, W, RS.shape[1],
                    ntab, Gf, rs_dev, ft_dev, ct_dev, sjt, s_max, fc, pm2,
                    lread, classify and not has_pe)


@dataclass
class _GrowCtx:
    """what every group of one grow call shares"""
    gi: object
    P: object
    st: object
    cfg: StitchConfig
    rows: np.ndarray
    pm: np.ndarray
    wan: np.ndarray
    pidx: np.ndarray
    B: int
    W: int                   # window cap of the level (timer and stats key)
    lmax: int
    ntab: int
    Gf: torch.Tensor
    rs_dev: torch.Tensor
    ft_dev: torch.Tensor
    ct_dev: torch.Tensor
    sjt: tuple
    s_max: int
    fc: FinalCfg             # None: grow only
    pm2: np.ndarray
    lread: np.ndarray
    classify: bool           # single-end run that classifies on the device


def _run_group(ctx: _GrowCtx, a: int, b_: int):
    from .batch_engine import FB_STATS
    from .pipeline import _tick

    pm, wan, st = ctx.pm, ctx.wan, ctx.st
    dev = ctx.Gf.device
    W = ctx.W
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
    A_CAP = chunk_lanes(ctx.s_max, ctx.cfg.Lpad, dev)

    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    fb0 = st.fallback.astype(np.int32)
    with _tick(f"dev_upload_W{W}"):
        rows_dev = put(ctx.rows[lo_w:hi_w])
        pm_dev = put(pm_g)
        fb_dev = put(fb0)
    while True:
        eng = make_grow_engine2(ctx.cfg, AMAX, RMAX, A_CAP, NPg, ctx.B,
                                ctx.lmax, int(ctx.gi.n_genome), ctx.ntab)
        n0, c0 = fetch.LAUNCHES, LAUNCHES
        with _tick(f"dev_grow_W{W}"):
            SCAL, EXB, SJB, n_lanes, fb, cnt, overflow, n_iter, n_steps, \
                tabs = eng(ctx.Gf, ctx.rs_dev, rows_dev, pm_dev, ctx.ft_dev,
                           ctx.ct_dev, ctx.sjt, fb_dev, int(wan[a:b_].max()))
        GROW_STATS[W, "fetch_launches"] += fetch.LAUNCHES - n0
        GROW_STATS[W, "chunk_launches"] += LAUNCHES - c0
        GROW_STATS[W, "iterations"] += n_iter
        GROW_STATS[W, "steps"] += n_steps
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
                return _concat_parts([_run_group(ctx, a, mid),
                                      _run_group(ctx, mid, b_)])
            raise MemoryError(
                f"device grow: the chains of read {int(pm[a, 2])} (pair "
                f"{int(ctx.pidx[a])}) overflow the hard caps A_HARD={A_HARD} "
                f"active and R_HARD={R_HARD} retired lanes")

    with _tick(f"dev_download_W{W}"):
        fb_new = fb.cpu().numpy().astype(bool)
    newly = fb_new & ~st.fallback
    if newly.any():
        FB_STATS['chain_cap'] += int(newly.sum())
    st.fallback |= fb_new
    GROW_STATS[W, "retired"] += n_lanes
    blocks = (SCAL, EXB, SJB)
    accept = pe = over = None
    if ctx.fc is not None:
        n0 = fetch.LAUNCHES
        with _tick(f"dev_finalize_W{W}"):
            accept, pe = finalize_blocks(ctx, SCAL, EXB, SJB, fb,
                                         put(ctx.pm2[a:b_]))
            GROW_STATS[W, "accepted"] += int(accept.sum())
        GROW_STATS[W, "finalize_launches"] += fetch.LAUNCHES - n0
        if ctx.classify:
            with _tick(f"dev_select_W{W}"):
                dl, over = select_lanes(
                    ctx, SCAL, EXB, accept, pm_dev,
                    int(ctx.P.outFilterMultimapScoreRange),
                    int(ctx.P.outFilterMultimapNmax))
                idx = dl.nonzero()[:, 0]
            n0 = fetch.LAUNCHES
            with _tick(f"dev_download_W{W}"):
                blocks = pack_rows(blocks, tabs, idx)
                over = over.cpu().numpy()
            GROW_STATS[W, "pack_launches"] += fetch.LAUNCHES - n0
            GROW_STATS[W, "over"] += int(over.sum())
            accept = torch.ones_like(idx, dtype=torch.bool)
            pe = torch.zeros_like(accept)

    # ---- download the selected chains and order them on the host
    with _tick(f"dev_download_W{W}"):
        SCALh, EXh, SJh = (M.cpu().numpy() for M in blocks)
        if accept is not None:
            accept, pe = accept.cpu().numpy(), pe.cpu().numpy()
    GROW_STATS[W, "downloaded"] += len(SCALh)
    with _tick(f"dev_order_W{W}"):
        lanes = lanes_from_blocks(SCALh, EXh, SJh, ctx.pidx[a:b_], st,
                                  ctx.s_max, accept=accept, pe=pe, P=ctx.P,
                                  lread=ctx.lread)
    if accept is None:
        return lanes, None, None
    return lanes[0], lanes[1], over


def lanes_from_blocks(SCALh, EXh, SJh, pidx, st, s_max, accept=None,
                      pe=None, P=None, lread=None):
    """packed device blocks -> numpy LaneState in DFS visit order
    (mirrors the tail of batch_engine.grow_chains); accept/pe (if given)
    are permuted identically and returned alongside, with the numpy
    finalize's host-side PE-overlap consistency check applied"""
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
    lanes = LaneState(
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
    if accept is None:
        return lanes
    acc_out = accept[si][order]
    pe_out = pe[si][order]
    if pe_out.any():
        _pe_overlap_keep_fix(P, lanes, acc_out, pe_out, lread)
    return lanes, acc_out


def _pe_overlap_keep_fix(P, lanes, accept, pe_mask, lread_by_read):
    """host-side tail of the numpy finalize's PE-overlap consistency check
    (batch_engine.finalize_lanes, reference stitchWindowAligns.cpp:179-219);
    runs per flagged lane — PE overlaps are rare"""
    cand = np.nonzero(pe_mask & accept)[0]
    for c in cand:
        g = int(c)
        ne = int(lanes.n_ex[g])
        exons = [[int(lanes.ex_rs[g, e]), int(lanes.ex_gs[g, e]),
                  int(lanes.ex_len[g, e])] for e in range(ne)]
        canv = [int(lanes.sj_can[g, e]) for e in range(ne - 1)]
        Lread = int(lread_by_read[int(lanes.b[g])])
        iexM2 = ne
        for iex in range(ne - 1):
            if canv[iex] == -3:
                iexM2 = iex + 1
                break
        if exons[iexM2 - 1][1] + exons[iexM2 - 1][2] <= exons[iexM2][1]:
            continue
        if exons[0][1] > exons[iexM2][1] + exons[0][0] \
                + P.alignEndsProtrudeMax:
            accept[c] = False
            continue
        if (exons[iexM2 - 1][1] + exons[iexM2 - 1][2]
                > exons[-1][1] + Lread - exons[-1][0]
                + P.alignEndsProtrudeMax):
            accept[c] = False
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
                accept[c] = False
                break
            iex1 += 1
            iex2 += 1
