// One chunk of one step of the device grow: seed s stitched onto n lanes.
//
// Replaces no Pallas kernel: star_tpu's chunk (ops/device_stitch.py,
// _stitch_chunk) is tensor code that XLA fuses.  Its PyTorch form,
// star_tpu_torch/ops/device_stitch.py _stitch_chunk, stays as the plain
// version (CPU tensors and the tests' oracle) and is masked full-width code:
// some 1,000 small ATen launches a chunk, each a few microseconds of device
// work behind host dispatch.  Here the chunk is one launch.  It computes
// what _stitch_chunk computes, byte for byte in the rows it writes and in
// ok, with int32 arithmetic as PyTorch does it, for every StitchConfig:
// the first-exon branch, the annotated-junction join, the same-fragment
// deletion / intron (repeat scans, flush left, the mismatch fill, the
// annotated-junction lookup) and insertion (flush right or left), and the
// paired-end mate join with both extensions; then the mask bit.  It also
// does the chunk's prologue: the seed row rows[waoff[prow] + s] and
// act = ~fb[pb] & (s < wan), so ok is the plain version's ok & act.
//
// Bound: bytes.  Per lane the 896-byte row in and out, the 32-byte seed and,
// on a same-fragment lane, the read region and two genome regions
// (3 Lpad + 12 and 2 x max(2 Lpad + 520, 3 Lpad + 263) bytes), on a mate
// join the extension windows: about 6 KB a lane at Lpad 203, 0.2 ms for
// 2^15 lanes at 3.35 TB/s.  The work per lane is a few scans over
// 2 Lpad + 5 columns, well under the bytes on this card.
//
// Design: one warp per lane, so the scans run over 32 columns at a time.
//   * The lane's scalars (the row's fields, the branch taken, the edits) are
//     held by every thread of the warp alike; the row is read once and
//     written once, the edits applied on the way out.
//   * The lane's regions are staged in shared memory (2.5 KB a warp at Lpad
//     203), read coalesced from the _prep_table'd tables at the byte offsets
//     and with the clamping of _fetch_region; every window of the plain
//     version is a column range of them.
//   * A cumsum is a shuffle scan with a carry between 32-column blocks, an
//     amax a warp reduction, a first-true __ballot_sync, so a lane costs a
//     few hundred warp instructions and no device memory beyond its bytes.
//   * Branches are uniform over the warp: a lane whose branch rejects it
//     stops there, and only a same-fragment lane fetches regions.
//   * No host synchronisation and no allocation: the caller gives the
//     output rows and ok.
//
// Built without nvcc's __CUDACC__ (as C++), the same lane code runs one
// lane after another on the host with one column a step (WL = 1): the CPU
// tests hold that build against the plain version.
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#else
#include <vector>
#define HD inline
#endif

namespace {

constexpr int E = 20;           // MAX_N_EXONS
constexpr int NSCAL = 24;
constexpr int NEXB = E * 5;
constexpr int NSJB = E * 5;
constexpr int RPT = 256;
constexpr int PAD_BASE = 255;
constexpr int NEG = -(1 << 30);
constexpr int BIG = 1 << 29;
constexpr int FRONT_PAD = 1024;
constexpr int SPACER = 11;      // MARK_FRAG_SPACER_BASE
constexpr int SCORE_MATCH = 1;
constexpr int INT_LOW = -2147483647 - 1;

// SCAL block columns
enum {
  C_MASK_LO, C_MASK_HI, C_PROW, C_NEX, C_NMM, C_NMATCH, C_NGAP, C_LGAP,
  C_NDEL, C_LDEL, C_NINS, C_LINS, C_NUNIQ, C_NANCH, C_SCORE, C_TR2, C_TG2,
  C_WAN, C_ROW, C_NMMMAX, C_PB, C_PW, C_WSTR, C_ACCEPT
};
enum { EX_RS, EX_GS, EX_LEN, EX_FRAG, EX_SJA };

// the StitchConfig scalars, listed once: Cfg's fields and the names that
// stitch_chunk_config_fields() gives, which device_stitch holds against its
// KERNEL_CONFIG (the order in which it passes them)
#define CFG_FIELDS(X)                                                       \
  X(Lpad) X(has_pe) X(has_sjdb) X(ext_end0) X(ext_end1) X(ins_flush_right) \
  X(intron_min) X(intron_max) X(mates_gap_max) X(protrude_max)             \
  X(score_gap) X(score_gap_noncan) X(score_gap_gcag) X(score_gap_atac)     \
  X(score_del_open) X(score_del_base) X(score_ins_open) X(score_ins_base)   \
  X(sjdb_score) X(stitch_sj_shift) X(sjmm0) X(sjmm1) X(sjmm2) X(sjmm3)     \
  X(n_g) X(lmax) X(ntab)
#define CFG_DECL(f) int f;
#define CFG_NAME(f) #f " "
struct Cfg {
  CFG_FIELDS(CFG_DECL)
};

struct Args {
  const int8_t* G; int64_t nG;          // _prep_table'd genome
  const uint8_t* RS; int64_t nRS;       // _prep_table'd reads
  const uint8_t* F16; int64_t nF;       // _prep_table'd u16 floor table
  const int* ceil_tab;
  const int* sj_s2; const int* sj_e2; const int* sj_idx;
  const int* sj_motif; const int* sj_shl; const int* sj_shr;
  const int* sj_str; int n_sj;
  const int* sc; const int* ex; const int* sj;   // [n, 24], [n, 100] x 2
  const int* rows; int64_t NW;                   // [NW, 8] seed rows
  const int* pm; int64_t NP;                     // [NP, 8] pair table
  const int* fb; int64_t B;                      // [B] fallback flags
  int* sc_out; int* ex_out; int* sj_out;         // [n, ...] outputs
  uint8_t* ok;                                   // [n] bool
  int64_t n; int s;
};

#ifdef __CUDACC__
constexpr int WL = 32;          // columns a step: one per thread of the warp
constexpr unsigned FULL = 0xffffffffu;
HD unsigned ballot(bool p) { return __ballot_sync(FULL, p); }
HD int wmax(int v) { return __reduce_max_sync(FULL, v); }
HD int wbcast(int v, int src) { return __shfl_sync(FULL, v, src); }
HD int wscan(int v, int lane) {          // inclusive prefix sum
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += t;
  }
  return v;
}
HD void wsync() { __syncwarp(); }
HD int popc(unsigned m) { return __popc(m); }
HD int lowbit(unsigned m) { return __ffs(m) - 1; }
HD int highbit(unsigned m) { return 31 - __clz(m); }
#else
constexpr int WL = 1;           // the host build: one column a step
HD unsigned ballot(bool p) { return p ? 1u : 0u; }
HD int wmax(int v) { return v; }
HD int wbcast(int v, int) { return v; }
HD int wscan(int v, int) { return v; }
HD void wsync() {}
HD int popc(unsigned m) { return __builtin_popcount(m); }
HD int lowbit(unsigned m) { return __builtin_ffs(static_cast<int>(m)) - 1; }
HD int highbit(unsigned m) { return 31 - __builtin_clz(m); }
#endif

HD int imin(int a, int b) { return a < b ? a : b; }
HD int imax(int a, int b) { return a > b ? a : b; }
HD int iclamp(int v, int lo, int hi) { return imin(imax(v, lo), hi); }
HD int64_t lclamp(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// int32 arithmetic that wraps as PyTorch's does
HD int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
HD int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
HD int floordiv2(int v) { return v >= 0 ? v / 2 : -((1 - v) / 2); }

// first byte of the window _fetch_region(tab, off, width) reads: the logical
// offset past the front pad, clamped to the table as fetch_window clamps it
HD int64_t win_start(int off, int64_t n, int width) {
  return lclamp(lclamp(static_cast<int64_t>(off) + FRONT_PAD, 0, INT64_MAX),
                0, n - width);
}

// copy `width` bytes from src to the warp's buffer
HD void stage(uint8_t* dst, const uint8_t* src, int width, int lane) {
  for (int c = lane; c < width; c += WL) dst[c] = src[c];
}

// first k in [0, n) with pred(k), or none
template <class P>
HD int first_true(int n, int lane, int none, P pred) {
  for (int b = 0; b < n; b += WL) {
    const int k = b + lane;
    const unsigned m = ballot(k < n && pred(k));
    if (m) return b + lowbit(m);
  }
  return none;
}

// k in [0, n) with pred(k)
template <class P>
HD int count_true(int n, int lane, P pred) {
  int c = 0;
  for (int b = 0; b < n; b += WL) {
    const int k = b + lane;
    c += popc(ballot(k < n && pred(k)));
  }
  return c;
}

struct Ext {                 // extend_dev's five results
  bool ok;
  int extl, ms, nmatch, nmm;
};

// extend_dev (reference extendAlign.cpp:6-92) for one lane, direction d
// (+1 / -1 for both the read and the genome); the windows go to buf
HD Ext extend(const Cfg& c, const Args& a, uint8_t* buf, int lane, int row,
              int r0, int g0, int d, int L, int l_prev, int nmm_prev,
              int nmm_max, bool to_end) {
  const int Lwin = c.Lpad + 2;
  const int stride = (Lwin + 15) & ~15;
  uint8_t* Rw = buf;
  uint8_t* Gw = buf + stride;
  uint8_t* Fw = buf + 2 * stride;
  const int back = d == 1 ? 0 : Lwin - 1;
  const int64_t sR = win_start(wadd(wadd(wmul(row, c.lmax), r0), -back), a.nRS,
                               Lwin);
  const int64_t sG = win_start(wadd(g0, -back), a.nG, Lwin);
  stage(Rw, a.RS + sR, Lwin, lane);
  stage(Gw, reinterpret_cast<const uint8_t*>(a.G) + sG, Lwin, lane);
  const int tl0 = iclamp(wadd(l_prev, 1), 0, c.ntab - 1);
  if (!to_end) {
    const int64_t sF = win_start(2 * tl0, a.nF, 2 * Lwin);
    stage(Fw, a.F16 + sF, 2 * Lwin, lane);
  }
  wsync();
  auto Rv = [&](int k) {
    const int rix = r0 + d * k;
    return (rix < 0 || rix >= c.lmax) ? PAD_BASE
                                      : static_cast<int>(Rw[d == 1 ? k
                                                           : Lwin - 1 - k]);
  };
  auto Gv = [&](int k) {
    const int gix = g0 + d * k;
    return (gix >= 0 && gix < c.n_g)
               ? static_cast<int>(Gw[d == 1 ? k : Lwin - 1 - k]) : 5;
  };
  auto gbad = [&](int k) {
    const int gix = g0 + d * k;
    return !(gix >= 0 && gix < c.n_g) || Gv(k) == 5;
  };
  auto skip = [&](int k) { return Rv(k) > 3 || Gv(k) > 3; };
  auto match0 = [&](int k) { return !skip(k) && Gv(k) == Rv(k); };
  auto mm0 = [&](int k) { return !skip(k) && Gv(k) != Rv(k); };
  Ext e;
  if (to_end) {
    const int p_cat = first_true(Lwin, lane, BIG,
                                 [&](int k) { return gbad(k) && k < L; });
    const int p_spac = first_true(Lwin, lane, BIG,
                                  [&](int k) { return Rv(k) == SPACER; });
    const int p_end = imin(p_spac, L);
    const bool cat = p_cat < L && p_cat <= p_spac;
    const int nm = count_true(Lwin, lane,
                              [&](int k) { return k < p_end && match0(k); });
    const int nx = count_true(Lwin, lane,
                              [&](int k) { return k < p_end && mm0(k); });
    e.ok = cat || p_end > 0;
    e.extl = cat ? 0 : (p_end > 0 ? p_end : 0);
    e.ms = cat ? -999999999 : nm - nx;
    e.nmatch = cat ? 0 : nm;
    e.nmm = cat ? nmm_max + 1 : nx;
    return e;
  }
  const int p_brk = first_true(Lwin, lane, BIG, [&](int k) {
    return !(k < L) || gbad(k) || Rv(k) == SPACER;
  });
  const int tl_brk = iclamp(wadd(l_prev, L), 0, c.ntab - 1);
  const int cap_brk = imin(a.ceil_tab[tl_brk], nmm_max);
  // first mismatch whose earlier mismatches reach the cap
  int p_mmbrk = BIG;
  {
    int carry = 0;
    for (int b = 0; b < Lwin; b += WL) {
      const int k = b + lane;
      const int v = (k < Lwin && mm0(k)) ? 1 : 0;
      const int inc = wscan(v, lane) + carry;
      const unsigned m =
          ballot(k < Lwin && v && inc - v + nmm_prev >= cap_brk);
      if (m) { p_mmbrk = b + lowbit(m); break; }
      carry = wbcast(inc, WL - 1);
    }
  }
  const int p_stop = imin(p_brk, p_mmbrk);
  // the best-scoring end: running s, matches and mismatches before
  int cs = 0, cm = 0, cx = 0;
  int best = INT_LOW, pos = 0, cm_pos = 0, mb_pos = 0;
  for (int b = 0; b < Lwin; b += WL) {
    const int k = b + lane;
    const bool in = k < Lwin;
    const bool valid = in && k < p_stop;
    const int mt = (valid && match0(k)) ? 1 : 0;
    const int mx = (valid && mm0(k)) ? 1 : 0;
    const int s_inc = wscan(mt - mx, lane) + cs;
    const int m_inc = wscan(mt, lane) + cm;
    const int x_inc = wscan(mx, lane) + cx;
    const int mm_before = x_inc - mx;
    int fl = 65535;
    if (in && tl0 + k <= c.ntab - 1)
      fl = static_cast<int>(Fw[2 * k]) | (static_cast<int>(Fw[2 * k + 1]) << 8);
    const int cap = imin(fl, nmm_max);
    const bool cand = mt && mm_before + nmm_prev <= cap;
    const int sm = in ? (cand ? s_inc : -BIG) : INT_LOW;
    const int bm = wmax(sm);
    if (bm > best) {
      const int src = lowbit(ballot(sm == bm));
      best = bm;
      pos = b + src;
      cm_pos = wbcast(m_inc, src);
      mb_pos = wbcast(mm_before, src);
    }
    cs = wbcast(s_inc, WL - 1);
    cm = wbcast(m_inc, WL - 1);
    cx = wbcast(x_inc, WL - 1);
  }
  e.ok = best > 0;
  e.extl = e.ok ? pos + 1 : 0;
  e.ms = e.ok ? best : 0;
  e.nmatch = e.ok ? cm_pos : 0;
  e.nmm = e.ok ? mb_pos : 0;
  return e;
}

// the lane's edits, applied to its input row on the way out
struct Edits {
  int sc[NSCAL];
  bool set_len; int len;                 // ex[last].len
  bool set_sj; int sjv[5];               // sj[last]
  bool set_new; int nx[5];               // ex[nE]
};

HD int pick5(const int* v, int f) {
  return f == 0 ? v[0] : f == 1 ? v[1] : f == 2 ? v[2] : f == 3 ? v[3] : v[4];
}

HD void set5(int* v, int a0, int a1, int a2, int a3, int a4) {
  v[0] = a0; v[1] = a1; v[2] = a2; v[3] = a3; v[4] = a4;
}

// stitch seed (rB, gB, L, fragB, sjA, nrep, anch) onto a lane with nE >= 1
// exons (stitch_step_vec + _stitch_same_frag + the mate join); true when
// the lane accepts it
HD bool stitch(const Cfg& c, const Args& a, uint8_t* buf, int lane,
               const int* ex, Edits& ed, int rB, int gB, int L, int fragB,
               int sjA) {
  int* sc = ed.sc;
  const int nE = sc[C_NEX];
  const int last = imax(nE - 1, 0);
  const int tR2 = sc[C_TR2], tG2 = sc[C_TG2], row = sc[C_ROW];
  const int nmm_max = sc[C_NMMMAX];
  auto ex_get = [&](int e, int f) {
    const int col = e * 5 + f;
    return (col >= 0 && col < NEXB) ? ex[col] : 0;
  };
  const int exlen_last = ex_get(last, EX_LEN);
  const int exgs_last = ex_get(last, EX_GS);
  const int last_sja = ex_get(last, EX_SJA);
  const int last_frag = ex_get(last, EX_FRAG);
  const int ex_rs0 = ex[EX_RS], ex_gs0 = ex[EX_GS];

  if (nE >= E) return false;
  const bool annotb = sjA != -1 && last_sja == sjA && last_frag == fragB &&
                      rB == tR2 + 1 && tG2 + 1 < gB;
  int d_score = 0;
  if (annotb) {
    // ================= annotated-junction join =================
    if (c.has_sjdb) {
      const int j = iclamp(sjA, 0, a.n_sj - 1);
      const int motif = a.sj_motif[j], shl = a.sj_shl[j], shr = a.sj_shr[j];
      if (motif == 0 && (L <= shr || exlen_last <= shl)) return false;
      ed.set_sj = true;
      set5(ed.sjv, motif, shl, shr, 1, a.sj_str[j]);
      ed.set_new = true;
      set5(ed.nx, rB, gB, L, fragB, sjA);
      sc[C_NEX] = nE + 1;
      sc[C_NMATCH] += L;
      d_score = SCORE_MATCH * L + c.sjdb_score;
    }
  } else if (last_frag == fragB) {
    // ================= same-fragment stitch =================
    const int ra = tR2, ga = tG2, r_b_end = rB + L - 1;
    bool rej = r_b_end <= ra || gB + L - 1 <= ga;
    const int trim = imax(ra + 1 - rB, 0);
    const int rb = rB + trim, gb = gB + trim;
    const int Ls = r_b_end - rb + 1;
    const int g_gap = gb - ga - 1, r_gap = rb - ra - 1;
    const int gb1 = gb - r_gap - 1;
    const int exlen = exlen_last;
    const bool delb = !rej && g_gap > r_gap;
    const bool insb = !rej && r_gap > g_gap;
    if (!delb && !insb) return false;
    const int delv = delb ? g_gap - r_gap : 0;
    const int insv = insb ? r_gap - g_gap : 0;
    if (delb && c.intron_max > 0 && delv > c.intron_max) return false;
    int n_mm = 0, n_match = Ls, extra = 0, jR = 0, j_can = 999;
    int jjL = 0, jjR = 0, annot_fl = 0, sjstr = 0;

    const int Lpad = c.Lpad;
    const int W1 = Lpad + 2, WSC = 2 * Lpad + 5, WI = Lpad + 2;
    const int RSPAN = 3 * Lpad + 12;
    const int GSPAN = imax(2 * Lpad + 520, 3 * Lpad + 263);
    const int p0r = ra - W1, pgd = ga - W1 - 257, pga = gb1 - W1 - 257;
    uint8_t* Rr = buf;
    uint8_t* Dr = buf + ((RSPAN + 15) & ~15);
    uint8_t* Ar = Dr + ((GSPAN + 15) & ~15);
    stage(Rr, a.RS + win_start(wadd(wmul(row, c.lmax), p0r), a.nRS, RSPAN),
          RSPAN, lane);
    const uint8_t* G8 = reinterpret_cast<const uint8_t*>(a.G);
    stage(Dr, G8 + win_start(pgd, a.nG, GSPAN), GSPAN, lane);
    if (delb) stage(Ar, G8 + win_start(pga, a.nG, GSPAN), GSPAN, lane);
    wsync();
    const int g_first = a.G[FRONT_PAD];
    const int g_last = a.G[FRONT_PAD + c.n_g - 1];
    // region columns with the plain version's clipping
    auto Rc = [&](int col) {
      const int p = p0r + col;
      return (p < 0 || p >= c.lmax) ? PAD_BASE : static_cast<int>(Rr[col]);
    };
    auto Dc = [&](int col) {
      const int p = pgd + col;
      return p < 0 ? g_first : (p >= c.n_g ? g_last : static_cast<int>(Dr[col]));
    };
    auto Ac = [&](int col) {
      const int p = pga + col;
      return p < 0 ? g_first : (p >= c.n_g ? g_last : static_cast<int>(Ar[col]));
    };

    if (delb) {
      // ------------------------- deletion / intron -------------------------
      const bool intron = delv >= c.intron_min;
      auto Rv = [&](int k) { return Rc(k); };
      auto Gd = [&](int k) { return Dc(257 + k); };
      auto Ga = [&](int k) { return Ac(257 + k); };
      // jR1s: the largest offset k - W1 <= 0 that fails (too many
      // repeat-consistent mismatches to its right, or too short an exon)
      int jR1s = NEG;
      {
        int carry = 0;
        for (int b = W1 / WL * WL; b >= 0; b -= WL) {
          const int k = b + lane;
          const int v = (k <= W1 && Rv(k) != Ga(k) && Ga(k) < 4 &&
                         Rv(k) == Gd(k)) ? 1 : 0;
          const int inc = wscan(v, lane);
          const int tot = wbcast(inc, WL - 1);
          const int cd = tot - inc + v + carry;
          const unsigned m = ballot(k <= W1 && (cd > c.stitch_sj_shift ||
                                                exlen + (k - W1) <= 1));
          if (m) { jR1s = b + highbit(m) - W1; break; }
          carry += tot;
        }
      }
      const int hi_o = r_b_end - ra - 1;
      auto canp = [&](int k, int& pen) {
        const int d1 = Gd(imin(k + 1, WSC - 1)), d2 = Gd(imin(k + 2, WSC - 1));
        const int a1 = Ga(imax(k - 1, 0)), a2 = Ga(k);
        int cn = 0;
        if (d1 == 2 && d2 == 3 && a1 == 0 && a2 == 2) cn = 1;
        else if (d1 == 1 && d2 == 3 && a1 == 0 && a2 == 1) cn = 2;
        else if (d1 == 2 && d2 == 1 && a1 == 0 && a2 == 2) cn = 3;
        else if (d1 == 1 && d2 == 3 && a1 == 2 && a2 == 1) cn = 4;
        else if (d1 == 0 && d2 == 3 && a1 == 0 && a2 == 1) cn = 5;
        else if (d1 == 2 && d2 == 3 && a1 == 0 && a2 == 3) cn = 6;
        pen = cn == 0 ? c.score_gap_noncan
              : (cn == 3 || cn == 4) ? c.score_gap_gcag
              : (cn == 5 || cn == 6) ? c.score_gap_atac : 0;
        if (!intron) { cn = -1; pen = 0; }
        return cn;
      };
      // the junction: the first best of the shift score plus its penalty
      int best = INT_LOW, pos = 0;
      {
        int carry = 0;
        for (int b = 0; b < WSC; b += WL) {
          const int k = b + lane;
          const bool in = k < WSC;
          const int off = k - W1;
          const bool scan = in && off >= jR1s && off <= hi_o;
          int v = 0;
          if (scan) {
            const int r = Rv(k), gd = Gd(k), ga_ = Ga(k);
            v = (r == gd && r != ga_ ? 1 : 0) - (r != gd && r == ga_ ? 1 : 0);
          }
          const int inc = wscan(v, lane) + carry;
          int pen = 0;
          if (scan) canp(k, pen);
          const int sm = in ? (scan ? inc + pen : NEG) : INT_LOW;
          const int bm = wmax(sm);
          if (bm > best) {
            best = bm;
            pos = b + lowbit(ballot(sm == bm));
          }
          carry = wbcast(inc, WL - 1);
        }
      }
      jR = pos - W1;
      int j_pen = 0;
      j_can = canp(pos, j_pen);
      // repeat scans to the left and right of the junction
      jjL = first_true(RPT + 1, lane, 0, [&](int jj) {
        const int col = jR + W1 + 1 + RPT - jj;
        const int gdv = Dc(col);
        return !(ga + jR - jj >= 0 && gdv == Ac(col) && gdv < 4 && jj <= 255);
      });
      jjR = first_true(RPT + 1, lane, 0, [&](int jj) {
        const int col = jR + W1 + 258 + jj;
        const int gdv = Dc(col);
        return !(ga + jR + 1 + jj < c.n_g && gdv == Ac(col) && gdv < 4 &&
                 jj <= 255);
      });
      if (j_can <= 0) {             // flush left
        jR -= jjL;
        if (exlen + jR < 1) return false;
        jjR += jjL;
        jjL = 0;
      }
      // mismatch fill around the junction
      {
        const int lo_ii = imin(jR + 1, 1), hi_ii = imax(r_gap, jR);
        auto scor = [&](int k, bool& eq) {
          const int off = k - W1;
          const int g1 = off <= jR ? Gd(k) : Ga(k);
          const int r = Rv(k);
          const bool s = off >= lo_ii && off <= hi_ii && g1 < 4 && r < 4;
          eq = s && r == g1;
          return s;
        };
        auto in_rgap = [&](int k) { return k - W1 >= 1 && k - W1 <= r_gap; };
        const int eq_in = count_true(WSC, lane, [&](int k) {
          bool eq;
          scor(k, eq);
          return eq && in_rgap(k);
        });
        const int mm_all = count_true(WSC, lane, [&](int k) {
          bool eq;
          return scor(k, eq) && !eq;
        });
        const int out_mm = count_true(WSC, lane, [&](int k) {
          bool eq;
          return scor(k, eq) && !eq && !in_rgap(k);
        });
        n_match = n_match + eq_in - out_mm;
        extra = extra + eq_in - mm_all - out_mm;
        n_mm = n_mm + mm_all;
      }
      // an annotated junction overrides the motif; else the gap's score
      bool found = false;
      int ind = -1;
      if (c.has_sjdb) {
        const int jS = ga + jR + 1, jE = gb1 + jR;
        const int n = a.n_sj;
        int lo = 0, hi = n;
        while (lo < hi) {
          const int mid = (lo + hi) / 2;
          const int ms = a.sj_s2[mid], me = a.sj_e2[mid];
          if (ms < jS || (ms == jS && me < jE)) lo = mid + 1; else hi = mid;
        }
        const int p = iclamp(lo, 0, n - 1);
        if (lo < n && a.sj_s2[p] == jS && a.sj_e2[p] == jE) ind = a.sj_idx[p];
        found = ind >= 0;
      }
      if (!found && intron) extra += c.score_gap + j_pen;
      if (!found && !intron) {
        extra += delv * c.score_del_base + c.score_del_open;
        j_can = -1;
      }
      if (found) {
        annot_fl = 1;
        const int j = iclamp(ind, 0, a.n_sj - 1);
        const int f_motif = a.sj_motif[j], f_shl = a.sj_shl[j];
        j_can = f_motif;
        if (f_motif == 0) {
          bool rej6 = Ls <= f_shl || exlen <= f_shl;
          jR += f_shl;
          rej6 = rej6 || ra + jR >= r_b_end;
          jjL = f_shl;
          jjR = a.sj_shr[j];
          if (rej6) return false;
        }
        sjstr = a.sj_str[j];
        extra += c.sjdb_score;
      } else {
        sjstr = j_can > 0 ? 2 - j_can % 2 : 0;
      }
    } else {
      // ----------------------------- insertion -----------------------------
      const int ci = iclamp(insv, 0, Lpad);
      auto Rvp = [&](int k) { return Rc(W1 + k); };
      auto Rv2p = [&](int k) { return Rc(W1 + ci + k); };
      auto Gdp = [&](int k) { return Dc(257 + W1 + k); };
      auto inrp = [&](int k) { return k >= 1 && k <= g_gap; };
      // the shift score's best: its value, first and last column
      int best = INT_LOW, f_pos = 0, l_pos = 0;
      {
        int carry = 0;
        for (int b = 0; b < WI; b += WL) {
          const int k = b + lane;
          const bool in = k < WI;
          int v = 0;
          if (in && inrp(k) && Gdp(k) < 4)
            v = 2 * (Rvp(k) == Gdp(k) ? 1 : 0) - 2 * (Rv2p(k) == Gdp(k) ? 1 : 0);
          const int inc = wscan(v, lane) + carry;
          const int sm = in ? (inrp(k) ? inc : NEG) : INT_LOW;
          const int bm = wmax(sm);
          if (bm >= best) {
            const unsigned m = ballot(sm == bm);
            if (bm > best) f_pos = b + lowbit(m);
            best = bm;
            l_pos = b + highbit(m);
          }
          carry = wbcast(inc, WL - 1);
        }
      }
      // Mp = max(best, 0): a column holds it only when best >= 0
      int jR_i;
      if (c.ins_flush_right)
        jR_i = best >= 0 ? l_pos : 0;
      else
        jR_i = best > 0 ? f_pos : 0;
      if (g_gap < 0) extra += SCORE_MATCH * g_gap;
      auto rsel = [&](int k) { return k <= jR_i ? Rvp(k) : Rv2p(k); };
      const int eq_n = count_true(WI, lane, [&](int k) {
        const int r = rsel(k), g = Gdp(k);
        return inrp(k) && g < 4 && r < 4 && r == g;
      });
      const int mm_n = count_true(WI, lane, [&](int k) {
        const int r = rsel(k), g = Gdp(k);
        return inrp(k) && g < 4 && r < 4 && r != g;
      });
      n_match += eq_n;
      extra += eq_n - mm_n;
      n_mm += mm_n;
      if (c.ins_flush_right) {
        const int lim = r_b_end - ra - insv;
        const int jRc = iclamp(jR_i, 0, Lpad);
        const int j0 = jR_i;
        jR_i += first_true(WI, lane, 0, [&](int k) {
          const int g3 = Dc(W1 + 258 + jRc + k);
          return j0 + k >= lim || Rc(W1 + 1 + jRc + k) != g3 || g3 == 4;
        });
        if (jR_i == lim) return false;
      }
      extra += insv * c.score_ins_base + c.score_ins_open;
      jR = jR_i;
      j_can = -2;
    }

    // ----------------------------- accept -----------------------------
    const int cls = iclamp(floordiv2(j_can + 1), 0, 3);
    const int lim_mm = cls == 0 ? c.sjmm0 : cls == 1 ? c.sjmm1
                       : cls == 2 ? c.sjmm2 : c.sjmm3;
    if (!(sc[C_NMM] + n_mm <= nmm_max &&
          (j_can < 0 || (j_can < 7 && n_mm <= lim_mm))))
      return false;
    d_score = SCORE_MATCH * Ls + extra;
    sc[C_NMM] += n_mm;
    sc[C_NMATCH] += n_match;
    const bool is_int = delv >= c.intron_min;
    if (is_int) {
      if (delv > 0) sc[C_NGAP] += 1;
      sc[C_LGAP] += delv;
    } else {
      if (delv > 0) sc[C_NDEL] += 1;
      sc[C_LDEL] += delv;
    }
    if (delv > 0) {
      ed.set_len = true;
      ed.len = exlen_last + jR;
      ed.set_sj = true;
      set5(ed.sjv, j_can, jjL, jjR, annot_fl, sjstr);
      ed.set_new = true;
      set5(ed.nx, ra + jR + 1, gb1 + jR + 1, r_b_end - ra - jR, fragB, sjA);
      sc[C_NEX] = nE + 1;
    }
    if (insv > 0) {
      sc[C_NINS] += 1;
      sc[C_LINS] += insv;
      ed.set_len = true;
      ed.len = exlen_last + jR;
      ed.set_sj = true;
      set5(ed.sjv, -2, 0, 0, 0, 0);
      ed.set_new = true;
      set5(ed.nx, ra + jR + insv + 1, ga + 1 + jR, r_b_end - ra - jR - insv,
           fragB, sjA);
      sc[C_NEX] = nE + 1;
    }
  } else {
    // ================= mate join (PE) =================
    if (!((gB + ex_rs0 + c.protrude_max >= ex_gs0) || ex_gs0 < ex_rs0))
      return false;
    if (c.has_pe) {
      if (c.mates_gap_max > 0 &&
          gB > exgs_last + exlen_last + c.mates_gap_max)
        return false;
      int d_m = SCORE_MATCH * L;
      const bool te1 = (iclamp(last_frag, 0, 1) == 0 ? c.ext_end0 : c.ext_end1);
      const Ext e1 = extend(c, a, buf, lane, row, tR2 + 1, tG2 + 1, 1, 650,
                            sc[C_NMATCH], sc[C_NMM], nmm_max, te1);
      if (e1.ok) {
        sc[C_NMATCH] += e1.nmatch;
        sc[C_NMM] += e1.nmm;
        d_m += e1.ms;
        ed.set_len = true;
        ed.len = exlen_last + e1.extl;
      }
      ed.set_sj = true;
      set5(ed.sjv, -3, 0, 0, 0, 0);
      ed.set_new = true;
      set5(ed.nx, rB, gB, L, fragB, sjA);
      sc[C_NEX] = nE + 1;
      sc[C_NMATCH] += L;
      const bool te2 = (iclamp(fragB, 0, 1) == 0 ? c.ext_end0 : c.ext_end1);
      const int extlen = te2 ? 650 : gB - ex_gs0 + ex_rs0;
      wsync();                 // the first extension's windows are read
      const Ext e2 = extend(c, a, buf, lane, row, rB - 1, gB - 1, -1, extlen,
                            sc[C_NMATCH], sc[C_NMM], nmm_max, te2);
      if (e2.ok) {
        sc[C_NMATCH] += e2.nmatch;
        sc[C_NMM] += e2.nmm;
        d_m += e2.ms;
        ed.nx[EX_RS] -= e2.extl;
        ed.nx[EX_GS] -= e2.extl;
        ed.nx[EX_LEN] += e2.extl;
      }
      d_score = d_m;
    }
  }
  // ================= accept =================
  sc[C_SCORE] += d_score;
  return true;
}

// lane i of the chunk (all threads of a warp, or the host alone)
HD void stitch_lane(const Cfg& c, const Args& a, int64_t i, uint8_t* buf,
                    int lane) {
  const int* scp = a.sc + i * NSCAL;
  const int* ex = a.ex + i * NEXB;
  const int* sjr = a.sj + i * NSJB;
  Edits ed;
#pragma unroll
  for (int j = 0; j < NSCAL; ++j) ed.sc[j] = scp[j];
  ed.set_len = ed.set_sj = ed.set_new = false;
  ed.len = 0;
  set5(ed.sjv, 0, 0, 0, 0, 0);
  set5(ed.nx, 0, 0, 0, 0, 0);
  int* sc = ed.sc;

  // the prologue: the lane's seed, and whether its pair may stitch it
  const int64_t prow = lclamp(sc[C_PROW], 0, a.NP - 1);
  const int64_t w = lclamp(wadd(a.pm[prow * 8], a.s), 0, a.NW - 1);
  const int* seed = a.rows + w * 8;
  const int rB = seed[0], gB = seed[1], L = seed[2], fragB = seed[3];
  const int sjA = seed[4], nrepB = seed[5], anchB = seed[6];
  const bool act = !(a.fb[lclamp(sc[C_PB], 0, a.B - 1)] > 0) && a.s < sc[C_WAN];

  bool ok;
  if (sc[C_NEX] == 0) {            // the first exon
    sc[C_NMATCH] = L;
    sc[C_SCORE] = SCORE_MATCH * L;
    sc[C_TR2] = rB + L - 1;
    sc[C_TG2] = gB + L - 1;
    sc[C_NUNIQ] = nrepB == 1;
    sc[C_NANCH] = anchB > 0;
    sc[C_NEX] = 1;
    ed.set_new = true;
    set5(ed.nx, rB, gB, L, fragB, sjA);
    ok = true;
  } else {
    ok = stitch(c, a, buf, lane, ex, ed, rB, gB, L, fragB, sjA);
    if (ok) {
      sc[C_TR2] = rB + L - 1;
      sc[C_TG2] = gB + L - 1;
      sc[C_NUNIQ] += nrepB == 1;
      sc[C_NANCH] += anchB > 0;
    } else {
      // a rejected lane's row goes out as it came in
#pragma unroll
      for (int j = 0; j < NSCAL; ++j) ed.sc[j] = scp[j];
      ed.set_len = ed.set_sj = ed.set_new = false;
    }
  }
  const uint32_t bit = 1u << (a.s & 31);
  if (a.s < 32)
    sc[C_MASK_LO] = static_cast<int>(static_cast<uint32_t>(sc[C_MASK_LO]) | bit);
  else
    sc[C_MASK_HI] = static_cast<int>(static_cast<uint32_t>(sc[C_MASK_HI]) | bit);

  const int nE = scp[C_NEX];
  const int last = imax(nE - 1, 0);
  int* exo = a.ex_out + i * NEXB;
  int* sjo = a.sj_out + i * NSJB;
  for (int j = lane; j < NEXB; j += WL) {
    int v = ex[j];
    if (ed.set_len && j == last * 5 + EX_LEN) v = ed.len;
    if (ed.set_new && j >= nE * 5 && j < nE * 5 + 5) v = pick5(ed.nx, j - nE * 5);
    exo[j] = v;
    int u = sjr[j];
    if (ed.set_sj && j >= last * 5 && j < last * 5 + 5)
      u = pick5(ed.sjv, j - last * 5);
    sjo[j] = u;
  }
  if (lane == 0) {
    int* sco = a.sc_out + i * NSCAL;
#pragma unroll
    for (int j = 0; j < NSCAL; ++j) sco[j] = sc[j];
    a.ok[i] = ok && act;
  }
}

// the read and genome region spans (device_stitch.region_spans)
int64_t rspan_of(int Lpad) { return 3 * static_cast<int64_t>(Lpad) + 12; }
int64_t gspan_of(int Lpad) {
  const int64_t a = 2 * static_cast<int64_t>(Lpad) + 520;
  const int64_t b = 3 * static_cast<int64_t>(Lpad) + 263;
  return a > b ? a : b;
}

// bytes of one lane's staging buffer (the extension windows fit in it)
int64_t lane_buffer_bytes(int Lpad) {
  return ((rspan_of(Lpad) + 15) & ~15) + 2 * ((gspan_of(Lpad) + 15) & ~15);
}

int check(const Cfg& c, const Args& a) {
  if (a.n < 0 || c.Lpad < 1 || c.Lpad > 4096 || c.ntab < 1 || c.n_g < 1 ||
      c.lmax < 1 || a.NW < 1 || a.NP < 1 || a.B < 1 || a.n_sj < 1 ||
      a.nG < FRONT_PAD + static_cast<int64_t>(c.n_g) ||
      a.nG < gspan_of(c.Lpad) || a.nRS < rspan_of(c.Lpad) ||
      a.nF < 2 * (static_cast<int64_t>(c.Lpad) + 2))
    return 1;
  return 0;
}

#ifdef __CUDACC__
constexpr int kWarps = 4;         // lanes (warps) a block

__global__ void __launch_bounds__(kWarps * 32)
stitch_chunk_kernel(const Cfg c, const Args a, int buf_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (i >= a.n) return;
  stitch_lane(c, a, i, smem + warp * buf_bytes, lane);
}
#endif

Args make_args(const void* G, int64_t nG, const void* RS, int64_t nRS,
               const void* F16, int64_t nF, const void* ceil_tab,
               const void* const* sjt, int64_t n_sj, const void* sc,
               const void* ex, const void* sj, const void* rows, int64_t NW,
               const void* pm, int64_t NP, const void* fb, int64_t B,
               void* sc_out, void* ex_out, void* sj_out, void* ok, int64_t n,
               int64_t s) {
  Args a;
  a.G = static_cast<const int8_t*>(G); a.nG = nG;
  a.RS = static_cast<const uint8_t*>(RS); a.nRS = nRS;
  a.F16 = static_cast<const uint8_t*>(F16); a.nF = nF;
  a.ceil_tab = static_cast<const int*>(ceil_tab);
  a.sj_s2 = static_cast<const int*>(sjt[0]);
  a.sj_e2 = static_cast<const int*>(sjt[1]);
  a.sj_idx = static_cast<const int*>(sjt[2]);
  a.sj_motif = static_cast<const int*>(sjt[3]);
  a.sj_shl = static_cast<const int*>(sjt[4]);
  a.sj_shr = static_cast<const int*>(sjt[5]);
  a.sj_str = static_cast<const int*>(sjt[6]);
  a.n_sj = static_cast<int>(n_sj);
  a.sc = static_cast<const int*>(sc);
  a.ex = static_cast<const int*>(ex);
  a.sj = static_cast<const int*>(sj);
  a.rows = static_cast<const int*>(rows); a.NW = NW;
  a.pm = static_cast<const int*>(pm); a.NP = NP;
  a.fb = static_cast<const int*>(fb); a.B = B;
  a.sc_out = static_cast<int*>(sc_out);
  a.ex_out = static_cast<int*>(ex_out);
  a.sj_out = static_cast<int*>(sj_out);
  a.ok = static_cast<uint8_t*>(ok);
  a.n = n;
  a.s = static_cast<int>(s);
  return a;
}

}  // namespace

extern "C" {

// cfg: the int32 scalars of Cfg, in its order (host memory).  G, RS, F16:
// the _prep_table'd genome, reads and u16 floor table (int8, nG / nRS / nF
// bytes); ceil_tab int32 [ntab]; sjt: the 7 int32 sjdb
// tables of device_tables, n_sj rows each; sc / ex / sj: the chunk's lane
// rows, int32 [n, 24] / [n, 100] / [n, 100]; rows int32 [NW, 8]; pm int32
// [NP, 8]; fb int32 [B]; the outputs: rows of the same shapes and ok, bool
// [n].  s: the step's seed.  All pointers but cfg and sjt are device
// memory, contiguous.  Launches on `stream`; returns cudaGetLastError().
// Cfg's field names, in its order, each followed by a space
const char* stitch_chunk_config_fields() { return CFG_FIELDS(CFG_NAME); }

#ifdef __CUDACC__
int stitch_chunk_launch(const int32_t* cfg, const void* G, int64_t nG,
                        const void* RS, int64_t nRS, const void* F16,
                        int64_t nF, const void* ceil_tab,
                        const void* const* sjt, int64_t n_sj, const void* sc,
                        const void* ex, const void* sj, const void* rows,
                        int64_t NW, const void* pm, int64_t NP,
                        const void* fb, int64_t B, void* sc_out, void* ex_out,
                        void* sj_out, void* ok, int64_t n, int64_t s,
                        void* stream) {
  Cfg c;
  std::memcpy(&c, cfg, sizeof(Cfg));
  const Args a = make_args(G, nG, RS, nRS, F16, nF, ceil_tab, sjt, n_sj, sc,
                           ex, sj, rows, NW, pm, NP, fb, B, sc_out, ex_out,
                           sj_out, ok, n, s);
  if (check(c, a)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int buf = static_cast<int>(lane_buffer_bytes(c.Lpad));
  const size_t bytes = static_cast<size_t>(buf) * kWarps;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stitch_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  stitch_chunk_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, bytes,
                        static_cast<cudaStream_t>(stream)>>>(c, a, buf);
  return static_cast<int>(cudaGetLastError());
}

const char* stitch_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#else
// the same arguments in host memory, the lanes one after another
int stitch_chunk_host(const int32_t* cfg, const void* G, int64_t nG,
                      const void* RS, int64_t nRS, const void* F16,
                      int64_t nF, const void* ceil_tab, const void* const* sjt,
                      int64_t n_sj, const void* sc, const void* ex,
                      const void* sj, const void* rows, int64_t NW,
                      const void* pm, int64_t NP, const void* fb, int64_t B,
                      void* sc_out, void* ex_out, void* sj_out, void* ok,
                      int64_t n, int64_t s) {
  Cfg c;
  std::memcpy(&c, cfg, sizeof(Cfg));
  const Args a = make_args(G, nG, RS, nRS, F16, nF, ceil_tab, sjt, n_sj, sc,
                           ex, sj, rows, NW, pm, NP, fb, B, sc_out, ex_out,
                           sj_out, ok, n, s);
  if (check(c, a)) return 1;
  std::vector<uint8_t> buf(lane_buffer_bytes(c.Lpad));
  for (int64_t i = 0; i < n; ++i) stitch_lane(c, a, i, buf.data(), 0);
  return 0;
}
#endif

}  // extern "C"
