// Byte-window fetch: out[i, 0:W] = table[s_i : s_i + W].
//
// One window kernel behind three launchers:
//
//   window_launch       any byte start s_i (int64) and any width W; a negative
//                       start skips its row.  The port's main path: the MMP's
//                       SA entry (4 bytes), SAi pair (8) and suffix text (QL),
//                       every per-lane region of the stitch engine (the read
//                       region, two genome regions, the u16 mismatch-cap
//                       table) and every lane-row move (96 or 400 bytes) is
//                       one such window.
//   fetch_rows_launch   W = 2048 from s_i = align1024(off_i), int64 offsets, a
//                       negative one skips its row: replaces the Pallas kernel
//                       star_tpu/ops/fetch.py:_fetch_rows_pallas (entered
//                       through fetch_rows) with its [B, 2048] contract.
//   tile_fetch_launch   the same with int32 positions and no skip: replaces
//                       star_tpu/ops/pallas_fetch.py:make_tile_fetch.
//
// The TPU's DMA wanted 1 KiB-aligned starts and lengths, so there the 2 KiB
// row was the unit and every caller cut the window it needed out of the row in
// a second pass.  Hopper has no such constraint: the window is the unit here,
// and nothing is cut afterwards.
//
// Bound: pure data movement.  A call reads each distinct 32-byte sector its
// windows cover once and writes B * W bytes (and reads 8 B per start); its
// least time is those bytes over the card's HBM bandwidth (3.35 TB/s on an
// H100 SXM).  The windows are scattered and often share tiles (MMP neighbours,
// the reads of one batch, a lane's genome regions), so what costs is latency
// (many small independent transfers must be in flight) and reading shared
// tiles from HBM more than once.
//
// Design:
//   * A group of G lanes per row, G the power of two that covers the row's
//     16-byte vectors, up to a warp: one thread per row for the 4- and 8-byte
//     MMP cuts, a warp for windows over 256 bytes.  CTAs of 256 threads walk
//     rows in a grid-stride loop over a grid sized to fill every SM.
//   * Only the 16-byte vectors that the window's bytes touch are read, each
//     once (one for most 4- and 8-byte windows).
//     Lane t loads vectors t, t + G, ... of the window's span (up to four
//     batches of loads in flight before the first store); the vector one
//     position up, which realignment needs, comes from lane t + 1 by shuffle.
//     Registers realign each pair with funnel shifts, and the output is
//     stored in 16-byte vectors.  Output rows are padded to a multiple of 16
//     bytes (round_up(W, 16) is the row stride).
//   * Table loads carry an L2 evict_last policy and output stores stream
//     (st.global.cs), so tiles shared by many windows stay in L2 while the
//     output passes through.
//   * Starts are 64-bit inside the kernel (tables over 2 GiB) and there is no
//     per-call row cap.  A start is clamped into [0, n_bytes - W], so no
//     window reads past the table; the callers size their tables' padding so
//     that the clamp only ever moves junk lanes.
//
// A ring of TMA 1-D bulk copies (global -> shared on an mbarrier, then
// shared -> global) was tried for the aligned 2 KiB rows and was 4-6 % slower
// than this copy at 262,144 rows (PERF.md), so there is one copy.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kTile = 1024;
constexpr int64_t kFet = 2048;
constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// 16 bytes of the (read-only) table, kept in L2 by the policy
__device__ __forceinline__ uint4 load_keep(const uint4* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// bytes r .. r + 15 of the 32 little-endian bytes a | b, r in [0, 16)
__device__ __forceinline__ uint4 realign16(uint4 a, uint4 b, int r) {
  uint32_t w0 = a.x, w1 = a.y, w2 = a.z, w3 = a.w;
  uint32_t w4 = b.x, w5 = b.y, w6 = b.z, w7 = b.w;
  if (r & 8) { w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7; }
  if (r & 4) { w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5; }
  const uint32_t s = (r & 3) * 8;
  uint4 o;
  o.x = __funnelshift_r(w0, w1, s);
  o.y = __funnelshift_r(w1, w2, s);
  o.z = __funnelshift_r(w2, w3, s);
  o.w = __funnelshift_r(w3, w4, s);
  return o;
}

__device__ __forceinline__ uint4 shfl(unsigned mask, uint4 v, int src, int g) {
  v.x = __shfl_sync(mask, v.x, src, g);
  v.y = __shfl_sync(mask, v.y, src, g);
  v.z = __shfl_sync(mask, v.z, src, g);
  v.w = __shfl_sync(mask, v.w, src, g);
  return v;
}

// G lanes per row; each lane moves up to U vectors per pass.  kAligned: the
// start is align1024(start_i) (the TPU row contract), so no realignment.
template <int G, int U, typename Index, bool kSkip, bool kAligned>
__global__ void __launch_bounds__(kThreads)
window_kernel(const uint4* __restrict__ table, int64_t n_bytes,
              const Index* __restrict__ start, int64_t n_rows, int64_t width,
              int nv, uint4* __restrict__ out) {
  const uint64_t policy = l2_evict_last();
  const int lane = threadIdx.x & 31;
  const int t = lane & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
  const int64_t last = n_bytes - width;
  const int64_t group =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t n_groups = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  for (int64_t row = group; row < n_rows; row += n_groups) {
    const int64_t o = static_cast<int64_t>(start[row]);
    if (kSkip && o < 0) continue;        // skipped row: no read, no write
    int64_t s = o < 0 ? 0 : (kAligned ? (o / kTile) * kTile : o);
    if (s > last) s = last;
    const int r = static_cast<int>(s & 15);
    const uint4* src = table + (s >> 4);
    uint4* dst = out + row * nv;
    if (kAligned || r == 0) {            // uniform within the group
      for (int j0 = 0; j0 < nv; j0 += G * U) {
        uint4 c[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int j = j0 + t + G * k;
          if (j < nv) c[k] = load_keep(src + j, policy);
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int j = j0 + t + G * k;
          if (j < nv) __stcs(dst + j, c[k]);
        }
      }
      continue;
    }
    // vector j of the output is bytes r .. r + 15 of vectors j and j + 1 of
    // src; the window's bytes reach vector vlast (<= nv), and only vectors
    // up to it are read (all inside the table, as s + width <= n_bytes)
    const int vlast = static_cast<int>((r + width - 1) >> 4);
    auto ld = [&](int j) {
      return j <= vlast ? load_keep(src + j, policy)
                        : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 cur = ld(t);
    for (int j0 = 0; j0 < nv; j0 += G * U) {
      uint4 c[U + 1];
      c[0] = cur;
#pragma unroll
      for (int k = 1; k <= U; ++k) c[k] = ld(j0 + t + G * k);
#pragma unroll
      for (int k = 0; k < U; ++k) {
        uint4 nxt;
        if (G == 1) {
          nxt = c[k + 1];
        } else {
          // vector j + 1 is lane t + 1's c[k]; for the last lane it is lane
          // 0's c[k + 1], so lane 0 offers that one
          nxt = shfl(mask, t == 0 ? c[k + 1] : c[k], t + 1, G);
        }
        const int j = j0 + t + G * k;
        if (j < nv) __stcs(dst + j, realign16(c[k], nxt, r));
      }
      cur = c[U];
    }
  }
}

int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_sm <= 0) n_sm = 132;
  }
  return n_sm;
}

template <int G, int U, typename Index, bool kSkip, bool kAligned>
int launch(const void* table, int64_t n_bytes, const void* start,
           int64_t n_rows, int64_t width, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const int nv = static_cast<int>((width + 15) / 16);
  const int64_t rows_per_cta = kThreads / G;
  int64_t blocks = (n_rows + rows_per_cta - 1) / rows_per_cta;
  // 8 CTAs of 256 threads fill an SM's 2,048 thread slots
  const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  if (blocks > cap) blocks = cap;
  window_kernel<G, U, Index, kSkip, kAligned>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint4*>(table), n_bytes,
          static_cast<const Index*>(start), n_rows, width, nv,
          static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table: int8 [n_bytes], 16-byte aligned, n_bytes a multiple of 16 and at
// least the window width.  Each launches on `stream` and returns
// cudaGetLastError() (0 on success).

// start: int64 [n_rows]; out: int8 [n_rows, round_up(width, 16)], of which
// the first `width` bytes of a row are the window; a row with a negative
// start is not written.
int window_launch(const void* table, int64_t n_bytes, const void* start,
                  int64_t n_rows, int64_t width, void* out, void* stream) {
  if (width <= 0 || width > n_bytes) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nv = (width + 15) / 16;
  using I = long long;
  if (nv <= 1) return launch<1, 1, I, true, false>(table, n_bytes, start, n_rows, width, out, stream);
  if (nv <= 2) return launch<2, 1, I, true, false>(table, n_bytes, start, n_rows, width, out, stream);
  if (nv <= 4) return launch<4, 1, I, true, false>(table, n_bytes, start, n_rows, width, out, stream);
  if (nv <= 8) return launch<8, 1, I, true, false>(table, n_bytes, start, n_rows, width, out, stream);
  if (nv <= 16) return launch<16, 1, I, true, false>(table, n_bytes, start, n_rows, width, out, stream);
  if (nv <= 32) return launch<32, 1, I, true, false>(table, n_bytes, start, n_rows, width, out, stream);
  return launch<32, 4, I, true, false>(table, n_bytes, start, n_rows, width, out, stream);
}

// off: int64 [n_rows]; out: int8 [n_rows, 2048]; a row with a negative
// offset is not written.  n_bytes a multiple of 1024.
int fetch_rows_launch(const void* table, int64_t n_bytes, const void* off,
                      int64_t n_rows, void* out, void* stream) {
  return launch<32, 4, long long, true, true>(table, n_bytes, off, n_rows,
                                              kFet, out, stream);
}

// pos: int32 [n_rows]; out: int8 [n_rows, 2048]; every row is written.
int tile_fetch_launch(const void* table, int64_t n_bytes, const void* pos,
                      int64_t n_rows, void* out, void* stream) {
  return launch<32, 4, int32_t, false, true>(table, n_bytes, pos, n_rows,
                                             kFet, out, stream);
}

const char* fetch_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
