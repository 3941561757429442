// Aligned row fetch: out[i] = table[a_i : a_i + 2048], a_i = (off_i / 1024) * 1024.
//
// Two entry points share one row copy:
//
//   fetch_rows_launch replaces the Pallas kernel
//     star_tpu/ops/fetch.py:_fetch_rows_pallas (entered through fetch_rows),
//     the random-access primitive of the suffix-array search and of the
//     device grow: every SAi entry, SA row and suffix text window of the MMP
//     bisection, every per-lane read / genome / mismatch-cap window of the
//     grow and every lane-state row move is one such row.  int64 offsets; a
//     negative offset skips its row.
//   tile_fetch_launch replaces the Pallas kernel
//     star_tpu/ops/pallas_fetch.py:make_tile_fetch, the TPU's parallel-DMA
//     window gather prototype.  int32 positions; no position is skipped (a
//     negative one reads row 0).
//
// Bound: pure data movement.  A call with B live rows writes B * 2048 bytes
// and reads each distinct 1 KiB table tile its rows cover once (at most
// B * 2048 bytes; fewer when rows share tiles), plus the offsets; its least
// time is those bytes over the card's HBM bandwidth (3.35 TB/s on an H100
// SXM).  The rows are scattered over the table, so the cost is the number
// of independent 2 KB transfers in flight, not arithmetic.
//
// Design: one warp per output row.  The warp moves its 2,048 bytes as 128
// 16-byte vector loads, four per lane, neighbouring lanes on neighbouring
// addresses, so each of the four steps is one fully coalesced 512-byte
// transaction; all four loads are issued before the first store.  A CTA of
// 8 warps walks rows in a grid-stride loop over a grid sized to fill every
// SM, so thousands of rows are in flight at once (the role of the TPU
// kernels' 32 DMA semaphores).  Offsets are 64-bit inside the kernel (no
// 2 GiB table limit) and there is no per-call row cap.
//
// A row start is clamped into [0, n_bytes - 2048] so that no offset can read
// past the table; for every offset the callers produce (off < n_raw, with
// pad_table's FET + TILE bytes of padding) the clamp changes nothing.  On
// the TPU such an offset faults the DMA.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kTile = 1024;
constexpr int64_t kFet = 2048;
constexpr int kWarps = 8;                       // warps per CTA
constexpr int kVec = kFet / 16 / 32;            // uint4 loads per lane = 4

template <typename Index, bool kSkipNegative>
__global__ void __launch_bounds__(kWarps * 32)
row_fetch_kernel(const uint4* __restrict__ table, int64_t n_bytes,
                 const Index* __restrict__ off, int64_t n_rows,
                 uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t last = n_bytes - kFet;          // multiple of kTile
  for (int64_t row = warp0; row < n_rows; row += n_warps) {
    const int64_t o = __ldg(off + row);  // one broadcast load per warp
    if (kSkipNegative && o < 0) continue;       // skipped lane: no read, no write
    int64_t start = o < 0 ? 0 : (o / kTile) * kTile;
    if (start > last) start = last;
    const uint4* src = table + start / 16;
    uint4* dst = out + row * (kFet / 16);
    uint4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = __ldg(src + lane + 32 * k);
#pragma unroll
    for (int k = 0; k < kVec; ++k) dst[lane + 32 * k] = v[k];
  }
}

template <typename Index, bool kSkipNegative>
int launch(const void* table, int64_t n_bytes, const void* off,
           int64_t n_rows, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_sm <= 0) n_sm = 132;
  }
  // 8 CTAs of 8 warps fill an SM's 64 warp slots
  int64_t blocks = (n_rows + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(n_sm) * 8;
  if (blocks > cap) blocks = cap;
  row_fetch_kernel<Index, kSkipNegative>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint4*>(table), n_bytes,
          static_cast<const Index*>(off), n_rows, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table: int8 [n_bytes], 16-byte aligned, n_bytes a multiple of 1024 and
// >= 2048.  out: int8 [n_rows, 2048].  Each launches on `stream` and
// returns cudaGetLastError() (0 on success).

// off: int64 [n_rows]; a row with a negative offset is not written.
int fetch_rows_launch(const void* table, int64_t n_bytes, const void* off,
                      int64_t n_rows, void* out, void* stream) {
  return launch<long long, true>(table, n_bytes, off, n_rows, out, stream);
}

// pos: int32 [n_rows]; every row is written.
int tile_fetch_launch(const void* table, int64_t n_bytes, const void* pos,
                      int64_t n_rows, void* out, void* stream) {
  return launch<int32_t, false>(table, n_bytes, pos, n_rows, out, stream);
}

const char* fetch_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
