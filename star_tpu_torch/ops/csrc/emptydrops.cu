// EmptyDrops_CR's Monte-Carlo null: sim_n multinomial draws from the ambient
// profile and, for each distinct candidate UMI count, how many of them fall
// below each candidate's observed log-probability.
//
// Replaces no TPU kernel: star_tpu (solo/emptydrops.py) runs this loop in
// Python, one std::mt19937 after another.  Here it is one thread per
// simulation:
//
//   * The thread seeds std::mt19937 from (19760110 * (isim + 1)) mod 2^32 and
//     keeps the 624-word state in a column of the caller's [624, sim_n]
//     scratch: a warp's words side by side, as local memory would lay them
//     out, but allocated by the caller (a 2.5 KB local array per thread
//     makes CUDA reserve that much for every thread the card can
//     hold, outside PyTorch's allocator).
//     It seeds only the words its draws read and twists a word just before
//     drawing it, in the generator's own order, so the words are
//     std::mt19937's.
//   * Each draw is libstdc++'s generate_canonical<double, 53>: two words, the
//     first low, clamped below 1.0; the gene is the lower bound of the
//     uniform in the cumulative profile cp (clamped to the last gene).
//   * The row is summed in double in the host's order,
//     ((row + logp[g]) + logtab[ic]) - logtab[cur[g]], with __dadd_rn /
//     __dsub_rn so that the compiler contracts and reorders nothing.
//     logtab[k] = log(k) comes from the host's correctly rounded log, so the
//     rows are bit-identical to the host's.
//   * cur[g], the draws of gene g so far, lives in a per-simulation open-
//     addressing table of 2^slot_bits >= 2 * max_count slots that the caller
//     provides ([slots, sim_n] int2: gene, count), not in sim_n x genes.
//   * When the thread reaches a count that some candidate has (group_count,
//     ascending), it counts by binary search the group's sorted observed
//     values that are <= its row and adds one to that slot of the group's
//     histogram.  The host's prefix sum of the histogram is each candidate's
//     n_lower (the simulations strictly below it).  The [sim_n, max_count]
//     table of rows is never written.
//
// Bound: a serial chain per thread, not bytes.  A thread seeds up to 623
// words (each a multiply on the last), then per draw twists and tempers two
// words, walks ~log2(genes) steps of a binary search and one hash probe,
// each step waiting on the last.  A few hundred threads per SM hide nothing
// of one chain's latency; the kernel takes about one thread's chain.  cp and
// logp sit in shared memory when they fit (the `shared` argument: the caller
// decides from their length), so the binary search's loads are short.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 624;
constexpr int kM = 397;
constexpr uint32_t kMatrixA = 0x9908B0DFu;
constexpr uint32_t kUpper = 0x80000000u;
constexpr uint32_t kLower = 0x7FFFFFFFu;
constexpr int kThreads = 128;

// word `pos` of the current generation: twisted from the state in place
// (the words after it still hold the last generation), then tempered.  Word
// i of the state is mt[i * stride].
__device__ __forceinline__ uint32_t next_word(uint32_t* mt, int64_t stride,
                                              int& pos) {
  if (pos == kN) pos = 0;
  const int i = pos++;
  const uint32_t y = (mt[i * stride] & kUpper) |
                     (mt[(i + 1 == kN ? 0 : i + 1) * stride] & kLower);
  uint32_t v = mt[(i + kM < kN ? i + kM : i + kM - kN) * stride] ^ (y >> 1) ^
               ((y & 1u) ? kMatrixA : 0u);
  mt[i * stride] = v;
  v ^= v >> 11;
  v ^= (v << 7) & 0x9D2C5680u;
  v ^= (v << 15) & 0xEFC60000u;
  v ^= v >> 18;
  return v;
}

// the new count of gene g in the thread's table (column isim of [slots, n])
__device__ __forceinline__ int tally(int2* tab, int64_t stride, int bits,
                                     int g) {
  const uint32_t mask = (1u << bits) - 1u;
  uint32_t h = (static_cast<uint32_t>(g) * 2654435761u) >> (32 - bits);
  for (;; h = (h + 1u) & mask) {
    int2 e = tab[h * stride];
    if (e.x == g) {
      tab[h * stride] = make_int2(g, e.y + 1);
      return e.y + 1;
    }
    if (e.x < 0) {
      tab[h * stride] = make_int2(g, 1);
      return 1;
    }
  }
}

// one count for the slot of group g that row r falls in: the group's
// observed values <= r (upper bound); slot m means below none of them
__device__ __forceinline__ void count_row(const int* __restrict__ group_off,
                                          const double* __restrict__ obs,
                                          int* __restrict__ hist, int g,
                                          double r) {
  const int lo = group_off[g];
  int a = 0, b = group_off[g + 1] - lo;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (obs[lo + m] <= r) a = m + 1; else b = m;
  }
  atomicAdd(hist + lo + g + a, 1);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
null_kernel(const double* __restrict__ cp_g, const double* __restrict__ logp_g,
            int n_genes, const double* __restrict__ logtab, int max_count,
            const int* __restrict__ group_count,
            const int* __restrict__ group_off, int n_groups,
            const double* __restrict__ obs, int* __restrict__ hist,
            uint32_t* __restrict__ state, int2* __restrict__ table,
            int slot_bits, int sim_n) {
  extern __shared__ double smem[];
  const double* cp = cp_g;
  const double* logp = logp_g;
  if (kShared) {
    for (int i = threadIdx.x; i < n_genes; i += blockDim.x) {
      smem[i] = cp_g[i];
      smem[n_genes + i] = logp_g[i];
    }
    __syncthreads();
    cp = smem;
    logp = smem + n_genes;
  }
  const int isim = blockIdx.x * blockDim.x + threadIdx.x;
  if (isim >= sim_n) return;

  // seed the words the draws read: twisting word i reads words i, i + 1 and
  // i + 397, so 2 * max_count words of the first generation need words up
  // to 2 * max_count + 396; a second generation needs them all
  const int64_t stride = sim_n;
  uint32_t* mt = state + isim;
  const int last = min(kN - 1, 2 * max_count + 396);
  uint32_t x = 19760110u * static_cast<uint32_t>(isim + 1);
  mt[0] = x;
  for (int i = 1; i <= last; ++i) {
    x = 1812433253u * (x ^ (x >> 30)) + static_cast<uint32_t>(i);
    mt[i * stride] = x;
  }
  int pos = 0;

  int2* tab = table + isim;
  for (int s = 0; s < (1 << slot_bits); ++s)
    tab[s * stride] = make_int2(-1, 0);

  double row = 0.0;
  int g = 0;
  if (g < n_groups && group_count[g] == 0)
    count_row(group_off, obs, hist, g++, row);
  for (int ic = 1; ic <= max_count; ++ic) {
    const uint32_t w0 = next_word(mt, stride, pos);
    const uint32_t w1 = next_word(mt, stride, pos);
    double u = __dmul_rn(__dadd_rn(static_cast<double>(w0),
                                   __dmul_rn(static_cast<double>(w1),
                                             4294967296.0)),
                         0x1p-64);
    if (u >= 1.0) u = 0x1.fffffffffffffp-1;
    int a = 0, b = n_genes;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (cp[m] < u) a = m + 1; else b = m;
    }
    if (a >= n_genes) a = n_genes - 1;
    const int c = tally(tab, stride, slot_bits, a);
    row = __dsub_rn(__dadd_rn(__dadd_rn(row, logp[a]), logtab[ic]),
                    logtab[c]);
    if (g < n_groups && group_count[g] == ic)
      count_row(group_off, obs, hist, g++, row);
  }
}

}  // namespace

extern "C" {

// cp, logp: double [n_genes]; logtab: double [max_count + 1], logtab[k] =
// log(k); group_count: int32 [n_groups], ascending distinct candidate counts
// in [0, max_count]; group_off: int32 [n_groups + 1], group g's observed
// values are obs[group_off[g] : group_off[g + 1]], ascending; hist: int32
// [group_off[n_groups] + n_groups], zeroed, group g's slots from
// group_off[g] + g; state: uint32 [624, sim_n] scratch; table: int2
// [2^slot_bits, sim_n] scratch, 2^slot_bits >= 2 * max_count.  shared: cp
// and logp in shared memory (16 * n_genes bytes of it).  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
int mc_null_launch(const void* cp, const void* logp, int64_t n_genes,
                   const void* logtab, int64_t max_count,
                   const void* group_count, const void* group_off,
                   int64_t n_groups, const void* obs, void* hist,
                   void* state, void* table, int64_t slot_bits, int64_t sim_n,
                   int64_t shared, void* stream) {
  if (n_genes <= 0 || max_count < 0 || slot_bits < 1 || slot_bits > 30 ||
      sim_n <= 0 || sim_n > (int64_t{1} << 31) - kThreads ||
      (int64_t{1} << slot_bits) < 2 * max_count)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((sim_n + kThreads - 1) / kThreads);
  size_t bytes = 0;
  auto kernel = null_kernel<false>;
  if (shared) {
    bytes = 16 * static_cast<size_t>(n_genes);
    kernel = null_kernel<true>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(cp), static_cast<const double*>(logp),
      static_cast<int>(n_genes), static_cast<const double*>(logtab),
      static_cast<int>(max_count), static_cast<const int*>(group_count),
      static_cast<const int*>(group_off), static_cast<int>(n_groups),
      static_cast<const double*>(obs), static_cast<int*>(hist),
      static_cast<uint32_t*>(state), static_cast<int2*>(table),
      static_cast<int>(slot_bits), static_cast<int>(sim_n));
  return static_cast<int>(cudaGetLastError());
}

const char* mc_null_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
