// Threshold compaction and multi-threshold count on Hopper (sm_90a), C
// interface for ctypes.
//
// et_threshold_compact replaces the TPU kernel
// efficientteacher_tpu/ops/select_pallas.py _threshold_compact ->
// _compact_kernel (pl.pallas_call at :218), which both exact top-k engines
// (exact_topk_rows, exact_topk_elems) stand on. Computes what the plain
// PyTorch version efficientteacher_torch/ops/select_cuda.py
// threshold_compact computes:
//
//   scores (B, N) f32, tau_lo / tau_hi (B,) f32. For each image, the
//   survivors tau_lo <= s <= tau_hi are written in ascending index order
//   to out_scores (B, cap) f32 and out_idx (B, cap) int32; a survivor whose
//   slot is >= cap is dropped (later indices first); the slots after the
//   last survivor hold score -1 and index -1.
//
// et_count_ge computes what select_cuda.py _count_ge computes (the XLA
// count of select_pallas.py:247 _count_ge): counts (B, T) int32, the
// number of scores >= taus[b, t], for T <= 8 thresholds in one read.
//
// Compaction design: single pass, decoupled look-back.
//   - Each block takes a chunk ticket from an atomic counter (image-major),
//     so every chunk before it belongs to a block that is already running:
//     progress never depends on block scheduling.
//   - It loads its 8192-element chunk once, 16 bytes per thread and step
//     (8 steps of 1024 elements, kept in registers), and scans the
//     survivor counts in index order (a warp scan per step, one warp over
//     the 64 (step, warp) totals).
//   - It publishes its chunk total, looks back over the status words of
//     the chunks before it (128 at a time, one warp) until it meets an
//     inclusive prefix, and publishes its own inclusive prefix. Flag and
//     value share one 64-bit word, so no fence is needed. A chunk without
//     survivors has nothing to write: it publishes its zero and exits
//     without waiting (later chunks sum through it), unless it is its
//     image's last chunk, whose prefix is the image's survivor count.
//   - Survivors go to slot = prefix + rank within the chunk: the same
//     slots as the plain version, so the buffer is deterministic and
//     bit-equal. Only the survivor bits stay live across the look-back
//     (holding the values spilled); a survivor's value is reloaded from
//     L2 to write it. Blocks whose prefix is already past the cap write
//     nothing.
//   - A second, fully parallel kernel pads every image's tail with -1
//     from the last chunk's inclusive prefix (padding in that chunk's
//     block left one block per image writing up to 0.5 MB, a serial tail
//     at the end of the grid).
// int32 indices replace the TPU kernel's two-float index split, and there
// is no 128-lane carry buffer: both were Mosaic workarounds.
// What bounds it: device-memory bandwidth — one read of the scores
// (258 MB for the (32, 2,016,000) eval lattice) plus at most cap slots of
// writes per image; the look-back adds one 8-byte status word per chunk.
// In practice the look-back's latency (a block waits for its
// predecessors' counts while holding its SM slot) keeps it short of that
// bound; the count kernel, the same loads without it, comes closer.
//
// Count design: grid (chunks, B); each thread holds the T thresholds and T
// counters in registers, loads its 32 elements of the chunk with 16-byte
// loads, and the block's T sums go to the output by integer atomics (exact
// and order-independent). Bound: one read of the scores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                  // 16-byte loads per thread per chunk
constexpr int kStep = kThreads * 4;      // elements per load step
constexpr int kChunk = kStep * kVec;     // elements per block
constexpr int kMaxT = 8;                 // thresholds per count pass
static_assert(kVec * kWarps == 64, "warp 0 scans two totals per lane");

constexpr unsigned long long kAggregate = 1ull << 32;  // chunk total only
constexpr unsigned long long kPrefix = 2ull << 32;     // inclusive prefix

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Elements idx .. idx+3 of a row of n; NaN past the end (NaN survives no
// comparison). kV4: n % 4 == 0 and the rows are 16-byte aligned.
template <bool kV4>
__device__ __forceinline__ float4 load4(const float* __restrict__ s, int idx,
                                        int n) {
  const float nan = __int_as_float(0x7fffffff);
  if (kV4)
    return idx < n ? *reinterpret_cast<const float4*>(s + idx)
                   : make_float4(nan, nan, nan, nan);
  return make_float4(idx < n ? s[idx] : nan, idx + 1 < n ? s[idx + 1] : nan,
                     idx + 2 < n ? s[idx + 2] : nan,
                     idx + 3 < n ? s[idx + 3] : nan);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__device__ __forceinline__ bool survives(float s, float lo, float hi) {
  return s >= lo && s <= hi;
}

// Warp-wide: publish chunk c's total, look back to the nearest inclusive
// prefix, publish c's own, return the survivors before chunk c. Each round
// reads a window of 128 predecessors (4 per lane, nearest first): with
// hundreds of blocks in flight the nearest prefix is often that far back,
// and each round costs a trip to L2.
__device__ int look_back(unsigned long long* st, int c, int total,
                         int lane) {
  constexpr int kPer = 4;
  if (c == 0) {
    if (lane == 0) store_status(st, kPrefix | (unsigned)total);
    return 0;
  }
  if (lane == 0) store_status(st + c, kAggregate | (unsigned)total);
  int excl = 0;
  for (int end = c - 1;; end -= 32 * kPer) {
    unsigned long long w[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int idx = end - lane * kPer - q;
      w[q] = idx >= 0 ? load_status(st + idx) : kPrefix;  // prefix 0
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int idx = end - lane * kPer - q;
      while ((w[q] >> 32) == 0) w[q] = load_status(st + idx);
    }
    int first = kPer, sum = 0;  // this lane's nearest prefix, and the sum
#pragma unroll                  // of its words up to and including it
    for (int q = kPer - 1; q >= 0; --q)
      if ((w[q] >> 32) == 2) first = q;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (q <= first) sum += (int)(unsigned)w[q];
    const unsigned pmask = __ballot_sync(0xffffffffu, first < kPer);
    const int stop = pmask ? __ffs(pmask) - 1 : 31;  // lanes 0..stop add
    excl += warp_sum(lane <= stop ? sum : 0);
    if (pmask) break;
  }
  if (lane == 0) store_status(st + c, kPrefix | (unsigned)(excl + total));
  return excl;
}

template <bool kV4>
__global__ void __launch_bounds__(kThreads, 4)  // 64 registers: 4 blocks/SM
compact_kernel(const float* __restrict__ scores, int N, int nchunks,
               const float* __restrict__ tau_lo,
               const float* __restrict__ tau_hi, int cap,
               float* __restrict__ out_s, int* __restrict__ out_i,
               unsigned long long* __restrict__ status,
               unsigned int* __restrict__ ticket) {
  __shared__ int s_ticket, s_excl;
  __shared__ int s_off[kVec * kWarps];  // (step, warp) counts -> offsets
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_ticket = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = s_ticket / nchunks, c = s_ticket - b * nchunks;
  const float* s = scores + (size_t)b * N;
  const float lo = tau_lo[b], hi = tau_hi[b];
  const int base = c * kChunk + t * 4;

  float4 v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = load4<kV4>(s, base + j * kStep, N);
  unsigned m[kVec];  // survivor bits; the values are reloaded to write them
  int before[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    m[j] = survives(v[j].x, lo, hi) | survives(v[j].y, lo, hi) << 1 |
           survives(v[j].z, lo, hi) << 2 | survives(v[j].w, lo, hi) << 3;
    const int n = __popc(m[j]);
    const int incl = warp_inclusive_scan(n, lane);
    before[j] = incl - n;
    if (lane == 31) s_off[j * kWarps + warp] = incl;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 64 totals, in (step, warp) order
    const int a = s_off[2 * lane], a2 = s_off[2 * lane + 1];
    const int incl = warp_inclusive_scan(a + a2, lane);
    s_off[2 * lane] = incl - a - a2;
    s_off[2 * lane + 1] = incl - a2;
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    unsigned long long* st = status + (size_t)b * nchunks;
    int excl = cap;  // nothing to write
    if (total > 0 || c == 0 || c == nchunks - 1)
      excl = look_back(st, c, total, lane);
    else if (lane == 0)  // later chunks sum through this one's zero
      store_status(st + c, kAggregate);
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const int excl = s_excl;
  float* os = out_s + (size_t)b * cap;
  int* oi = out_i + (size_t)b * cap;
  if (excl < cap) {  // else every survivor of this chunk is past the cap
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (!m[j]) continue;
      int slot = excl + s_off[j * kWarps + warp] + before[j];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((m[j] >> q) & 1u) {
          if (slot < cap) {
            const int i = base + j * kStep + q;
            os[slot] = s[i];  // just read by this block: an L2 hit
            oi[slot] = i;
          }
          ++slot;
        }
      }
    }
  }
}

// The -1 tail of every image, after compact_kernel: slots from the image's
// survivor count (its last chunk's inclusive prefix) to cap.
__global__ void __launch_bounds__(kThreads)
pad_kernel(const unsigned long long* __restrict__ status, int nchunks,
           int cap, float* __restrict__ out_s, int* __restrict__ out_i) {
  const int b = blockIdx.y;
  const int total =
      (int)(unsigned)status[(size_t)b * nchunks + nchunks - 1];
  float* os = out_s + (size_t)b * cap;
  int* oi = out_i + (size_t)b * cap;
  for (int slot = min(total, cap) + blockIdx.x * kThreads + threadIdx.x;
       slot < cap; slot += gridDim.x * kThreads) {
    os[slot] = -1.f;
    oi[slot] = -1;
  }
}

template <int T, bool kV4>
__global__ void __launch_bounds__(kThreads)
count_ge_kernel(const float* __restrict__ scores, int N,
                const float* __restrict__ taus, int* __restrict__ counts) {
  __shared__ int s_red[kWarps][T];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, b = blockIdx.y;
  const float* s = scores + (size_t)b * N;
  float tau[T];
  int n[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    tau[k] = taus[b * T + k];
    n[k] = 0;
  }
  const int base = blockIdx.x * kChunk + t * 4;
  float4 v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = load4<kV4>(s, base + j * kStep, N);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
#pragma unroll
    for (int k = 0; k < T; ++k)
      n[k] += (v[j].x >= tau[k]) + (v[j].y >= tau[k]) + (v[j].z >= tau[k]) +
              (v[j].w >= tau[k]);
  }
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int w = warp_sum(n[k]);
    if (lane == 0) s_red[warp][k] = w;
  }
  __syncthreads();
  if (t < T) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += s_red[w][t];
    atomicAdd(counts + b * T + t, sum);
  }
}

bool rows_aligned(const void* p, int n) {
  return n % 4 == 0 && ((uintptr_t)p & 15) == 0;
}

template <int T>
void launch_count(const float* scores, int B, int N, const float* taus,
                  int* counts, cudaStream_t st) {
  const dim3 grid((N + kChunk - 1) / kChunk, B);
  if (rows_aligned(scores, N))
    count_ge_kernel<T, true><<<grid, kThreads, 0, st>>>(scores, N, taus,
                                                        counts);
  else
    count_ge_kernel<T, false><<<grid, kThreads, 0, st>>>(scores, N, taus,
                                                         counts);
}

}  // namespace

extern "C" int et_compact_chunk() { return kChunk; }

// scratch: (1 + B * nchunks) 8-byte words: the ticket, then one status
// word per chunk; zeroed here before the launch.
extern "C" int et_threshold_compact(const void* scores, int B, int N,
                                    const void* tau_lo, const void* tau_hi,
                                    void* scratch, int cap, void* out_scores,
                                    void* out_idx, void* stream) {
  if (B > 0 && N > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int nchunks = (N + kChunk - 1) / kChunk;
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, (size_t)(1 + (size_t)B * nchunks) * 8, st);
    if (err != cudaSuccess) return (int)err;
    unsigned long long* words = (unsigned long long*)scratch;
    auto kernel = rows_aligned(scores, N) ? compact_kernel<true>
                                          : compact_kernel<false>;
    kernel<<<B * nchunks, kThreads, 0, st>>>(
        (const float*)scores, N, nchunks, (const float*)tau_lo,
        (const float*)tau_hi, cap, (float*)out_scores, (int*)out_idx,
        words + 1, (unsigned int*)words);
    const cudaError_t err2 = cudaGetLastError();
    if (err2 != cudaSuccess) return (int)err2;
    const int pad_blocks = min((cap + kThreads - 1) / kThreads, 16);
    pad_kernel<<<dim3(pad_blocks, B), kThreads, 0, st>>>(
        words + 1, nchunks, cap, (float*)out_scores, (int*)out_idx);
  }
  return (int)cudaGetLastError();
}

extern "C" int et_count_ge_max_t() { return kMaxT; }

extern "C" int et_count_ge(const void* scores, int B, int N,
                           const void* taus, int T, void* counts,
                           void* stream) {
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0) {
    const cudaError_t err =
        cudaMemsetAsync(counts, 0, (size_t)B * T * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0 && N > 0) {
    const float* s = (const float*)scores;
    const float* tau = (const float*)taus;
    int* out = (int*)counts;
    switch (T) {
      case 1: launch_count<1>(s, B, N, tau, out, st); break;
      case 2: launch_count<2>(s, B, N, tau, out, st); break;
      case 3: launch_count<3>(s, B, N, tau, out, st); break;
      case 4: launch_count<4>(s, B, N, tau, out, st); break;
      case 5: launch_count<5>(s, B, N, tau, out, st); break;
      case 6: launch_count<6>(s, B, N, tau, out, st); break;
      case 7: launch_count<7>(s, B, N, tau, out, st); break;
      default: launch_count<8>(s, B, N, tau, out, st); break;
    }
  }
  return (int)cudaGetLastError();
}
