// Threshold compaction on Hopper (sm_90a), C interface for ctypes.
//
// Replaces the TPU kernel efficientteacher_tpu/ops/select_pallas.py
// _threshold_compact -> _compact_kernel (pl.pallas_call at :218), which
// both exact top-k engines (exact_topk_rows, exact_topk_elems) stand on.
// Computes what the plain PyTorch version
// efficientteacher_torch/ops/select_cuda.py threshold_compact computes:
//
//   scores (B, N) f32, tau_lo / tau_hi (B,) f32. For each image, the
//   survivors tau_lo <= s <= tau_hi are written in ascending index order
//   to out_scores (B, cap) f32 and out_idx (B, cap) int32; a survivor whose
//   slot is >= cap is dropped (later indices first); the slots after the
//   last survivor hold score -1 and index -1.
//
// Design: a deterministic two-pass prefix-sum compaction, no atomics.
//   1. count_kernel, grid (chunks, B): each block counts its chunk's
//      survivors.
//   2. compact_kernel, same grid: each block sums the counts of the chunks
//      before it (~500 at eval: N = 2,016,000 pairs in chunks of 4096),
//      then walks its chunk in index order, 256 elements a step; a
//      block-wide exclusive scan (__ballot_sync + __popc inside a warp,
//      the 8 warp totals through shared memory) gives each survivor its
//      slot. The block of the last chunk pads the tail with -1.
// int32 indices replace the TPU kernel's two-float index split, and there
// is no 128-lane carry buffer: both were Mosaic workarounds.
// What bounds it: device-memory bandwidth — the scores are read twice
// (2 x 258 MB for the (32, 2,016,000) eval lattice); the writes are at
// most cap slots per image. Chunks without survivors, or wholly past the
// cap, skip the second read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements per block

__device__ __forceinline__ bool survives(float s, float lo, float hi) {
  return s >= lo && s <= hi;
}

// Sum over the block; every thread gets the total.
__device__ __forceinline__ int block_sum(int v, int* sred) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // sred may still be read from a previous call
  if (lane == 0) sred[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kThreads / 32; ++w) total += sred[w];
  return total;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ scores, int N,
             const float* __restrict__ tau_lo,
             const float* __restrict__ tau_hi, int* __restrict__ counts) {
  __shared__ int sred[kThreads / 32];
  const int c = blockIdx.x, b = blockIdx.y;
  const float* s = scores + (size_t)b * N;
  const float lo = tau_lo[b], hi = tau_hi[b];
  const int end = min((c + 1) * kChunk, N);
  int n = 0;
  for (int i = c * kChunk + threadIdx.x; i < end; i += kThreads)
    n += survives(s[i], lo, hi);
  n = block_sum(n, sred);
  if (threadIdx.x == 0) counts[(size_t)b * gridDim.x + c] = n;
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const float* __restrict__ scores, int N,
               const float* __restrict__ tau_lo,
               const float* __restrict__ tau_hi,
               const int* __restrict__ counts, int cap,
               float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ int sred[kThreads / 32];
  __shared__ int swarp[kThreads / 32];
  const int c = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int* cb = counts + (size_t)b * nchunks;
  const float* s = scores + (size_t)b * N;
  float* os = out_s + (size_t)b * cap;
  int* oi = out_i + (size_t)b * cap;

  int pre = 0;
  for (int j = t; j < c; j += kThreads) pre += cb[j];
  int base = block_sum(pre, sred);  // survivors in the chunks before this one

  if (cb[c] > 0 && base < cap) {
    const float lo = tau_lo[b], hi = tau_hi[b];
    const int end = min((c + 1) * kChunk, N);
    for (int off = c * kChunk; off < end; off += kThreads) {
      const int i = off + t;
      const bool m = i < end && survives(s[i], lo, hi);
      const uint32_t ballot = __ballot_sync(0xffffffffu, m);
      if (lane == 0) swarp[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, step = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        before += w < warp ? swarp[w] : 0;
        step += swarp[w];
      }
      const int slot = base + before + __popc(ballot & ((1u << lane) - 1u));
      if (m && slot < cap) {
        os[slot] = s[i];
        oi[slot] = i;
      }
      base += step;
      __syncthreads();  // swarp is rewritten in the next step
    }
  } else {
    base += cb[c];
  }
  if (c == nchunks - 1) {  // base is now the image's survivor count
    for (int slot = min(base, cap) + t; slot < cap; slot += kThreads) {
      os[slot] = -1.f;
      oi[slot] = -1;
    }
  }
}

}  // namespace

extern "C" int et_compact_chunk() { return kChunk; }

extern "C" int et_threshold_compact(const void* scores, int B, int N,
                                    const void* tau_lo, const void* tau_hi,
                                    void* counts, int cap, void* out_scores,
                                    void* out_idx, void* stream) {
  if (B > 0 && N > 0) {
    const dim3 grid((N + kChunk - 1) / kChunk, B);
    cudaStream_t st = (cudaStream_t)stream;
    count_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)scores, N, (const float*)tau_lo, (const float*)tau_hi,
        (int*)counts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    compact_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)scores, N, (const float*)tau_lo, (const float*)tau_hi,
        (const int*)counts, cap, (float*)out_scores, (int*)out_idx);
  }
  return (int)cudaGetLastError();
}
