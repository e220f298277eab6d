// Greedy NMS keep mask on Hopper (sm_90a), C interface for ctypes.
//
// Replaces the TPU kernel efficientteacher_tpu/ops/nms_pallas.py
// greedy_nms_keep_pallas -> _nms_kernel (pl.pallas_call at :138). Computes
// exactly what the pure oracle efficientteacher_tpu/ops/nms.py:43
// greedy_nms_keep computes, and what the plain PyTorch version
// efficientteacher_torch/ops/nms_cuda.py greedy_nms_keep computes:
//
//   boxes (B, K, 4) f32 xyxy, score-sorted and class-offset; valid (B, K)
//   bool; keep (B, K) bool out. K is a multiple of `tile` (<= 256).
//   keep starts as valid; tiles are resolved in order up to the tile of the
//   last valid row; a tile is first suppressed by the kept rows of every
//   earlier tile, then resolved in greedy order inside itself. With
//   stop_at >= 0 the sweep stops at the first tile boundary where at least
//   stop_at rows are kept; later tiles keep their `valid` value (the same
//   tile-boundary exit as the oracle, so whole masks are equal).
//
// IoU is ops/boxes.py box_iou with eps 0 (the oracle's; the Pallas kernel
// adds 1e-9), in the same operation order, with explicitly rounded
// intrinsics and the library built with --fmad=false: a single flipped
// `iou > thr` changes the keep mask.
//
// Design. One block per image, 256 threads, one thread per row of the
// current tile.
//   - Cross-suppression: each earlier tile is staged in shared memory
//     (256 boxes + keep flags, ~5 KB) and every live thread tests its box
//     against the kept boxes there, stopping at the first hit. The Pallas
//     kernel kept the whole image in VMEM; at eval K = 30208 rows the
//     coordinates alone are 472 KB, beyond the 227 KB of shared memory a
//     block may use, so earlier tiles are re-read from global memory (L2).
//   - Inside the tile: each thread j builds the 256-bit mask of live rows
//     i < j with iou(i, j) > thr (8 KB of shared memory); then one warp
//     walks the tile in order with the kept set as a bitmask (lane w holds
//     word w): j is kept iff mask_j & kept is empty. Greedy NMS is unique,
//     so this gives the oracle's fixpoint result without iterating.
// What bounds it: the O(tiles^2 * 256^2) IoU tests of the cross pass (each
// with an IEEE division) and the re-reads of earlier tiles; the sweep is
// bounded by the last valid row and by stop_at. B = 32 blocks leave most
// of the 132 SMs idle: splitting an image's cross pass over blocks is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // = the largest tile
constexpr int kWords = kThreads / 32;

struct Box {
  float x1, y1, x2, y2, area;
};

__device__ __forceinline__ Box load_box(const float4* p) {
  const float4 c = *p;
  return {c.x, c.y, c.z, c.w,
          __fmul_rn(__fsub_rn(c.z, c.x), __fsub_rn(c.w, c.y))};
}

// box_iou(a, b) > thr with eps 0; a is the earlier (higher-scored) row.
__device__ __forceinline__ bool iou_above(const Box& a, const Box& b,
                                          float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  return __fdiv_rn(inter, uni) > thr;  // 0/0 = NaN compares false
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int K, int tile, float thr, int stop_at) {
  __shared__ Box sbox[kThreads];
  __shared__ uint8_t sflag[kThreads];
  __shared__ uint32_t smask[kThreads][kWords + 1];  // +1: no bank conflicts
  __shared__ uint32_t skept[kWords];
  __shared__ int swarp[kThreads / 32];
  __shared__ int s_last, s_count;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float4* bx = boxes + (size_t)blockIdx.x * K;
  const uint8_t* vb = valid + (size_t)blockIdx.x * K;
  uint8_t* kb = keep + (size_t)blockIdx.x * K;

  // keep = valid; the last valid row bounds the sweep
  int last = -1;
  for (int r = t; r < K; r += kThreads) {
    const uint8_t v = vb[r];
    kb[r] = v;
    if (v) last = r;
  }
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if (lane == 0) swarp[warp] = last;
  __syncthreads();
  if (t == 0) {
    int m = -1;
    for (int w = 0; w < kThreads / 32; ++w) m = max(m, swarp[w]);
    s_last = m;
    s_count = 0;
  }
  __syncthreads();
  const int valid_tiles = (s_last + tile) / tile;  // 0 when nothing is valid
  const bool in_tile = t < tile;

  for (int ti = 0; ti < valid_tiles; ++ti) {
    if (stop_at >= 0 && s_count >= stop_at) break;  // block-uniform
    const int row = ti * tile + t;
    Box mine = {};
    bool alive = false;
    if (in_tile) {
      mine = load_box(bx + row);
      alive = kb[row] != 0;
    }
    // 1. suppression by the kept rows of every earlier tile
    for (int tj = 0; tj < ti; ++tj) {
      if (in_tile) {
        sbox[t] = load_box(bx + tj * tile + t);
        sflag[t] = kb[tj * tile + t];
      }
      __syncthreads();
      if (alive) {
        for (int i = 0; i < tile; ++i) {
          if (sflag[i] && iou_above(sbox[i], mine, thr)) {
            alive = false;
            break;
          }
        }
      }
      __syncthreads();
    }
    // 2. greedy order inside the tile
    if (in_tile) {
      sbox[t] = mine;
      sflag[t] = alive;
    }
    __syncthreads();
    if (in_tile) {
      for (int w = 0; w < kWords; ++w) {
        uint32_t bits = 0;
        const int i0 = w * 32, i1 = min(i0 + 32, t);
        if (alive) {
          for (int i = i0; i < i1; ++i)
            if (sflag[i] && iou_above(sbox[i], mine, thr))
              bits |= 1u << (i - i0);
        }
        smask[t][w] = bits;
      }
    }
    __syncthreads();
    if (warp == 0) {
      uint32_t kept = 0;  // lane w < kWords holds word w of the kept set
      for (int j = 0; j < tile; ++j) {
        if (!sflag[j]) continue;  // warp-uniform
        const uint32_t hit = lane < kWords ? (smask[j][lane] & kept) : 0u;
        if (!__any_sync(0xffffffffu, hit) && lane == (j >> 5))
          kept |= 1u << (j & 31);
      }
      if (lane < kWords) skept[lane] = kept;
      int n = lane < kWords ? __popc(kept) : 0;
      for (int o = 16; o > 0; o >>= 1)
        n += __shfl_xor_sync(0xffffffffu, n, o);
      if (lane == 0) s_count += n;
    }
    __syncthreads();
    if (in_tile) kb[row] = (skept[t >> 5] >> (t & 31)) & 1u;
    __syncthreads();  // this tile's keep flags are read by later tiles
  }
}

}  // namespace

extern "C" int et_nms_keep(const void* boxes, const void* valid, void* keep,
                           int B, int K, int tile, float iou_thres,
                           int stop_at, void* stream) {
  if (B > 0 && K > 0)
    nms_keep_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)boxes, (const uint8_t*)valid, (uint8_t*)keep, K, tile,
        iou_thres, stop_at);
  return (int)cudaGetLastError();
}

extern "C" const char* et_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
