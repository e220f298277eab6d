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
// Design. A cluster of four 256-thread blocks per image (128 of the 132
// SMs at batch 32), 4 threads per tile row, each block 64 rows of the tile;
// the blocks exchange the tile's alive flags and suppression masks through
// distributed shared memory. (One 1024-thread block per image was
// measured too and was slower wherever the sweep has work: PERF.md.)
//   - Init: 16-byte loads copy valid to keep and find the last valid row.
//   - Kept list: the boxes kept so far, appended after each tile, in
//     every block's shared memory (1536 boxes; with stop_at the list never
//     holds more than stop_at - 1 + tile). Beyond that it spills to one
//     global scratch region per image, from the wrapper: each block writes
//     a quarter of the spilled rows and a cluster barrier publishes them
//     before the next tile reads them (through L2). Each live row of the
//     current tile tests the list (4 threads, a strided quarter each) and
//     stops at the first hit. Suppression is an OR over kept rows, so the
//     order of the tests cannot change the mask.
//   - Inside the tile: each live row i builds its forward mask (live rows
//     j > i with iou(i, j) > thr, bit-scanned with __ffs); then one thread
//     walks only the rows that are live and not yet removed, by bit-scan,
//     with the kept and removed sets in registers. Greedy NMS is unique,
//     so this gives the oracle's fixpoint result.
//   - Division-free test: iou = fl(inter / uni) > thr is decided by
//     comparing inter with fl(thr * uni) +- uni * 2^-20, a band wider than
//     every rounding error of the comparison; only pairs inside the band
//     (or degenerate unions) take __fdiv_rn. Every decision is the
//     division's.
// What bounds it: the serial walk and the barriers of each tile (two
// cluster barriers per tile, a third while the list spills), and the IoU
// tests of live rows against the kept list; the sweep is bounded by the
// last valid row and by stop_at. The bytes (boxes once, valid once, keep
// once) are ~5 us at eval.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 256;               // the largest tile
constexpr int kWords = kTile / 32;       // words of a tile bitmask
constexpr int kCS = 4;                   // blocks per image (a cluster)
constexpr int kNT = 256;                 // threads per block
constexpr int kRC = kTile / kCS;         // tile rows per block
constexpr int kParts = kNT / kRC;        // threads per tile row
constexpr int kListCap = 1536;           // kept boxes in shared memory
static_assert(kWords == 2 * kParts, "each part owns two mask words");

struct Box {
  float x1, y1, x2, y2, area;
};

__device__ __forceinline__ Box make_box(float4 c) {
  return {c.x, c.y, c.z, c.w,
          __fmul_rn(__fsub_rn(c.z, c.x), __fsub_rn(c.w, c.y))};
}

struct Thr {
  float thr;
  int fast;  // thr in [2^-100, 1]: the band test below is exact
};

// box_iou(a, b) > thr with eps 0; a is the earlier (higher-scored) row.
// Fast path: with q = fl(thr * uni) and m = uni * 2^-20 (exact), the true
// boundary mu * uni (mu: the midpoint between thr and the next float)
// lies within 2^-22 * uni of q, and fl(q +- m) within another 2^-24 * uni,
// so inter > fl(q + m) implies inter / uni > mu (rounds above thr) and
// inter < fl(q - m) implies inter / uni < thr. uni in [2^-20, 2^100]
// keeps every product normal; NaN fails the range test.
__device__ __forceinline__ bool iou_above(const Box& a, const Box& b,
                                          Thr t) {
  const float w = fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  if (t.fast && uni >= 0x1p-20f && uni <= 0x1p100f) {
    const float q = __fmul_rn(t.thr, uni), m = __fmul_rn(uni, 0x1p-20f);
    if (inter > __fadd_rn(q, m)) return true;
    if (inter < __fsub_rn(q, m)) return false;
  }
  return __fdiv_rn(inter, uni) > t.thr;  // 0/0 = NaN compares false
}

__device__ __forceinline__ int last_set_byte(uint4 v, int base) {
  if (v.w) return base + 12 + ((31 - __clz(v.w)) >> 3);
  if (v.z) return base + 8 + ((31 - __clz(v.z)) >> 3);
  if (v.y) return base + 4 + ((31 - __clz(v.y)) >> 3);
  if (v.x) return base + ((31 - __clz(v.x)) >> 3);
  return -1;
}

struct Smem {
  float4 list[kListCap];
  float list_area[kListCap];
  float4 tile[kTile];
  float tile_area[kTile];
  uint32_t mask[kTile][kWords];  // forward suppression masks
  uint8_t alive[kTile];          // the tile's rows live after the list test
  uint8_t dead[kTile];           // this block's rows hit by the list
  uint32_t kept[kWords];
  int red[32];
  int last, count, list_len, list_base;
};

// Store v at p in the shared memory of every block of the cluster.
template <typename T>
__device__ __forceinline__ void cluster_store(cg::cluster_group& cl, T* p,
                                              T v) {
#pragma unroll
  for (int r = 0; r < kCS; ++r) *cl.map_shared_rank(p, r) = v;
}

__global__ void __cluster_dims__(kCS, 1, 1) __launch_bounds__(kNT)
nms_keep_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int K, int tile, Thr thr, int stop_at, float4* spill,
                int spill_rows) {
  __shared__ Smem sm;
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cl.block_rank(), img = blockIdx.x / kCS;
  const float4* bx = boxes + (size_t)img * K;
  const uint8_t* vb = valid + (size_t)img * K;
  uint8_t* kb = keep + (size_t)img * K;
  float4* sp = spill ? spill + (size_t)img * spill_rows : nullptr;

  // keep = valid (each block a share); every block finds the last valid row
  int last = -1;
  if ((K & 15) == 0 && ((uintptr_t)vb & 15) == 0 &&
      ((uintptr_t)kb & 15) == 0) {
    const uint4* v4 = reinterpret_cast<const uint4*>(vb);
    uint4* k4 = reinterpret_cast<uint4*>(kb);
    for (int q = tid; q < K / 16; q += kNT) {
      const uint4 v = v4[q];
      if (q % kCS == rank) k4[q] = v;
      last = max(last, last_set_byte(v, q * 16));
    }
  } else {
    for (int r = tid; r < K; r += kNT) {
      const uint8_t v = vb[r];
      if (r % kCS == rank) kb[r] = v;
      if (v) last = r;
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  if (lane == 0) sm.red[warp] = last;
  __syncthreads();
  if (tid == 0) {
    int m = -1;
    for (int w = 0; w < kNT / 32; ++w) m = max(m, sm.red[w]);
    sm.last = m;
    sm.count = 0;
    sm.list_len = 0;
  }
  cl.sync();  // also orders the init's keep stores before the sweep's
  const int valid_tiles = (sm.last + tile) / tile;  // 0 when none is valid

  const int lr = tid / kParts, part = tid % kParts;  // row of this block
  const int tr = rank * kRC + lr;                    // row of the tile
  for (int ti = 0; ti < valid_tiles; ++ti) {
    if (stop_at >= 0 && sm.count >= stop_at) break;  // cluster-uniform
    const int row0 = ti * tile;
    for (int r = tid; r < tile; r += kNT) {
      const float4 c = bx[row0 + r];
      sm.tile[r] = c;
      sm.tile_area[r] = make_box(c).area;
    }
    if (part == 0) sm.dead[lr] = 0;
    __syncthreads();

    // 1. suppression by the kept rows of every earlier tile
    bool alive = tr < tile && vb[row0 + tr] != 0;
    if (alive) {
      const Box mine = {sm.tile[tr].x, sm.tile[tr].y, sm.tile[tr].z,
                        sm.tile[tr].w, sm.tile_area[tr]};
      const int n = sm.list_len;
      const volatile uint8_t* dead = sm.dead;
      for (int i = part; i < n; i += kParts) {
        if (dead[lr]) break;
        // spilled rows come from L2: other blocks of the cluster wrote them
        const Box k = i < kListCap
                          ? Box{sm.list[i].x, sm.list[i].y, sm.list[i].z,
                                sm.list[i].w, sm.list_area[i]}
                          : make_box(__ldcg(sp + (i - kListCap)));
        if (iou_above(k, mine, thr)) {
          sm.dead[lr] = 1;
          break;
        }
      }
    }
    __syncthreads();
    alive = alive && !sm.dead[lr];
    if (part == 0) cluster_store(cl, &sm.alive[tr], (uint8_t)alive);
    cl.sync();
    uint32_t aw[kWords];  // the tile's live rows, as bits
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      aw[w] = __ballot_sync(0xffffffffu, sm.alive[w * 32 + lane] != 0);

    // 2. forward masks of this block's live rows: two words per part
    if (alive) {
      const Box mine = {sm.tile[tr].x, sm.tile[tr].y, sm.tile[tr].z,
                        sm.tile[tr].w, sm.tile_area[tr]};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int w = 2 * part + k;
        uint32_t cand = 0;
#pragma unroll
        for (int x = 0; x < kWords; ++x)
          if (x == w) cand = aw[x];
        if (w < (tr >> 5)) cand = 0;
        if (w == (tr >> 5)) cand &= ~((2u << (tr & 31)) - 1u);  // j > tr
        uint32_t bits = 0;
        while (cand) {
          const int bit = __ffs(cand) - 1;
          cand &= cand - 1u;
          const int j = w * 32 + bit;
          const Box other = {sm.tile[j].x, sm.tile[j].y, sm.tile[j].z,
                             sm.tile[j].w, sm.tile_area[j]};
          if (iou_above(mine, other, thr)) bits |= 1u << bit;
        }
        cluster_store(cl, &sm.mask[tr][w], bits);
      }
    }
    cl.sync();

    // 3. greedy order inside the tile: visit live, unremoved rows only
    if (tid == 0) {
      uint32_t kept[kWords], remv[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) kept[w] = remv[w] = 0u;
      int n = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        uint32_t cand = aw[w] & ~remv[w];
        while (cand) {
          const int bit = __ffs(cand) - 1;
          kept[w] |= 1u << bit;
          ++n;
          const uint32_t* mi = sm.mask[w * 32 + bit];
#pragma unroll
          for (int x = w; x < kWords; ++x) remv[x] |= mi[x];
          cand = aw[w] & ~remv[w] & ~((2u << bit) - 1u);
        }
      }
#pragma unroll
      for (int w = 0; w < kWords; ++w) sm.kept[w] = kept[w];
      sm.list_base = sm.list_len;
      sm.list_len += n;
      sm.count += n;
    }
    __syncthreads();

    // 4. append the tile's kept boxes to the list (a spilled row by one
    // block of the cluster only); write this block's rows of keep
    for (int r = tid; r < tile; r += kNT) {
      const uint32_t kw = sm.kept[r >> 5];
      if ((kw >> (r & 31)) & 1u) {
        int pos = sm.list_base + __popc(kw & ((1u << (r & 31)) - 1u));
        for (int w = 0; w < (r >> 5); ++w) pos += __popc(sm.kept[w]);
        if (pos < kListCap) {
          sm.list[pos] = sm.tile[r];
          sm.list_area[pos] = sm.tile_area[r];
        } else if (pos % kCS == rank) {
          sp[pos - kListCap] = sm.tile[r];
        }
      }
    }
    if (part == 0 && tr < tile)
      kb[row0 + tr] = (sm.kept[tr >> 5] >> (tr & 31)) & 1u;
    // the list and count are read by the next tile; spilled rows by every
    // block of the cluster (list_len is the same in all of them)
    if (sm.list_len > kListCap)
      cl.sync();
    else
      __syncthreads();
  }
}

}  // namespace

extern "C" int et_nms_list_cap() { return kListCap; }

// spill: (B, spill_rows) float4, or null when the kept list cannot outgrow
// shared memory.
extern "C" int et_nms_keep(const void* boxes, const void* valid, void* keep,
                           int B, int K, int tile, float iou_thres,
                           int stop_at, void* spill, int spill_rows,
                           void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaGetLastError();
  const Thr thr = {iou_thres, iou_thres >= 0x1p-100f && iou_thres <= 1.f};
  nms_keep_kernel<<<B * kCS, kNT, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const uint8_t*)valid, (uint8_t*)keep, K, tile,
      thr, stop_at, (float4*)spill, spill_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* et_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
