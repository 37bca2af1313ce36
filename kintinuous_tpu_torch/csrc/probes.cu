// The four cost-model probes of tools/proto_integrate_pallas.py on Hopper
// (sm_90a): row updates of a (N,4,128) f32 volume at K unique row ids, with
// and without image reads.
//
//   P1 kt_probe_rows  replaces run_rows (:61): out[ids[i]] += 1, i < k.
//   P2 kt_probe_dma   replaces run_dma (:118):
//                     out[ids[i]] += img[0, cy+s, cx+l] (bf16 -> f32).
//   P3 kt_probe_full  replaces run_full (:180): with t = out[ids[i], s, l],
//                     u = (int)clip(|t|*100, 0, 255), v = (int)clip(|t|*70,
//                     0, 111), rays = img[0,cy+v,cx+u] + img[1,cy+v,cx+u],
//                     rgb = sum_c img2[c, cy/2 + v/2, u/2],
//                     out = t*0.5 + (rays + rgb)*0.5.
//   P4 kt_probe_rows with a count in device memory replaces run_dyn (:200),
//                     P1 over the first min(max(n, 0), k) ids, n read on the
//                     device.
//
// The TPU probes DMA a 112x256 (2 channels) and a 56x384 (3 channels) bf16
// patch into VMEM per row and gather from it with one-hot MXU products; here
// each thread reads its few image values straight from device memory (the
// patches would need 238 KB of shared memory a block, above Hopper's 227 KB).
// Both images (1.8 MB) stay in L2. Rows are updated in place: a row's 2 KB are
// read and written once.
//
// Bound on the H100: bytes (each row in and out once, 33.6 MB at the tool's
// K = 8192), 10 us at 3.35 TB/s, about twice the 5.7 us floor of a launch.
// The first design, one 512-thread block a row, kept 528 rows in flight and
// paid an id load and then a row load for each of 15.5 waves of blocks.
//
// P1/P4 (rows_kernel): a persistent grid (kt::persistent_blocks) of warps,
// each walking a contiguous share of the rows, a row at a time. Lane l holds
// the row's float4s l, l+32, l+64 and l+96 (a warp 512 contiguous bytes a
// load). A warp loads the ids of its next 32 rows in one coalesced load and
// hands them out with __shfl_sync, and issues the next row's loads before it
// stores the current one. P4 reads the count once a warp (lane 0, then a
// shuffle) and splits min(max(n, 0), k) rows over the warps; the host sizes
// the grid from k and never reads n (the first design launched k blocks, and
// those past n read n and returned).
//
// P3 (full_kernel): a persistent grid of 256-thread blocks, 2 an SM, each
// walking a contiguous share of the rows a row at a time, two floats a
// thread; a thread issues its 10 gathers together, and the next row's id,
// corner and floats are loaded before this row's gathers. The gathers set
// the time, not the row stream. Tried and timed on an H100 80GB HBM3 at
// 700 W (the probe tool's inputs, cold L2; the first design 0.0430 ms):
// - the warp-a-row walk of P1 with its 80 gathers a lane in two batches
//   of 40 (128 registers, no spills): 0.0559-0.0622 ms with 2 blocks of 8
//   warps an SM, 0.0433 with 1;
// - this design: 0.0375-0.0378 ms with 2 blocks an SM, 0.0392 with 4,
//   0.0468 with 1; with 512 threads a row (a float each) 0.0386 at 2
//   blocks an SM, 0.0477 at 1; with 128 (a float4 each) 0.0436 at 4;
// - rows grouped by corner (each block scans the corners and takes the
//   rows of its own, so an SM's gathers share L1 lines): 0.080-0.151 ms;
// - a row's floats counting-sorted by v in shared memory (a warp's
//   gathers then hit a few image rows, not ~25): 0.0365.
// Two rows in flight an SM is best; fewer distinct lines a warp's gather
// barely matters, so the sort is not worth its code.
//
// P2 (dma_kernel): P1's walk, a warp a row, with the row's corner. Lane l's
// float4 l + 32m covers the row's floats m*128 + 4l .. +3, whose corner
// values are img[0, cy+m, cx+4l .. cx+4l+3]: one 8-byte load, 256
// contiguous bytes a warp for each m. The corners (cy, cx) come 32 rows at
// a time with the ids; the next row's floats and corner are loaded before
// this row is stored. A corner off an 8-byte boundary (cx % 4 != 0) takes
// 2-byte loads in a warp-uniform branch. The first design, one
// 512-thread block a row, a float and a bf16 a thread, paid the chain id ->
// row address -> load in each of 15.5 waves of blocks. Tried and timed on
// an H100 80GB HBM3 at 700 W (the probe tool's inputs, cold L2; the first
// design 0.0284 ms):
// - the next row's floats and corner loaded before the current row is
//   summed: 24 registers live across the loads, 72 bytes spilled at the
//   64-register budget of 4 blocks an SM (not timed);
// - this design, the sum first: 64 registers, no spills, 0.0185-0.0187 ms
//   (P1's walk without corners 0.0175-0.0179 in the same call); with 3
//   blocks an SM (72 registers) 0.0190; an unaligned cx (2-byte loads)
//   0.0181.
//
// Every kernel runs on the caller's stream and allocates nothing. -fmad=false keeps t*0.5 + x*0.5 two roundings,
// as PyTorch's plain version computes it; bf16 -> f32 is exact (a 16-bit
// shift); rows are unique, so the order they are visited in changes no bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"

namespace {

constexpr int ROW = 512;  // floats of a (4,128) row
constexpr int kRowVec = ROW / 4;        // float4s of a row
constexpr int kLaneVec = kRowVec / 32;  // float4s a lane holds of a row
constexpr int kWarps = 8;               // warps a block of rows_kernel
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;

// the warp's share [s, e) of n rows, n split evenly over the grid's warps
__device__ __forceinline__ void warp_share(int n, int& s, int& e) {
  const long long warps = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  s = (int)(w * n / warps);
  e = (int)((w + 1) * n / warps);
}

struct Row {
  float4 v[kLaneVec];
};

__device__ __forceinline__ Row load_row(const float4* p, int lane) {
  Row r;
#pragma unroll
  for (int q = 0; q < kLaneVec; ++q) r.v[q] = p[lane + 32 * q];
  return r;
}

__device__ __forceinline__ void plus_one_store(float4* p, Row r, int lane) {
#pragma unroll
  for (int q = 0; q < kLaneVec; ++q) {
    r.v[q].x += 1.0f;
    r.v[q].y += 1.0f;
    r.v[q].z += 1.0f;
    r.v[q].w += 1.0f;
    p[lane + 32 * q] = r.v[q];
  }
}

// n_dev == nullptr: the count is k. A warp walks rows [s, e): the ids 32
// at a time (lane l holds row base + l's), the next row's floats loaded
// before the current row is stored. Warp-uniform.
__global__ void __launch_bounds__(kThreads, 4)
    rows_kernel(float4* __restrict__ tsdf, const int* __restrict__ ids,
                const int* __restrict__ n_dev, int k) {
  const int lane = threadIdx.x & 31;
  int n = k;
  if (n_dev != nullptr) {
    int v = 0;
    if (lane == 0) v = __ldg(n_dev);
    n = min(max(__shfl_sync(kAll, v, 0), 0), k);
  }
  int s, e;
  warp_share(n, s, e);
  if (s >= e) return;
  int batch = s + lane < e ? __ldg(ids + s + lane) : 0;
  int id = __shfl_sync(kAll, batch, 0);
  Row cur = load_row(tsdf + (size_t)id * kRowVec, lane);
  for (int i = s; i < e; ++i) {
    const int i1 = i + 1;
    int nid = 0;
    Row nxt;
    if (i1 < e) {
      if (((i1 - s) & 31) == 0) batch = i1 + lane < e ? __ldg(ids + i1 + lane) : 0;
      nid = __shfl_sync(kAll, batch, (i1 - s) & 31);
      nxt = load_row(tsdf + (size_t)nid * kRowVec, lane);
    }
    plus_one_store(tsdf + (size_t)id * kRowVec, cur, lane);
    cur = nxt;
    id = nid;
  }
}

__device__ __forceinline__ float bf16_bits(unsigned short h) {
  return __uint_as_float((unsigned)h << 16);
}

// A lane's share of a row's (4,128) corner img[cy+m, cx+4l .. cx+4l+3],
// m < 4, as four bf16 pairs: the values of its float4s l + 32m.
struct Corner {
  uint2 c[kLaneVec];
};

// base: the corner's first value, img + cy*W + cx. One 8-byte load a plane
// when base lies on an 8-byte boundary and so does every plane's (W % 4 ==
// 0); else 2-byte loads. The branch is warp-uniform: base is the row's.
__device__ __forceinline__ Corner load_corner(const unsigned short* base, int W,
                                              int lane) {
  const unsigned short* p = base + 4 * lane;
  Corner r;
  if ((W & 3) == 0 && (reinterpret_cast<uintptr_t>(base) & 7) == 0) {
#pragma unroll
    for (int m = 0; m < kLaneVec; ++m)
      r.c[m] = __ldg(reinterpret_cast<const uint2*>(p + (size_t)m * W));
  } else {
#pragma unroll
    for (int m = 0; m < kLaneVec; ++m) {
      const unsigned short* q = p + (size_t)m * W;
      r.c[m] = make_uint2((unsigned)__ldg(q) | ((unsigned)__ldg(q + 1) << 16),
                          (unsigned)__ldg(q + 2) | ((unsigned)__ldg(q + 3) << 16));
    }
  }
  return r;
}

// the row plus its corner: one exact bf16 -> f32 add a float
__device__ __forceinline__ void plus_corner(Row& r, const Corner& c) {
#pragma unroll
  for (int q = 0; q < kLaneVec; ++q) {
    r.v[q].x += bf16_bits((unsigned short)(c.c[q].x & 0xffffu));
    r.v[q].y += bf16_bits((unsigned short)(c.c[q].x >> 16));
    r.v[q].z += bf16_bits((unsigned short)(c.c[q].y & 0xffffu));
    r.v[q].w += bf16_bits((unsigned short)(c.c[q].y >> 16));
  }
}

__device__ __forceinline__ void store_row(float4* p, const Row& r, int lane) {
#pragma unroll
  for (int q = 0; q < kLaneVec; ++q) p[lane + 32 * q] = r.v[q];
}

// rows_kernel's walk with a corner a row: the ids and corner offsets
// (cy*W + cx) 32 rows at a time (lane l holds row base + l's). The current
// row is summed with its corner, then the next row's floats and corner are
// loaded before the sum is stored (the sum first: 16 registers live across
// the next row's loads, not 24). Warp-uniform.
__global__ void __launch_bounds__(kThreads, 4)
    dma_kernel(float4* __restrict__ tsdf, const int* __restrict__ ids,
               const int* __restrict__ cy, const int* __restrict__ cx,
               const unsigned short* __restrict__ img, int W, int k) {
  const int lane = threadIdx.x & 31;
  int s, e;
  warp_share(k, s, e);
  if (s >= e) return;
  int b_id = 0, b_off = 0;
  if (s + lane < e) {
    b_id = __ldg(ids + s + lane);
    b_off = __ldg(cy + s + lane) * W + __ldg(cx + s + lane);
  }
  int id = __shfl_sync(kAll, b_id, 0);
  Row cur = load_row(tsdf + (size_t)id * kRowVec, lane);
  Corner corner = load_corner(img + __shfl_sync(kAll, b_off, 0), W, lane);
  for (int i = s; i < e; ++i) {
    plus_corner(cur, corner);
    const int i1 = i + 1;
    int nid = 0;
    Row nxt;
    if (i1 < e) {
      const int j = (i1 - s) & 31;
      if (j == 0 && i1 + lane < e) {
        b_id = __ldg(ids + i1 + lane);
        b_off = __ldg(cy + i1 + lane) * W + __ldg(cx + i1 + lane);
      }
      nid = __shfl_sync(kAll, b_id, j);
      nxt = load_row(tsdf + (size_t)nid * kRowVec, lane);
      corner = load_corner(img + __shfl_sync(kAll, b_off, j), W, lane);
    }
    store_row(tsdf + (size_t)id * kRowVec, cur, lane);
    cur = nxt;
    id = nid;
  }
}

constexpr int kFullThreads = ROW / 2;  // a row a block, two floats a thread
constexpr int kFullBlocksPerSm = 2;

struct Full {
  const unsigned short* img;   // (2,H,W) bf16 bits
  const unsigned short* img2;  // (3,H2,W2) bf16 bits
  int HW, W, H2W2, W2, pw1, ph1;

  // a thread's two floats: their 10 taps issued together, then the sums
  __device__ __forceinline__ float2 operator()(float2 r, int cy,
                                               int cx) const {
    float t[2] = {r.x, r.y};
    unsigned short g[2][5];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float m = fabsf(t[j]);
      const int u = (int)fminf(fmaxf(m * 100.0f, 0.0f), (float)pw1);
      const int v = (int)fminf(fmaxf(m * 70.0f, 0.0f), (float)ph1);
      const int px = (cy + v) * W + cx + u;
      const int px2 = (cy / 2 + v / 2) * W2 + u / 2;
      g[j][0] = __ldg(img + px);
      g[j][1] = __ldg(img + HW + px);
      g[j][2] = __ldg(img2 + px2);
      g[j][3] = __ldg(img2 + H2W2 + px2);
      g[j][4] = __ldg(img2 + 2 * H2W2 + px2);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float rays = bf16_bits(g[j][0]) + bf16_bits(g[j][1]);
      const float rgb =
          (bf16_bits(g[j][2]) + bf16_bits(g[j][3])) + bf16_bits(g[j][4]);
      t[j] = t[j] * 0.5f + (rays + rgb) * 0.5f;
    }
    return make_float2(t[0], t[1]);
  }
};

// a block walks a contiguous share of the rows, a row at a time, loading
// the next row (its id, corner and floats) before this row's gathers
__global__ void __launch_bounds__(kFullThreads)
    full_kernel(float2* __restrict__ tsdf, const int* __restrict__ ids,
                const int* __restrict__ cy, const int* __restrict__ cx,
                const Full f, int k) {
  const int s = (int)((long long)blockIdx.x * k / gridDim.x);
  const int e = (int)((long long)(blockIdx.x + 1) * k / gridDim.x);
  if (s >= e) return;
  const int tid = threadIdx.x;
  int id = __ldg(ids + s), ccy = __ldg(cy + s), ccx = __ldg(cx + s);
  float2 cur = tsdf[(size_t)id * kFullThreads + tid];
  for (int i = s; i < e; ++i) {
    int nid = 0, ncy = 0, ncx = 0;
    float2 nxt = cur;
    if (i + 1 < e) {
      nid = __ldg(ids + i + 1);
      ncy = __ldg(cy + i + 1);
      ncx = __ldg(cx + i + 1);
      nxt = tsdf[(size_t)nid * kFullThreads + tid];
    }
    tsdf[(size_t)id * kFullThreads + tid] = f(cur, ccy, ccx);
    cur = nxt;
    id = nid;
    ccy = ncy;
    ccx = ncx;
  }
}

// blocks for k rows: at most the resident grid (capped at max_per_sm
// blocks an SM), and no more than the rows take
template <typename Kernel>
int row_blocks(Kernel kernel, int threads, int rows_a_block, int k, int* cache,
               int max_per_sm = 0) {
  const int resident = kt::persistent_blocks(kernel, threads, cache, max_per_sm);
  const int need = (k + rows_a_block - 1) / rows_a_block;
  return need < resident ? need : resident;
}

}  // namespace

extern "C" int kt_probe_rows(void* tsdf, const void* ids, const void* n_dev, int k,
                             void* stream) {
  static int grid_cache[kt::kMaxDevices];
  if (k > 0) {
    rows_kernel<<<row_blocks(rows_kernel, kThreads, kWarps, k, grid_cache),
                  kThreads, 0,
                  (cudaStream_t)stream>>>((float4*)tsdf, (const int*)ids,
                                          (const int*)n_dev, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int kt_probe_dma(void* tsdf, const void* ids, const void* cy,
                            const void* cx, const void* img, int k, int W,
                            void* stream) {
  static int grid_cache[kt::kMaxDevices];
  if (k > 0) {
    dma_kernel<<<row_blocks(dma_kernel, kThreads, kWarps, k, grid_cache),
                 kThreads, 0, (cudaStream_t)stream>>>(
        (float4*)tsdf, (const int*)ids, (const int*)cy, (const int*)cx,
        (const unsigned short*)img, W, k);
  }
  return (int)cudaGetLastError();
}

extern "C" int kt_probe_full(void* tsdf, const void* ids, const void* cy,
                             const void* cx, const void* img, const void* img2,
                             int k, int H, int W, int H2, int W2, int pw, int ph,
                             void* stream) {
  static int grid_cache[kt::kMaxDevices];
  if (k > 0) {
    const Full f{(const unsigned short*)img, (const unsigned short*)img2,
                 H * W, W, H2 * W2, W2, pw - 1, ph - 1};
    full_kernel<<<row_blocks(full_kernel, kFullThreads, 1, k, grid_cache,
                             kFullBlocksPerSm),
                  kFullThreads, 0, (cudaStream_t)stream>>>(
        (float2*)tsdf, (const int*)ids, (const int*)cy, (const int*)cx, f, k);
  }
  return (int)cudaGetLastError();
}
