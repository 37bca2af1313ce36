// Band fusion and free-space carve on the blocked TSDF volume (Hopper, sm_90a).
//
// band fusion (K1) replaces kintinuous_tpu/ops/pallas_integrate.py:
// _integrate_kernel (three patch tiers, bf16 hi/lo ray split, one-hot MXU
// sampling). Those exist because a TPU has no cheap gather; here each voxel
// reads its 8-byte [ray | aux] pixel entry straight from global memory, so
// the result is exactly the per-voxel formula of integrate_fast
// (kintinuous_tpu/ops/tsdf_fast.py).
//
// free carve (K2) replaces pallas_integrate.py:_carve_kernel: per voxel of a
// FREE block, t <- (t*w + 1)/(w + 1), w <- min(w + 1, max_w), rgb bytes kept.
//
// Bound on the H100: by bytes, memory. Each band voxel moves 8 bytes in and
// 8 out plus one 8-byte pixel read (mostly from L2: the 640x480 table is
// 2.4 MB); each carved voxel 16 bytes. By issue, the band update comes
// close: its formula keeps five IEEE divisions and a square root a voxel,
// each a Newton sequence with a slow-path call in SASS, so at a 512^3
// frame's 2.47 M band voxels the instructions take longer to issue than the
// bytes take to move (PERF.md, K1).
//
// K1's design:
// - a persistent grid (grid.cuh): each block reads the count once and walks
//   the band list in a grid-stride loop, one band block a pass, so the grid
//   follows the card and not the list's cap (one block per slot of the
//   8192-slot cap left 41 % of the blocks idle on a frame);
// - per band block, once: lanes 0..23 of warp 0 each form one of the 24
//   world coordinates (pmod, +0.5, *vsz) and its three rotation products
//   params[k] * w, into shared memory; a voxel then only adds
//   ((p0 wx + p1 wy) + p2 wz) + p9, the order of the per-voxel formula, and
//   each product is the same single rounding as per voxel, so the bits do
//   not change. The next band block's products are formed while this one
//   is fused (two buffers, one barrier a pass);
// - 4 consecutive x voxels a thread (128 threads a band block): one float4
//   tsdf and one uint4 cw load and store; the next band block's loads are
//   issued before this one's projection, and the thread's four pixel
//   gathers before any of them is used;
// - fewer instructions a voxel, same bits: q / 127.5f comes from a 256-entry
//   table that each block divides once; a voxel that is not valid, or does
//   not fuse, leaves the rest of the formula out (its t and cw stay, as the
//   formula's selects keep them); the colour mix runs only where it is
//   taken; the black test reads the three colour bytes as one word;
// - every other IEEE division and sqrtf stays as in the per-voxel formula:
//   a reciprocal multiply would move pixel ties and weights. -fmad=false
//   keeps x / zs * fx + cx three roundings, as PyTorch computes it.
//
// K2's design: the same persistent grid, walking n_free x 128 units; a unit
// is 4 consecutive voxels of one FREE block, one float4 of tsdf and one uint4
// of cw in and out, and the lanes of a warp take 32 consecutive units, so a
// warp moves 512 contiguous bytes of each array and all its lanes read the
// same block id (one broadcast load). A count of 0 runs no iteration: each
// block reads the count and leaves, which makes K2 at count 0 the floor of a
// launch on this card. The division stays IEEE, so the result is bit-exact
// against its plain version. The kernel it replaces launched one block a
// slot of the 12,288-slot cap, one voxel a thread: 88 % of its blocks read
// a frame's count and left. kernel_stats: 38 registers, no spills; the loop
// body is 118 SASS instructions for 4 voxels (the kernel it replaces: 20
// registers, 49 instructions a voxel). Block sizes of 128 to 1024 threads
// time the same.
//
// K1's registers and SASS (python -m kintinuous_tpu_torch.tools.kernel_stats,
// sm_90a, -O3 -fmad=false): 65 registers, no spills; the grid-stride loop's
// body is 961 instructions for 4 voxels, 240 a voxel (the one-voxel-a-thread
// kernel it replaces: 32 registers, 389 a voxel). No tensor core or TMA
// applies: the work is per-voxel scalar arithmetic and one gather a voxel,
// and each 16-byte word is used once, from registers.
//
// Lists are padded to their cap and the counts live in device memory, so the
// host never reads a count. The kernels run on the caller's stream, allocate
// nothing and update the volume in place.

#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kCells = 512;
constexpr int kVox = 4;                      // x voxels a thread (K1)
constexpr int kFuseThreads = kCells / kVox;  // one band block a pass

__device__ __forceinline__ int pmod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// jnp.clip(v, 0, 255).astype(uint32): clip, then truncate toward zero
__device__ __forceinline__ unsigned to_u8(float v) {
  return (unsigned)fminf(fmaxf(v, 0.0f), 255.0f);
}

struct Fuse {
  int W, H;
  float fx, fy, cx, cy, trunc, max_w;
};

// One voxel's update of t and c from its camera-frame position and pixel
// entry: the per-voxel formula of integrate_fast after the projection, with
// w_c_of[q] = q / 127.5f, the colour weight of a quantised weight q.
__device__ __forceinline__ void fuse_voxel(float x, float y, float z,
                                           bool in_img, float2 px_entry,
                                           const float* w_c_of, const Fuse& f,
                                           float& t, unsigned& c) {
  const float samp_ray = px_entry.x;
  if (!(in_img && (samp_ray > 0.0f))) return;  // not valid: nothing changes
  const float vox_ray = sqrtf(x * x + y * y + z * z);
  const float sdf = samp_ray - vox_ray;
  if (!(sdf >= -f.trunc)) return;  // no fuse: t and c stay
  const unsigned aux = __float_as_uint(px_entry.y);
  const unsigned samp_q = aux >> 24;
  const float tsdf_new = fminf(1.0f, sdf / f.trunc);
  const float w_old = (float)(c >> 24);
  t = (t * w_old + tsdf_new) / fmaxf(w_old + 1.0f, 1.0f);
  unsigned rgb = c & 0x00FFFFFFu;  // to_u8 of an old byte is the byte
  if (samp_q != 0u || rgb == 0u) {
    const float w_c = w_c_of[samp_q];
    const float r_new = (float)((aux >> 16) & 0xFFu);
    const float g_new = (float)((aux >> 8) & 0xFFu);
    const float b_new = (float)(aux & 0xFFu);
    const float r_old = (float)((c >> 16) & 0xFFu);
    const float g_old = (float)((c >> 8) & 0xFFu);
    const float b_old = (float)(c & 0xFFu);
    const float inv_w = 1.0f / fmaxf(w_old + w_c, 1e-6f);
    rgb = (to_u8((r_old * w_old + w_c * r_new) * inv_w) << 16) |
          (to_u8((g_old * w_old + w_c * g_new) * inv_w) << 8) |
          to_u8((b_old * w_old + w_c * b_new) * inv_w);
  }
  c = (to_u8(fminf(w_old + 1.0f, f.max_w)) << 24) | rgb;
}

// params: [Tinv rotation row-major (9) | Tinv translation (3) | wrap xyz (3) |
//          z_block_offset]: the volume may be a z-slab of Bz*B*B rows whose
// first block-plane is plane z_block_offset of the R^3 volume
__global__ void __launch_bounds__(kFuseThreads)
    band_fusion_kernel(const float2* __restrict__ img,
                       const int* __restrict__ ids,
                       const int* __restrict__ n_ids,
                       const float* __restrict__ params,
                       float* __restrict__ tsdf, unsigned* __restrict__ cw,
                       int cap, int B, int R, float vsz, Fuse f) {
  // [buffer][k][c] = params[k] * (world coordinate c of axis k % 3) of a
  // band block
  __shared__ __align__(16) float prod[2][9][8];
  __shared__ float w_c_of[256];
  const int n = min(*n_ids, cap);
  const int t = threadIdx.x;
  // the same division per voxel would give the same bits, 256 times over
  for (int q = t; q < 256; q += kFuseThreads) w_c_of[q] = (float)q / 127.5f;
  // the thread's voxels: cells 4t .. 4t+3, i.e. (dz, dy, dx0 .. dx0+3)
  const int dx0 = (t & 1) * kVox, dy = (t >> 1) & 7, dz = t >> 4;
  const float tx = __ldg(params + 9), ty = __ldg(params + 10),
              tz = __ldg(params + 11);
  const int zoff = (int)__ldg(params + 15);

  // lanes 0..23 of warp 0: world coordinate c = t % 8 of axis a = t / 8
  // of block bid, and its three products (k = a, a + 3, a + 6)
  auto produce = [&](int bid, int buf) {
    if (t < 24) {
      const int a = t >> 3, c = t & 7;
      const int b =
          a == 0 ? bid % B : a == 1 ? (bid / B) % B : bid / (B * B) + zoff;
      const int wrap = (int)__ldg(params + 12 + a);
      const float w = ((float)pmod(b * 8 + c - wrap, R) + 0.5f) * vsz;
      prod[buf][a][c] = __ldg(params + a) * w;
      prod[buf][a + 3][c] = __ldg(params + a + 3) * w;
      prod[buf][a + 6][c] = __ldg(params + a + 6) * w;
    }
  };

  int item = blockIdx.x;
  if (item >= n) return;  // uniform over the block
  int bid = ids[item];
  size_t i0 = (size_t)bid * kCells + t * kVox;
  float4 t_old = *reinterpret_cast<const float4*>(tsdf + i0);
  uint4 c_old = *reinterpret_cast<const uint4*>(cw + i0);
  produce(bid, 0);
  for (int buf = 0; item < n; item += gridDim.x, buf ^= 1) {
    // the next band block's id and volume words, in flight during this one
    const int next = item + gridDim.x;
    int bid_n = 0;
    size_t i0_n = 0;
    float4 t_next = make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 c_next = make_uint4(0u, 0u, 0u, 0u);
    if (next < n) {
      bid_n = ids[next];
      i0_n = (size_t)bid_n * kCells + t * kVox;
      t_next = *reinterpret_cast<const float4*>(tsdf + i0_n);
      c_next = *reinterpret_cast<const uint4*>(cw + i0_n);
    }
    __syncthreads();  // prod[buf] is written; nobody reads prod[buf ^ 1]

    // camera x = ((p0 wx + p1 wy) + p2 wz) + p9, and y, z alike: the
    // terms in wx differ per voxel, those in wy and wz are the thread's
    const float4 xa = *reinterpret_cast<const float4*>(&prod[buf][0][dx0]);
    const float4 ya = *reinterpret_cast<const float4*>(&prod[buf][3][dx0]);
    const float4 za = *reinterpret_cast<const float4*>(&prod[buf][6][dx0]);
    const float xb = prod[buf][1][dy], xc = prod[buf][2][dz];
    const float yb = prod[buf][4][dy], yc = prod[buf][5][dz];
    const float zb = prod[buf][7][dy], zc = prod[buf][8][dz];
    const float x_wx[kVox] = {xa.x, xa.y, xa.z, xa.w};
    const float y_wx[kVox] = {ya.x, ya.y, ya.z, ya.w};
    const float z_wx[kVox] = {za.x, za.y, za.z, za.w};
    float x[kVox], y[kVox], z[kVox];
    bool in_img[kVox];
    int pidx[kVox];
#pragma unroll
    for (int v = 0; v < kVox; ++v) {
      x[v] = ((x_wx[v] + xb) + xc) + tx;
      y[v] = ((y_wx[v] + yb) + yc) + ty;
      z[v] = ((z_wx[v] + zb) + zc) + tz;
      const float zs = fmaxf(z[v], 1e-6f);
      // rint semantics (round half to even), as jnp.round; saturating cast
      const int ui = __float2int_rn(x[v] / zs * f.fx + f.cx);
      const int vi = __float2int_rn(y[v] / zs * f.fy + f.cy);
      // 0 <= ui < W and 0 <= vi < H, as one unsigned compare each
      in_img[v] = (z[v] > 0.0f) && (unsigned)ui < (unsigned)f.W &&
                  (unsigned)vi < (unsigned)f.H;
      pidx[v] = min(max(vi, 0), f.H - 1) * f.W + min(max(ui, 0), f.W - 1);
    }
    float2 e[kVox];
#pragma unroll
    for (int v = 0; v < kVox; ++v) e[v] = __ldg(img + pidx[v]);

    float tv[kVox] = {t_old.x, t_old.y, t_old.z, t_old.w};
    unsigned cv[kVox] = {c_old.x, c_old.y, c_old.z, c_old.w};
#pragma unroll
    for (int v = 0; v < kVox; ++v)
      fuse_voxel(x[v], y[v], z[v], in_img[v], e[v], w_c_of, f, tv[v], cv[v]);
    *reinterpret_cast<float4*>(tsdf + i0) =
        make_float4(tv[0], tv[1], tv[2], tv[3]);
    *reinterpret_cast<uint4*>(cw + i0) =
        make_uint4(cv[0], cv[1], cv[2], cv[3]);

    if (next < n) produce(bid_n, buf ^ 1);
    i0 = i0_n;
    t_old = t_next;
    c_old = c_next;
  }
}

// t <- (t*w + 1)/(w + 1), w <- min(w + 1, max_w), rgb kept: one voxel
__device__ __forceinline__ void carve_voxel(float& t, unsigned& c,
                                            float max_w) {
  const float w_old = (float)(c >> 24);
  const float w_new = fminf(w_old + 1.0f, max_w);
  t = (t * w_old + 1.0f) / fmaxf(w_old + 1.0f, 1.0f);
  c = ((unsigned)w_new << 24) | (c & 0x00FFFFFFu);
}

constexpr int kCarveThreads = 256;
constexpr int kCarveUnits = kCells / kVox;  // 4-voxel units a block

__global__ void __launch_bounds__(kCarveThreads)
    free_carve_kernel(const int* __restrict__ ids,
                      const int* __restrict__ n_ids, float* __restrict__ tsdf,
                      unsigned* __restrict__ cw, int cap, float max_w) {
  const int units = min(*n_ids, cap) * kCarveUnits;
  for (int u = blockIdx.x * kCarveThreads + threadIdx.x; u < units;
       u += gridDim.x * kCarveThreads) {
    const size_t i = (size_t)__ldg(ids + u / kCarveUnits) * kCells +
                     (u % kCarveUnits) * kVox;
    float4 t = *reinterpret_cast<const float4*>(tsdf + i);
    uint4 c = *reinterpret_cast<const uint4*>(cw + i);
    carve_voxel(t.x, c.x, max_w);
    carve_voxel(t.y, c.y, max_w);
    carve_voxel(t.z, c.z, max_w);
    carve_voxel(t.w, c.w, max_w);
    *reinterpret_cast<float4*>(tsdf + i) = t;
    *reinterpret_cast<uint4*>(cw + i) = c;
  }
}

}  // namespace

extern "C" int kt_band_fusion(const void* img, const void* ids,
                              const void* n_ids, const void* params,
                              void* tsdf, void* cw, int cap, int B, int R,
                              int W, int H, float fx, float fy, float cx,
                              float cy, float vsz, float trunc, float max_w,
                              void* stream) {
  static int grid_cache[kt::kMaxDevices];
  if (cap > 0) {
    const int resident = kt::persistent_blocks(band_fusion_kernel,
                                               kFuseThreads, grid_cache);
    band_fusion_kernel<<<cap < resident ? cap : resident, kFuseThreads, 0,
                         (cudaStream_t)stream>>>(
        (const float2*)img, (const int*)ids, (const int*)n_ids,
        (const float*)params, (float*)tsdf, (unsigned*)cw, cap, B, R, vsz,
        Fuse{W, H, fx, fy, cx, cy, trunc, max_w});
  }
  return (int)cudaGetLastError();
}

extern "C" int kt_free_carve(const void* ids, const void* n_ids, void* tsdf,
                             void* cw, int cap, float max_w, void* stream) {
  static int grid_cache[kt::kMaxDevices];
  if (cap > 0) {
    const int resident = kt::persistent_blocks(free_carve_kernel,
                                               kCarveThreads, grid_cache);
    // enough blocks for every unit of the cap, at most the resident grid
    const int need = (cap * kCarveUnits + kCarveThreads - 1) / kCarveThreads;
    free_carve_kernel<<<need < resident ? need : resident, kCarveThreads, 0,
                        (cudaStream_t)stream>>>(
        (const int*)ids, (const int*)n_ids, (float*)tsdf, (unsigned*)cw, cap,
        max_w);
  }
  return (int)cudaGetLastError();
}
