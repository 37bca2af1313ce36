// The dense bf16 mirror (R,R,R) [z,y,x] of the blocked f32 tsdf (Hopper,
// sm_90a): the refresh of dirty (bz,by) row-pairs (K3) and the full rebuild
// (K5).
//
// K3, kt_mirror_refresh, replaces kintinuous_tpu/ops/pallas_raycast.py:
// _update_logical_kernel, which DMAs each pair's 2*B block rows into VMEM and
// de-blocks them with one-hot MXU matmuls. The pair list is padded to its cap
// and the count lives in device memory (count == 0 leaves the mirror
// untouched; shift frames pass every pair).
//
// Bound on the H100: memory, 4 bytes read and 2 written per voxel, nothing
// to compute but a bf16 rounding and a transpose (no tensor core applies). A
// frame's 188 pairs at 512^3 move 74 MB (0.022 ms at 3.35 TB/s), every pair
// 805 MB (0.240 ms).
//
// K3's design: a persistent grid (grid.cuh: SM count x resident blocks per
// SM), each thread reading the count once and walking count * 128 * B units
// in a grid-stride loop, so the grid follows the card and not the cap (one
// block per pair slot and slab line is pair_cap x 128 blocks, 262,144 at
// 512^3, of which a frame's 188 pairs use 9 %). A unit is one 8-voxel x-segment, the (dz, dy)
// row of one 8^3 block: 32 contiguous bytes of the blocked tsdf, loaded as
// two float4 and stored as one 16-byte uint4 of 8 bf16. Units are numbered
// so that a warp's 32 lanes take 32 consecutive bx of one mirror x-line: its
// stores are 512 contiguous bytes and each lane's read is one whole 32-byte
// sector. Plain vector loads, not TMA or cp.async.bulk: each unit is used
// once, straight from registers, so staging it in shared memory would add a
// copy and buy no reuse.
//
// K5, kt_deblock, replaces kintinuous_tpu/ops/pallas_raycast.py:
// _deblock_kernel (reached through build_logical_bf16), the same one-hot
// de-block over the whole volume. It has no pair list and no count: one CUDA
// block per mirror x-line (z, y), one thread per voxel, so any R that is a
// multiple of 8 works, odd block counts included (K3 needs an even B for its
// pairs).
//
// f32 -> bf16 is __float2bfloat16_rn, the round-to-nearest-even of torch and
// JAX. A zero is written as +0.0: the JAX kernels' f32 matmul accumulation
// starting from +0 turns a -0.0 (a cleared negative voxel) into +0.0. Both
// kernels run on the caller's stream, allocate nothing and write the mirror
// in place.
//
// Registers and SASS (python -m kintinuous_tpu_torch.tools.kernel_stats,
// sm_90a, -O3): K3 28 registers, no spills, a grid-stride loop of 85
// instructions for a pass of 8 voxels, 10.6 a voxel (the one-voxel-a-thread
// kernel it replaces: 15 registers, a 20-instruction loop a voxel). K5 15
// registers, a 20-instruction loop a voxel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

constexpr int kRefreshThreads = 256;

__device__ __forceinline__ __nv_bfloat16 to_mirror(float v) {
  return __float2bfloat16_rn(v == 0.0f ? 0.0f : v);
}

// two mirror voxels in one word, the lower x in the low half
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(to_mirror(lo)) |
         ((unsigned)__bfloat16_as_ushort(to_mirror(hi)) << 16);
}

// Unit g of the first n pairs: pair k = g / (128 B), then line = dz * 16 + yy
// of the pair's (8, 16, R) slab, then bx. Mirror and tsdf are addressed in
// 16-byte words (a block row of the tsdf is 128 of them, a mirror x-line
// R / 8).
__global__ void __launch_bounds__(kRefreshThreads, 8)
    mirror_refresh_kernel(const float4* __restrict__ tsdf,
                          const int* __restrict__ pairs,
                          const int* __restrict__ count,
                          uint4* __restrict__ mirror, int pair_cap, int B,
                          int R) {
  const unsigned per_pair = 128u * (unsigned)B;
  const unsigned total = (unsigned)min(*count, pair_cap) * per_pair;
  const unsigned line_words = (unsigned)R / 8u;
  for (unsigned g = blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += gridDim.x * blockDim.x) {
    const unsigned k = g / per_pair, u = g - k * per_pair;
    const unsigned line = u / (unsigned)B, bx = u - line * (unsigned)B;
    const unsigned dz = line >> 4, yy = line & 15u;
    const unsigned row0 = (unsigned)pairs[k] * 2u;  // rows row0, row0 + 1
    const unsigned bz = row0 / (unsigned)B, by = row0 - bz * (unsigned)B;
    const float4* src = tsdf + ((size_t)(row0 + (yy >> 3)) * B + bx) * 128 +
                        dz * 16 + (yy & 7u) * 2;
    const float4 a = src[0], b = src[1];
    uint4 out;
    out.x = pack2(a.x, a.y);
    out.y = pack2(a.z, a.w);
    out.z = pack2(b.x, b.y);
    out.w = pack2(b.z, b.w);
    mirror[((size_t)(bz * 8 + dz) * R + by * 8 + yy) * line_words + bx] = out;
  }
}

// grid (R*R): blockIdx.x = z * R + y, one mirror x-line each; x-line x reads
// row (z>>3, y>>3, x>>3) at cell (z&7)*64 + (y&7)*8 + (x&7)
__global__ void deblock_kernel(const float* __restrict__ tsdf,
                               __nv_bfloat16* __restrict__ mirror, int B,
                               int R) {
  const int z = blockIdx.x / R, y = blockIdx.x % R;
  const size_t row = ((size_t)(z >> 3) * B + (y >> 3)) * B;
  const float* src = tsdf + row * 512 + (z & 7) * 64 + (y & 7) * 8;
  __nv_bfloat16* dst = mirror + (size_t)blockIdx.x * R;
  for (int x = threadIdx.x; x < R; x += blockDim.x)
    dst[x] = to_mirror(src[(x >> 3) * 512 + (x & 7)]);
}

}  // namespace

extern "C" int kt_mirror_refresh(const void* tsdf, const void* pairs,
                                 const void* count, void* mirror, int pair_cap,
                                 int B, int R, void* stream) {
  static int grid_cache[kt::kMaxDevices];
  if (pair_cap > 0) {
    const long long units = (long long)pair_cap * 128 * B;
    const long long needed = (units + kRefreshThreads - 1) / kRefreshThreads;
    const int resident = kt::persistent_blocks(mirror_refresh_kernel,
                                               kRefreshThreads, grid_cache);
    const int grid = (int)(needed < resident ? needed : resident);
    mirror_refresh_kernel<<<grid, kRefreshThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)tsdf, (const int*)pairs, (const int*)count,
        (uint4*)mirror, pair_cap, B, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int kt_deblock(const void* tsdf, void* mirror, int B, int R,
                          void* stream) {
  const int threads = R < 256 ? R : 256;
  deblock_kernel<<<R * R, threads, 0, (cudaStream_t)stream>>>(
      (const float*)tsdf, (__nv_bfloat16*)mirror, B, R);
  return (int)cudaGetLastError();
}
