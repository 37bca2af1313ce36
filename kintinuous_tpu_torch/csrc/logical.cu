// The dense bf16 mirror (R,R,R) [z,y,x] of the blocked f32 tsdf (Hopper,
// sm_90a): the refresh of dirty (bz,by) row-pairs (K3) and the full rebuild
// (K5).
//
// K3, kt_mirror_refresh, replaces kintinuous_tpu/ops/pallas_raycast.py:
// _update_logical_kernel, which DMAs each pair's 2*B block rows into VMEM and
// de-blocks them with one-hot MXU matmuls. The pair list is padded to its cap
// and the count lives in device memory: blocks past the count return
// (count == 0 leaves the mirror untouched; shift frames pass every pair).
//
// K5, kt_deblock, replaces kintinuous_tpu/ops/pallas_raycast.py:
// _deblock_kernel (reached through build_logical_bf16), the same one-hot
// de-block over the whole volume. It has no pair list and no count: one CUDA
// block per mirror x-line (z, y), so any R that is a multiple of 8 works,
// odd block counts included (K3 needs an even B for its pairs).
//
// In both, one thread writes one mirror voxel: a CUDA block owns one x-line,
// so its writes are contiguous and its reads are 32-byte runs of the 2 KB
// block rows (x-line x reads row (bz, by, x>>3) at cell dz*64 + dy*8 + x&7).
// f32 -> bf16 is __float2bfloat16_rn, the round-to-nearest-even of torch and
// JAX. A zero is written as +0.0: the JAX kernels' f32 matmul accumulation
// starting from +0 turns a -0.0 (a cleared negative voxel) into +0.0.
//
// Bound on the H100: memory, 4 bytes read and 2 written per voxel; a full
// rebuild at 512^3 moves 805 MB, 0.240 ms at 3.35 TB/s. Runs on the caller's
// stream, allocates nothing, writes the mirror in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// One mirror x-line: src points at cell (dz, dy, 0) of the line's first
// block row, the line's blocks follow each other every 512 floats.
__device__ __forceinline__ void deblock_line(const float* __restrict__ src,
                                             __nv_bfloat16* __restrict__ dst,
                                             int R) {
  for (int x = threadIdx.x; x < R; x += blockDim.x) {
    const float v = src[(x >> 3) * 512 + (x & 7)];
    dst[x] = __float2bfloat16_rn(v == 0.0f ? 0.0f : v);
  }
}

// grid (pair_cap, 128): blockIdx.y = dz * 16 + yy of the pair's (8,16,R) slab
__global__ void mirror_refresh_kernel(const float* __restrict__ tsdf,
                                      const int* __restrict__ pairs,
                                      const int* __restrict__ count,
                                      __nv_bfloat16* __restrict__ mirror,
                                      int B, int R) {
  if ((int)blockIdx.x >= *count) return;
  const int row0 = pairs[blockIdx.x] * 2;  // rows row0, row0+1 = (bz, by..by+1)
  const int bz = row0 / B, by = row0 % B;
  const int dz = blockIdx.y >> 4, yy = blockIdx.y & 15;
  const int j = yy >> 3, dy = yy & 7;
  deblock_line(tsdf + (size_t)(row0 + j) * B * 512 + dz * 64 + dy * 8,
               mirror + ((size_t)(bz * 8 + dz) * R + (size_t)(by * 8 + yy)) * R,
               R);
}

// grid (R*R): blockIdx.x = z * R + y, one mirror x-line each
__global__ void deblock_kernel(const float* __restrict__ tsdf,
                               __nv_bfloat16* __restrict__ mirror, int B,
                               int R) {
  const int z = blockIdx.x / R, y = blockIdx.x % R;
  const size_t row = ((size_t)(z >> 3) * B + (y >> 3)) * B;
  deblock_line(tsdf + row * 512 + (z & 7) * 64 + (y & 7) * 8,
               mirror + (size_t)blockIdx.x * R, R);
}

}  // namespace

extern "C" int kt_mirror_refresh(const void* tsdf, const void* pairs,
                                 const void* count, void* mirror, int pair_cap,
                                 int B, int R, void* stream) {
  if (pair_cap > 0) {
    dim3 grid(pair_cap, 128);
    mirror_refresh_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const float*)tsdf, (const int*)pairs, (const int*)count,
        (__nv_bfloat16*)mirror, B, R);
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
