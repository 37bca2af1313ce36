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
//                     P1 over the first n ids with n read on the device:
//                     blocks past n return, as the mirror refresh does with
//                     its pair count.
//
// One CUDA block per selected row, one thread per float of it (512 = 4
// sublanes x 128 lanes), updated in place: a row's 2 KB are read and written
// once, neighbouring threads on neighbouring floats. The TPU probes DMA a
// 112x256 (2 channels) and a 56x384 (3 channels) bf16 patch into VMEM per row
// and gather from it with one-hot MXU products; here each thread reads its
// few image values straight from device memory (the patches would need
// 238 KB of shared memory a block, above Hopper's 227 KB, and P2 reads only
// a 4x128 corner of its patch). Both images (1.8 MB) stay in L2.
//
// Bound on the H100: memory. P1 moves 2 KB in and 2 KB out per row plus its
// id; P2 and P3 add the images once and two corners per row. Runs on the
// caller's stream, allocates nothing. -fmad=false keeps t*0.5 + x*0.5 two
// roundings, as PyTorch's plain version computes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 512;  // floats of a (4,128) row
constexpr int LANES = 128;

// n_dev == nullptr: the count is k
__global__ void rows_kernel(float* __restrict__ tsdf, const int* __restrict__ ids,
                            const int* __restrict__ n_dev) {
  if (n_dev != nullptr && (int)blockIdx.x >= *n_dev) return;
  tsdf[(size_t)ids[blockIdx.x] * ROW + threadIdx.x] += 1.0f;
}

__global__ void dma_kernel(float* __restrict__ tsdf, const int* __restrict__ ids,
                           const int* __restrict__ cy, const int* __restrict__ cx,
                           const __nv_bfloat16* __restrict__ img, int W) {
  const int i = blockIdx.x, s = threadIdx.x / LANES, l = threadIdx.x % LANES;
  const float p = __bfloat162float(img[(size_t)(cy[i] + s) * W + cx[i] + l]);
  tsdf[(size_t)ids[i] * ROW + threadIdx.x] += p;
}

__global__ void full_kernel(float* __restrict__ tsdf, const int* __restrict__ ids,
                            const int* __restrict__ cy, const int* __restrict__ cx,
                            const __nv_bfloat16* __restrict__ img,
                            const __nv_bfloat16* __restrict__ img2, int H, int W,
                            int H2, int W2, int pw, int ph) {
  const int i = blockIdx.x;
  float* row = tsdf + (size_t)ids[i] * ROW + threadIdx.x;
  const float t = *row;
  const float a = fabsf(t);
  const int u = (int)fminf(fmaxf(a * 100.0f, 0.0f), (float)(pw - 1));
  const int v = (int)fminf(fmaxf(a * 70.0f, 0.0f), (float)(ph - 1));
  const size_t px = (size_t)(cy[i] + v) * W + cx[i] + u;
  const float rays = __bfloat162float(img[px]) +
                     __bfloat162float(img[(size_t)H * W + px]);
  const size_t px2 = (size_t)(cy[i] / 2 + v / 2) * W2 + u / 2;
  const float rgb = (__bfloat162float(img2[px2]) +
                     __bfloat162float(img2[(size_t)H2 * W2 + px2])) +
                    __bfloat162float(img2[(size_t)2 * H2 * W2 + px2]);
  *row = t * 0.5f + (rays + rgb) * 0.5f;
}

}  // namespace

extern "C" int kt_probe_rows(void* tsdf, const void* ids, const void* n_dev, int k,
                             void* stream) {
  if (k > 0) {
    rows_kernel<<<k, ROW, 0, (cudaStream_t)stream>>>(
        (float*)tsdf, (const int*)ids, (const int*)n_dev);
  }
  return (int)cudaGetLastError();
}

extern "C" int kt_probe_dma(void* tsdf, const void* ids, const void* cy,
                            const void* cx, const void* img, int k, int W,
                            void* stream) {
  if (k > 0) {
    dma_kernel<<<k, ROW, 0, (cudaStream_t)stream>>>(
        (float*)tsdf, (const int*)ids, (const int*)cy, (const int*)cx,
        (const __nv_bfloat16*)img, W);
  }
  return (int)cudaGetLastError();
}

extern "C" int kt_probe_full(void* tsdf, const void* ids, const void* cy,
                             const void* cx, const void* img, const void* img2,
                             int k, int H, int W, int H2, int W2, int pw, int ph,
                             void* stream) {
  if (k > 0) {
    full_kernel<<<k, ROW, 0, (cudaStream_t)stream>>>(
        (float*)tsdf, (const int*)ids, (const int*)cy, (const int*)cx,
        (const __nv_bfloat16*)img, (const __nv_bfloat16*)img2, H, W, H2, W2, pw,
        ph);
  }
  return (int)cudaGetLastError();
}
