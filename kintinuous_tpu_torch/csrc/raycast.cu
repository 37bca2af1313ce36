// Warm-started raycast against the dense bf16 mirror (Hopper, sm_90a).
//
// Replaces kintinuous_tpu/ops/pallas_raycast.py:_raycast_kernel. The TPU kernel
// DMAs a (48,48,256) region per 16x16 pixel tile into VMEM and evaluates every
// trilinear tap as two-hot MXU contractions; pixels whose taps leave the region
// fall back to the measurement. A Hopper thread reads the mirror directly, so
// there is no region: one thread per half-resolution pixel, and the region test
// becomes the volume test [0, R-1.001] with the clip to R-1.002.
//
// Per pixel: the ray from (u,v) through the pose's rotation, `window` taps
// `step` apart centred on the warm-start ray length, the first + -> - crossing
// by linear interpolation, then `newton` Newton steps on the analytic
// trilinear gradient (step clamped to +-2*trunc). Samples are bf16 mirror
// values interpolated in f32, collapsed x, then y, then z.
//
// Bound on the H100: memory latency of the dependent gathers (8 bf16 corners a
// tap, 5 window taps and a Newton tap a pixel, 76,800 pixels, about 580 threads
// an SM); the bytes (~9 MB of corner reads, mostly L2 hits along coherent rays)
// and ~2,000 f32 operations a pixel are small. The design cuts the rounds of
// dependent gathers a pixel waits for:
// - the window and the Newton count are template parameters, so the window is
//   unrolled and a thread issues the 40 corner loads of its 5 taps before it
//   uses any of them: two rounds of gathers a pixel (the window, then the
//   Newton step), where a run-time loop waited on six. The launcher
//   instantiates (window, newton) = (5,0), (5,1) (the tracker's) and (5,2) and
//   refuses any other pair; there is no run-time loop to fall back on;
// - a block is a 32x4 tile of pixels, one warp a row of 32, so a warp's stores
//   are 128 contiguous bytes of each output and the block's four rows read
//   overlapping rows of the mirror from the L1; the ragged edge is masked;
// - the taps are evaluated before the crossings are compared, in the order of
//   the sequential march, so the first + -> - crossing wins as before, and
//   only that crossing's interpolation is divided. Each tap's arithmetic is
//   the one formula, operation for operation, and -fmad=false keeps every
//   rounding: the bits equal a run-time loop's.
// kernel_stats: 96 registers at (5,1), the launch bound's cap, no spills; 772
// SASS instructions a pixel in one straight run (the run-time loop it
// replaces: 32 registers, 494 static instructions with a 144-instruction
// body run once a tap). Tiles of 32x2 and 32x8 time the same; a cap of 4
// blocks an SM leaves 72 of the 600 tiles to a second wave and is slower.
// Runs on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32, kTileH = 4;
// resident blocks an SM asked of the register allocator: a 320x240 frame's
// 600 tiles fit on the 132 SMs in one wave
constexpr int kMinBlocks = 5;

struct Ray {
  float ox, oy, oz, dnx, dny, dnz;
};

// one tap's 8 corners v[z][y][x] (v000, v001, v010, ..., v111), its
// fractions and whether it lies in the volume
struct Corners {
  float v[8];
  float fx, fy, fz;
  bool inreg;
};

__device__ __forceinline__ Corners gather(
    const __nv_bfloat16* __restrict__ mirror, int R, const Ray& r,
    float inv_vsz, float t) {
  float vx = (r.ox + t * r.dnx) * inv_vsz - 0.5f;
  float vy = (r.oy + t * r.dny) * inv_vsz - 0.5f;
  float vz = (r.oz + t * r.dnz) * inv_vsz - 0.5f;
  const float hi = (float)R - 1.001f;
  const float hc = (float)R - 1.002f;
  Corners c;
  c.inreg = vx >= 0.0f && vx <= hi && vy >= 0.0f && vy <= hi && vz >= 0.0f &&
            vz <= hi;
  vx = fminf(fmaxf(vx, 0.0f), hc);
  vy = fminf(fmaxf(vy, 0.0f), hc);
  vz = fminf(fmaxf(vz, 0.0f), hc);
  const float ix = floorf(vx), iy = floorf(vy), iz = floorf(vz);
  c.fx = vx - ix;
  c.fy = vy - iy;
  c.fz = vz - iz;
  const __nv_bfloat16* p =
      mirror + ((size_t)(int)iz * R + (size_t)(int)iy) * R + (size_t)(int)ix;
  const size_t sy = R, sz = (size_t)R * R;
  c.v[0] = __bfloat162float(p[0]);
  c.v[1] = __bfloat162float(p[1]);
  c.v[2] = __bfloat162float(p[sy]);
  c.v[3] = __bfloat162float(p[sy + 1]);
  c.v[4] = __bfloat162float(p[sz]);
  c.v[5] = __bfloat162float(p[sz + 1]);
  c.v[6] = __bfloat162float(p[sz + sy]);
  c.v[7] = __bfloat162float(p[sz + sy + 1]);
  return c;
}

// the trilinear value, and with grad the analytic gradient (voxel units)
__device__ __forceinline__ float interpolate(const Corners& c, float* grad) {
  const float ax = 1.0f - c.fx, ay = 1.0f - c.fy, az = 1.0f - c.fz;
  // collapse x
  const float a00 = c.v[0] * ax + c.v[1] * c.fx;
  const float a01 = c.v[2] * ax + c.v[3] * c.fx;
  const float a10 = c.v[4] * ax + c.v[5] * c.fx;
  const float a11 = c.v[6] * ax + c.v[7] * c.fx;
  // collapse y
  const float b0 = a00 * ay + a01 * c.fy, b1 = a10 * ay + a11 * c.fy;
  if (grad != nullptr) {
    const float d00 = c.v[1] - c.v[0], d01 = c.v[3] - c.v[2];
    const float d10 = c.v[5] - c.v[4], d11 = c.v[7] - c.v[6];
    grad[0] = (d00 * ay + d01 * c.fy) * az + (d10 * ay + d11 * c.fy) * c.fz;
    grad[1] = (a01 - a00) * az + (a11 - a10) * c.fz;
    grad[2] = b1 - b0;
  }
  return b0 * az + b1 * c.fz;
}

// params: [origin xyz (3) | rotation row-major (9)] of the camera->local pose
template <int kWindow, int kNewton>
__global__ void __launch_bounds__(kTileW* kTileH, kMinBlocks)
    tile_raycast_kernel(const __nv_bfloat16* __restrict__ mirror,
                        const float* __restrict__ t_warm,
                        const float* __restrict__ params,
                        float* __restrict__ t_out,
                        float* __restrict__ found_out,
                        float* __restrict__ gx_out,
                        float* __restrict__ gy_out,
                        float* __restrict__ gz_out, int h, int w, int R,
                        float inv_vsz, float fx, float fy, float cx, float cy,
                        float step, float trunc) {
  const int px = blockIdx.x * kTileW + threadIdx.x;
  const int py = blockIdx.y * kTileH + threadIdx.y;
  if (px >= w || py >= h) return;
  const int p = py * w + px;
  const float u = (float)px, v = (float)py;
  const float rxc = (u - cx) / fx, ryc = (v - cy) / fy;
  const float dxx = __ldg(params + 3) * rxc + __ldg(params + 4) * ryc +
                    __ldg(params + 5);
  const float dyy = __ldg(params + 6) * rxc + __ldg(params + 7) * ryc +
                    __ldg(params + 8);
  const float dzz = __ldg(params + 9) * rxc + __ldg(params + 10) * ryc +
                    __ldg(params + 11);
  const float inv_n = 1.0f / sqrtf(dxx * dxx + dyy * dyy + dzz * dzz);
  const Ray ray{__ldg(params), __ldg(params + 1), __ldg(params + 2),
                dxx * inv_n,   dyy * inv_n,       dzz * inv_n};

  const float warm = __ldg(t_warm + p);
  const float t0 = warm - (float)(kWindow / 2) * step;
  // round 1: every window tap's corners in flight together
  Corners taps[kWindow];
#pragma unroll
  for (int k = 0; k < kWindow; ++k)
    taps[k] = gather(mirror, R, ray, inv_vsz, t0 + (float)k * step);

  // the first + -> - crossing: its left tap's value and t, and the drop
  bool found = false, ok_all = warm > 0.0f;
  float prev_val = 0.0f, cross_val = 0.0f, cross_drop = 0.0f, cross_t = 0.0f;
#pragma unroll
  for (int k = 0; k < kWindow; ++k) {
    const float val = interpolate(taps[k], nullptr);
    ok_all = ok_all && taps[k].inreg;
    if (k > 0 && !found && prev_val > 0.0f && val < 0.0f) {
      found = true;
      cross_val = prev_val;
      cross_drop = prev_val - val;
      cross_t = t0 + (float)(k - 1) * step;
    }
    prev_val = val;
  }
  // one division, for the crossing taken (a run-time loop divided at each
  // tap and kept the first crossing's quotient: the same bits)
  const float frac =
      fabsf(cross_drop) > 1e-12f ? cross_val / cross_drop : 0.5f;
  float t_hit = found ? cross_t + step * frac : 0.0f;
  found = found && ok_all;
  // then one round of gathers a Newton step
  float g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int it = 0; it < kNewton; ++it) {
    const Corners s = gather(mirror, R, ray, inv_vsz, t_hit);
    const float val = interpolate(s, g);
    found = found && s.inreg;
    const float dval_dt =
        (g[0] * ray.dnx + g[1] * ray.dny + g[2] * ray.dnz) * inv_vsz;
    const float nstep = fabsf(dval_dt) > 1e-6f ? val / dval_dt : 0.0f;
    t_hit = t_hit - fminf(fmaxf(nstep, -2.0f * trunc), 2.0f * trunc);
  }
  t_out[p] = found ? t_hit : 0.0f;
  found_out[p] = found ? 1.0f : 0.0f;
  gx_out[p] = g[0];
  gy_out[p] = g[1];
  gz_out[p] = g[2];
}

template <int kWindow, int kNewton>
void launch(const void* mirror, const void* t_warm, const void* params,
            void* t_out, void* found_out, void* gx_out, void* gy_out,
            void* gz_out, int h, int w, int R, float inv_vsz, float fx,
            float fy, float cx, float cy, float step, float trunc,
            cudaStream_t stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  tile_raycast_kernel<kWindow, kNewton>
      <<<grid, dim3(kTileW, kTileH), 0, stream>>>(
          (const __nv_bfloat16*)mirror, (const float*)t_warm,
          (const float*)params, (float*)t_out, (float*)found_out,
          (float*)gx_out, (float*)gy_out, (float*)gz_out, h, w, R, inv_vsz, fx,
          fy, cx, cy, step, trunc);
}

}  // namespace

// Returns cudaErrorInvalidValue, launching nothing, for a (window, newton)
// pair that is not instantiated (ops/cuda_raycast.RAYCAST_PAIRS).
extern "C" int kt_tile_raycast(const void* mirror, const void* t_warm,
                               const void* params, void* t_out,
                               void* found_out, void* gx_out, void* gy_out,
                               void* gz_out, int h, int w, int R, float inv_vsz,
                               float fx, float fy, float cx, float cy,
                               float step, float trunc, int window, int newton,
                               void* stream) {
  decltype(&launch<5, 1>) run = nullptr;
  if (window == 5 && newton == 0) run = &launch<5, 0>;
  if (window == 5 && newton == 1) run = &launch<5, 1>;
  if (window == 5 && newton == 2) run = &launch<5, 2>;
  if (run == nullptr) return (int)cudaErrorInvalidValue;
  if (h > 0 && w > 0)
    run(mirror, t_warm, params, t_out, found_out, gx_out, gy_out, gz_out, h, w,
        R, inv_vsz, fx, fy, cx, cy, step, trunc, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
