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
//   instantiates (window, newton) = (5,0), (5,1) (the tracker's) and (5,2)
//   unrolled; every other pair with window >= 1 and newton >= 0 runs the
//   run-time instantiation (tile_raycast_loop_kernel), which gathers a tap,
//   evaluates it and moves on: the same per-tap formula in the same order,
//   so the same bits as an unrolled pair would give, one round of gathers a
//   tap. The first tap sits window/2 steps before the warm start, for an
//   even window too, as the TPU kernel puts it;
// - a block is a 32x4 tile of pixels, one warp a row of 32, so a warp's stores
//   are 128 contiguous bytes of each output and the block's four rows read
//   overlapping rows of the mirror from the L1; the ragged edge is masked;
// - the taps are evaluated before the crossings are compared, in the order of
//   the sequential march, so the first + -> - crossing wins as before, and
//   only that crossing's interpolation is divided. Each tap's arithmetic is
//   the one formula, operation for operation, and -fmad=false keeps every
//   rounding: the bits equal a run-time loop's.
// kernel_stats: 96 registers at (5,1), the launch bound's cap, no spills; 771
// SASS instructions a pixel in one straight run; the run-time instantiation
// 40 registers, 456 static instructions with a 141-instruction loop body.
// On the H100 (phase 1 of chip_smoke.py) (5,3) through the run-time loops
// takes 0.0115 ms against 0.0089 for the unrolled (5,1). Tiles of 32x2 and
// 32x8 time the same; a cap of 4 blocks an SM leaves 72 of the 600 tiles to
// a second wave and is slower.
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

// the unit ray of pixel (u,v); params: [origin xyz (3) | rotation
// row-major (9)] of the camera->local pose
__device__ __forceinline__ Ray pixel_ray(const float* __restrict__ params,
                                         float u, float v, float fx, float fy,
                                         float cx, float cy) {
  const float rxc = (u - cx) / fx, ryc = (v - cy) / fy;
  const float dxx = __ldg(params + 3) * rxc + __ldg(params + 4) * ryc +
                    __ldg(params + 5);
  const float dyy = __ldg(params + 6) * rxc + __ldg(params + 7) * ryc +
                    __ldg(params + 8);
  const float dzz = __ldg(params + 9) * rxc + __ldg(params + 10) * ryc +
                    __ldg(params + 11);
  const float inv_n = 1.0f / sqrtf(dxx * dxx + dyy * dyy + dzz * dzz);
  return Ray{__ldg(params), __ldg(params + 1), __ldg(params + 2),
             dxx * inv_n,   dyy * inv_n,       dzz * inv_n};
}

// the window march's state: the first + -> - crossing (its left tap's
// value and t, and the drop), whether every tap lay in the volume, and the
// last tap's value
struct March {
  bool found, ok_all;
  float prev_val, cross_val, cross_drop, cross_t;
};

// tap k of the window, at t0 + k*step, in the order of the sequential march
__device__ __forceinline__ void march_tap(March& m, const Corners& tap, int k,
                                          float t0, float step) {
  const float val = interpolate(tap, nullptr);
  m.ok_all = m.ok_all && tap.inreg;
  if (k > 0 && !m.found && m.prev_val > 0.0f && val < 0.0f) {
    m.found = true;
    m.cross_val = m.prev_val;
    m.cross_drop = m.prev_val - val;
    m.cross_t = t0 + (float)(k - 1) * step;
  }
  m.prev_val = val;
}

// the crossing's ray length: one division, for the crossing taken (a
// run-time loop divided at each tap and kept the first crossing's
// quotient: the same bits)
__device__ __forceinline__ float march_hit(const March& m, float step) {
  const float frac =
      fabsf(m.cross_drop) > 1e-12f ? m.cross_val / m.cross_drop : 0.5f;
  return m.found ? m.cross_t + step * frac : 0.0f;
}

// one Newton step on the analytic gradient, from t_hit; g gets the
// gradient (voxel units)
__device__ __forceinline__ float newton_step(
    const __nv_bfloat16* __restrict__ mirror, int R, const Ray& ray,
    float inv_vsz, float trunc, float t_hit, bool& found, float* g) {
  const Corners s = gather(mirror, R, ray, inv_vsz, t_hit);
  const float val = interpolate(s, g);
  found = found && s.inreg;
  const float dval_dt =
      (g[0] * ray.dnx + g[1] * ray.dny + g[2] * ray.dnz) * inv_vsz;
  const float nstep = fabsf(dval_dt) > 1e-6f ? val / dval_dt : 0.0f;
  return t_hit - fminf(fmaxf(nstep, -2.0f * trunc), 2.0f * trunc);
}

struct Out {
  float *t, *found, *gx, *gy, *gz;
};

__device__ __forceinline__ void store(const Out& o, int p, bool found,
                                      float t_hit, const float* g) {
  o.t[p] = found ? t_hit : 0.0f;
  o.found[p] = found ? 1.0f : 0.0f;
  o.gx[p] = g[0];
  o.gy[p] = g[1];
  o.gz[p] = g[2];
}

// the window and the Newton count unrolled: (5,0), (5,1), (5,2)
template <int kWindow, int kNewton>
__global__ void __launch_bounds__(kTileW* kTileH, kMinBlocks)
    tile_raycast_kernel(const __nv_bfloat16* __restrict__ mirror,
                        const float* __restrict__ t_warm,
                        const float* __restrict__ params, Out out, int h, int w,
                        int R, float inv_vsz, float fx, float fy, float cx,
                        float cy, float step, float trunc) {
  const int px = blockIdx.x * kTileW + threadIdx.x;
  const int py = blockIdx.y * kTileH + threadIdx.y;
  if (px >= w || py >= h) return;
  const int p = py * w + px;
  const Ray ray = pixel_ray(params, (float)px, (float)py, fx, fy, cx, cy);

  const float warm = __ldg(t_warm + p);
  const float t0 = warm - (float)(kWindow / 2) * step;
  // round 1: every window tap's corners in flight together
  Corners taps[kWindow];
#pragma unroll
  for (int k = 0; k < kWindow; ++k)
    taps[k] = gather(mirror, R, ray, inv_vsz, t0 + (float)k * step);
  March m{false, warm > 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kWindow; ++k) march_tap(m, taps[k], k, t0, step);
  float t_hit = march_hit(m, step);
  bool found = m.found && m.ok_all;
  // then one round of gathers a Newton step
  float g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int it = 0; it < kNewton; ++it)
    t_hit = newton_step(mirror, R, ray, inv_vsz, trunc, t_hit, found, g);
  store(out, p, found, t_hit, g);
}

// any other (window >= 1, newton >= 0): run-time loops, a tap gathered and
// evaluated before the next
__global__ void __launch_bounds__(kTileW* kTileH)
    tile_raycast_loop_kernel(const __nv_bfloat16* __restrict__ mirror,
                             const float* __restrict__ t_warm,
                             const float* __restrict__ params, Out out, int h,
                             int w, int R, float inv_vsz, float fx, float fy,
                             float cx, float cy, float step, float trunc,
                             int window, int newton) {
  const int px = blockIdx.x * kTileW + threadIdx.x;
  const int py = blockIdx.y * kTileH + threadIdx.y;
  if (px >= w || py >= h) return;
  const int p = py * w + px;
  const Ray ray = pixel_ray(params, (float)px, (float)py, fx, fy, cx, cy);

  const float warm = __ldg(t_warm + p);
  const float t0 = warm - (float)(window / 2) * step;
  March m{false, warm > 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < window; ++k)
    march_tap(m, gather(mirror, R, ray, inv_vsz, t0 + (float)k * step), k, t0,
              step);
  float t_hit = march_hit(m, step);
  bool found = m.found && m.ok_all;
  float g[3] = {0.0f, 0.0f, 0.0f};
  for (int it = 0; it < newton; ++it)
    t_hit = newton_step(mirror, R, ray, inv_vsz, trunc, t_hit, found, g);
  store(out, p, found, t_hit, g);
}

struct Args {
  const __nv_bfloat16* mirror;
  const float *t_warm, *params;
  Out out;
  int h, w, R;
  float inv_vsz, fx, fy, cx, cy, step, trunc;
};

dim3 tile_grid(const Args& a) {
  return dim3((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH);
}

template <int kWindow, int kNewton>
void launch(const Args& a, cudaStream_t stream) {
  tile_raycast_kernel<kWindow, kNewton>
      <<<tile_grid(a), dim3(kTileW, kTileH), 0, stream>>>(
          a.mirror, a.t_warm, a.params, a.out, a.h, a.w, a.R, a.inv_vsz, a.fx,
          a.fy, a.cx, a.cy, a.step, a.trunc);
}

}  // namespace

// Returns cudaErrorInvalidValue, launching nothing, for window < 1 or
// newton < 0. (5,0), (5,1) and (5,2) run unrolled
// (ops/cuda_raycast.RAYCAST_PAIRS), every other pair the run-time loops.
extern "C" int kt_tile_raycast(const void* mirror, const void* t_warm,
                               const void* params, void* t_out,
                               void* found_out, void* gx_out, void* gy_out,
                               void* gz_out, int h, int w, int R, float inv_vsz,
                               float fx, float fy, float cx, float cy,
                               float step, float trunc, int window, int newton,
                               void* stream) {
  if (window < 1 || newton < 0) return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  const Args a{(const __nv_bfloat16*)mirror,
               (const float*)t_warm,
               (const float*)params,
               Out{(float*)t_out, (float*)found_out, (float*)gx_out,
                   (float*)gy_out, (float*)gz_out},
               h, w, R, inv_vsz, fx, fy, cx, cy, step, trunc};
  const cudaStream_t s = (cudaStream_t)stream;
  decltype(&launch<5, 1>) run = nullptr;
  if (window == 5 && newton == 0) run = &launch<5, 0>;
  if (window == 5 && newton == 1) run = &launch<5, 1>;
  if (window == 5 && newton == 2) run = &launch<5, 2>;
  if (run != nullptr) {
    run(a, s);
  } else {
    tile_raycast_loop_kernel<<<tile_grid(a), dim3(kTileW, kTileH), 0, s>>>(
        a.mirror, a.t_warm, a.params, a.out, a.h, a.w, a.R, a.inv_vsz, a.fx,
        a.fy, a.cx, a.cy, a.step, a.trunc, window, newton);
  }
  return (int)cudaGetLastError();
}
