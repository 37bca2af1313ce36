// The tail of one Gauss-Newton step (Hopper, sm_90a): kt_gn_update.
//
// Replaces, in ops/reduce.gn_update, the plain version's ~270 launches of
// 0-d and 6x6 tensor ops a step (the optional trace-normalised RGB-D
// fusion, add_motion_prior, solve_gn with its unrolled Cholesky,
// se3.exp_se3, the compose and the accept test) by one launch. The work
// is a few hundred flops on 56 inputs: one thread does it, and the kernel
// is bound by its own launch and the latency of its dependent chain of
// divisions and square roots, not by bytes or flops.
//
// Same bits as the plain version on the card. Each torch op is one IEEE
// rounding, repeated here in the same order: -fmad=false keeps a * b + c
// two roundings, and the constants are the Python floats PyTorch casts to
// float. Where the plain version's op rounds differently from its formula,
// this code copies the op:
// - `x / c` by a Python scalar c is x * (1.0f / c) (PyTorch's CUDA divide
//   by a CPU scalar takes the reciprocal once); `1.0 / x` is
//   reciprocal(x) * 1.0, an IEEE division;
// - clamp(x, min=lo) returns a NaN x and max(x, lo) otherwise;
// - torch.sum over 3 and torch.trace add in the order of PyTorch's reduce
//   kernel at those sizes;
// - the 3x3, 3-vector and 4x4 products, which the plain version sends to
//   cuBLAS (TF32 off), accumulate as cuBLAS's small-matrix kernels do.
// The orders were read off the card (tests/test_torch_cuda.py holds the
// kernel to the plain version bit for bit on random and recorded systems).
//
// The kernel reads the inputs and writes the new pose on the caller's
// stream, allocates nothing and reads nothing on the host, so a CUDA
// graph can capture it.

#include <cuda_runtime.h>

namespace {

// a Python float as PyTorch hands it to a float kernel
#define PYF(x) ((float)(x))

struct Sys {
  float A[6][6];
  float b[6];
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// One element of a product of small matrices, as cuBLAS accumulates it
// for the plain version's 3x3 and 4x4 products and 3-vectors on the H100:
// two partial sums, (a0 b0 + a1 b1) and (a2 b2 + a3 b3), each a product
// and an fma, then their sum.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return fmaf(a1, b1, a0 * b0) + a2 * b2;
}

__device__ __forceinline__ float dot4(const float (&a)[4][4], int i,
                                      const float (&b)[4][4], int j) {
  return fmaf(a[i][1], b[1][j], a[i][0] * b[0][j]) + fmaf(a[i][3], b[3][j], a[i][2] * b[2][j]);
}

// torch.sum and torch.trace: PyTorch's reduce kernel at these sizes keeps
// two partial sums, of the even and of the odd elements, and adds them
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}

__device__ __forceinline__ float trace6(const float (&A)[6][6]) {
  return ((A[0][0] + A[4][4]) + A[2][2]) + ((A[1][1] + A[5][5]) + A[3][3]);
}

// C = X @ Y, 4x4
__device__ __forceinline__ void mat4(const float (&X)[4][4], const float (&Y)[4][4],
                                     float (&C)[4][4]) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) C[i][j] = dot4(X, i, Y, j);
}

// se3.exp_se3: xi = [omega, v] -> E (4x4)
__device__ void exp_se3(const float (&xi)[6], float (&E)[4][4]) {
  const float wx = xi[0], wy = xi[1], wz = xi[2];
  const float theta2 = sum3(wx * wx, wy * wy, wz * wz);
  // se3.hat, with its zeros and negations
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = dot3(W[i][0], W[0][j], W[i][1], W[1][j], W[i][2], W[2][j]);
  // _rodrigues_coeffs and exp_se3's c
  const float theta = sqrtf(theta2 + PYF(1e-32));
  const bool small = theta2 < PYF(1e-4);
  const float a = small ? 1.0f - theta2 * (1.0f / PYF(6.0)) : sinf(theta) / theta;
  const float b = small ? PYF(0.5) - theta2 * (1.0f / PYF(24.0))
                        : (1.0f - cosf(theta)) / theta2;
  const float c = small ? PYF(1.0 / 6.0) - theta2 * (1.0f / PYF(120.0))
                        : (1.0f - a) / theta2;
  float R[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      R[i][j] = (eye + a * W[i][j]) + b * W2[i][j];
      V[i][j] = (eye + b * W[i][j]) + c * W2[i][j];
    }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) E[i][j] = R[i][j];
    E[i][3] = dot3(V[i][0], xi[3], V[i][1], xi[4], V[i][2], xi[5]);
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
}

// add_motion_prior with prior_increment(T, T_prior), in place
__device__ void add_motion_prior(Sys& s, const float (&T)[4][4], const float (&Tp)[4][4],
                                 float weight) {
  const float lam_r = (weight * ((s.A[0][0] + s.A[1][1]) + s.A[2][2])) * (1.0f / PYF(3.0));
  const float lam_t = (weight * ((s.A[3][3] + s.A[4][4]) + s.A[5][5])) * (1.0f / PYF(3.0));
  // se3.inverse(T): [R^T, -(R^T t)]
  float Ti[4][4];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Ti[i][j] = T[j][i];
    Ti[i][3] = -dot3(T[0][i], T[0][3], T[1][i], T[1][3], T[2][i], T[2][3]);
  }
  Ti[3][0] = Ti[3][1] = Ti[3][2] = 0.0f;
  Ti[3][3] = 1.0f;
  float E[4][4];
  mat4(Tp, Ti, E);
  const float xp[6] = {PYF(0.5) * (E[2][1] - E[1][2]), PYF(0.5) * (E[0][2] - E[2][0]),
                       PYF(0.5) * (E[1][0] - E[0][1]), E[0][3], E[1][3], E[2][3]};
  for (int i = 0; i < 6; ++i) {
    const float w6 = i < 3 ? lam_r : lam_t;
    for (int j = 0; j < 6; ++j) s.A[i][j] = s.A[i][j] + (i == j ? w6 : 0.0f);
    s.b[i] = s.b[i] + w6 * xp[i];
  }
}

// solve_gn: the damped, unrolled Cholesky solve; false where xi is not
// finite
__device__ bool solve_gn(const Sys& s, float (&x)[6]) {
  float scale = fabsf(s.A[0][0]);
  for (int i = 1; i < 6; ++i) {
    const float d = fabsf(s.A[i][i]);
    scale = (isnan(scale) || scale >= d) ? scale : d;  // torch.max: NaN wins
  }
  scale = clamp_min(scale, PYF(1e-12));
  const float ds = PYF(1e-6) * scale;
  float A[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) A[i][j] = s.A[i][j] + ds * (i == j ? 1.0f : 0.0f);
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    float acc = A[i][i];
    for (int k = 0; k < i; ++k) acc = acc - L[i][k] * L[i][k];
    L[i][i] = sqrtf(clamp_min(acc, PYF(1e-30)));
    const float inv = (1.0f / L[i][i]) * PYF(1.0);
    for (int j = i + 1; j < 6; ++j) {
      float t = A[j][i];
      for (int k = 0; k < i; ++k) t = t - L[j][k] * L[i][k];
      L[j][i] = t * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float t = s.b[i];
    for (int k = 0; k < i; ++k) t = t - L[i][k] * y[k];
    y[i] = t / L[i][i];
  }
  bool ok = true;
  for (int i = 5; i >= 0; --i) {
    float t = y[i];
    for (int k = i + 1; k < 6; ++k) t = t - L[k][i] * x[k];
    x[i] = t / L[i][i];
  }
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(x[i]);
  return ok;
}

__global__ void gn_update_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                 const float* __restrict__ count,
                                 const float* __restrict__ T,
                                 const float* __restrict__ T_prior,
                                 const float* __restrict__ weight_ptr,
                                 const float* __restrict__ A2, const float* __restrict__ b2,
                                 float weight, float w2, float min_inliers,
                                 float* __restrict__ T_out) {
  Sys s;
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) s.A[i][j] = A[i * 6 + j];
    s.b[i] = b[i];
  }
  float Tm[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) Tm[i][j] = T[i * 4 + j];
  if (A2 != nullptr) {
    // the trace-normalised fusion of the photometric and ICP systems
    float B2[6][6];
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) B2[i][j] = A2[i * 6 + j];
    const float s1 = (1.0f / (trace6(s.A) + PYF(1e-12))) * PYF(1.0);
    const float s2 = (1.0f / (trace6(B2) + PYF(1e-12))) * PYF(1.0);
    const float ws2 = w2 * s2;
    for (int i = 0; i < 6; ++i) {
      for (int j = 0; j < 6; ++j) s.A[i][j] = s1 * s.A[i][j] + ws2 * B2[i][j];
      s.b[i] = s1 * s.b[i] + ws2 * b2[i];
    }
  }
  if (T_prior != nullptr) {
    float Tp[4][4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) Tp[i][j] = T_prior[i * 4 + j];
    add_motion_prior(s, Tm, Tp, weight_ptr != nullptr ? *weight_ptr : weight);
  }
  float xi[6];
  const bool ok = solve_gn(s, xi) && count[0] >= min_inliers;
  float Tn[4][4];
  if (ok) {
    float E[4][4];
    exp_se3(xi, E);
    mat4(E, Tm, Tn);
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) T_out[i * 4 + j] = ok ? Tn[i][j] : Tm[i][j];
}

}  // namespace

extern "C" int kt_gn_update(const void* A, const void* b, const void* count, const void* T,
                            const void* T_prior, const void* weight_ptr, const void* A2,
                            const void* b2, float weight, float w2, float min_inliers,
                            void* T_out, void* stream) {
  gn_update_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)b, (const float*)count, (const float*)T,
      (const float*)T_prior, (const float*)weight_ptr, (const float*)A2, (const float*)b2,
      weight, w2, min_inliers, (float*)T_out);
  return (int)cudaGetLastError();
}
