// Shared device helpers for the sdvo_tpu_torch Hopper kernels.
//
// All arithmetic is float32, as the Pallas kernels of sdvo_tpu/ops. The
// scalar LM logic (Cholesky, SE3 exp, accept/reject) is evaluated
// redundantly by every thread from reduced values that are bit-identical in
// every thread (a warp's xor-shuffle sums and redux.sync extremes here, a
// block's in lm_block.cuh), so every thread takes the same branch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdvo {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMadBins = 16;  // sdvo_tpu/ops/pallas_lm.py::_MAD_BINS
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}
// order-preserving unsigned image of a float, and back
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}
__device__ __forceinline__ float from_ordered_bits(unsigned k) {
  return __uint_as_float(k ^ ((unsigned)((int)~k >> 31) | 0x80000000u));
}
// a warp's minimum and maximum: one redux.sync on the integer image each
__device__ __forceinline__ float warp_min(float v) {
  return from_ordered_bits(__reduce_min_sync(kFullMask, ordered_bits(v)));
}
__device__ __forceinline__ float warp_max(float v) {
  return from_ordered_bits(__reduce_max_sync(kFullMask, ordered_bits(v)));
}

// 6×6 Cholesky solve of (H + diag) x = g; H packed lower-triangular row-major
// (index i*(i+1)/2 + j). Returns false on a non-positive pivot or a
// non-finite solution (sdvo_tpu/ops/pallas_lm.py::_chol6_scalar). The solve
// is one thread's dependent chain, so each pivot's reciprocal is formed once
// and multiplied, instead of 27 divisions.
__device__ inline bool chol6_solve(const float (&H)[21], const float (&g)[6], float (&x)[6]) {
  float L[21], inv[6];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = H[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
      if (i == j) {
        ok = ok && (s > 0.f);
        L[i * (i + 1) / 2 + j] = sqrtf(fmaxf(s, 1e-30f));
        inv[i] = 1.f / L[i * (i + 1) / 2 + j];
      } else {
        L[i * (i + 1) / 2 + j] = s * inv[j];
      }
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i * (i + 1) / 2 + k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k * (k + 1) / 2 + i] * x[k];
    x[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(x[i]);
  return ok;
}

// SE3 exp of tau = [upsilon, omega] -> R (row-major 9), t (3)
// (sdvo_tpu/ops/pallas_lm.py::_se3_exp_scalar).
__device__ inline void se3_exp(const float (&tau)[6], float (&R)[9], float (&t)[3]) {
  const float ux = tau[0], uy = tau[1], uz = tau[2];
  const float wx = tau[3], wy = tau[4], wz = tau[5];
  const float theta2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(fmaxf(theta2, 1e-30f));
  const bool small = theta2 < 1e-12f;
  const float a = small ? 1.f - theta2 / 6.f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta)) / theta2;
  const float c = small ? 1.f / 6.f - theta2 / 120.f : (theta - sinf(theta)) / (theta2 * theta);
  R[0] = 1.f + b * (-wz * wz - wy * wy); R[1] = -a * wz + b * wx * wy; R[2] = a * wy + b * wx * wz;
  R[3] = a * wz + b * wx * wy; R[4] = 1.f + b * (-wx * wx - wz * wz); R[5] = -a * wx + b * wy * wz;
  R[6] = -a * wy + b * wx * wz; R[7] = a * wx + b * wy * wz; R[8] = 1.f + b * (-wx * wx - wy * wy);
  float V[9];
  V[0] = 1.f + c * (-wz * wz - wy * wy); V[1] = -b * wz + c * wx * wy; V[2] = b * wy + c * wx * wz;
  V[3] = b * wz + c * wx * wy; V[4] = 1.f + c * (-wx * wx - wz * wz); V[5] = -b * wx + c * wy * wz;
  V[6] = -b * wy + c * wx * wz; V[7] = b * wx + c * wy * wz; V[8] = 1.f + c * (-wx * wx - wy * wy);
  t[0] = V[0] * ux + V[1] * uy + V[2] * uz;
  t[1] = V[3] * ux + V[4] * uy + V[5] * uz;
  t[2] = V[6] * ux + V[7] * uy + V[8] * uz;
}

__device__ __forceinline__ void mat3_mul(const float (&A)[9], const float (&B)[9], float (&C)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// Nielsen damping update shared by the LM kernels.
__device__ __forceinline__ float nielsen_lambda(bool success, float lam_eff, float rho, float nu) {
  const float q = 2.f * rho - 1.f;
  return success ? lam_eff * fmaxf(1.f / 3.f, 1.f - q * q * q) : lam_eff * nu;
}

// Bilinear sample of a (WH, WW) row-major window at (x, y) in window
// coordinates, as the tri-weight contraction Σ_h Σ_w tri(y−h)·tri(x−w)·win:
// taps outside the window contribute nothing.
__device__ __forceinline__ float window_bilinear(const float* __restrict__ win, int WH, int WW,
                                                 float x, float y) {
  const float xf = floorf(x), yf = floorf(y);
  const int ix = (int)xf, iy = (int)yf;
  const float ax = x - xf, ay = y - yf;
  const float wx[2] = {1.f - ax, ax};
  const float wy[2] = {1.f - ay, ay};
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int h = iy + dy;
    if (h < 0 || h >= WH) continue;
    float row = 0.f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int w = ix + dx;
      if (w < 0 || w >= WW) continue;
      row += wx[dx] * win[h * WW + w];
    }
    acc += wy[dy] * row;
  }
  return acc;
}

// Value-sampler support rule (sdvo_tpu/ops/window_sampler.py::sample_windows):
// the patch plus one pixel of bilinear support inside the window.
__device__ __forceinline__ bool patch_support_ok(float x0, float y0, int patch, int WH, int WW) {
  return (x0 >= 1.f) && (y0 >= 1.f) && (x0 + patch <= WW - 1.f) && (y0 + patch <= WH - 1.f);
}

}  // namespace sdvo
