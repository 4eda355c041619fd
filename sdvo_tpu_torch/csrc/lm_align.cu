// K1 — one pyramid level of inverse-compositional photometric LM.
//
// Replaces sdvo_tpu/ops/pallas_lm.py::lm_align_level (body _lm_level_kernel).
// Semantics are the Pallas kernel's: windows sampled bilinearly with the
// value-sampler support rule, Tukey weights with sigma = 1.4826·MAD from the
// 16-bin two-stage binned median, Nielsen-damped 6×6 Cholesky, the right
// update T <- T∘exp(−dx), accept on a chi² decrease, and the relative-decrease
// exit.
//
// What bounds it on an H100: the whole level is ONE thread block on one SM
// of 132 — N·P² = 6400 residuals at N = 256 features — and every LM
// iteration is a chain of ~10 dependent block reductions (H/g, min/max, four
// 16-bin count stages, chi²). It is latency-bound: the work per iteration is
// a few hundred kFLOP, far below what one SM sustains, and the reductions'
// __syncthreads chains set the time. The design keeps everything inside one
// launch (no per-iteration launches, no host syncs) and keeps each thread's
// residuals, weights and visibility in a per-thread slice of a global
// scratch buffer (L1-resident at these sizes), so no data crosses threads
// except through the reductions.
#include "common.cuh"

namespace sdvo {
namespace {

constexpr int kLmThreads = 256;

struct LmArgs {
  const float* win;      // (N, WH, WW)
  const float* patches;  // (N, P2)
  const float* J;        // (N, P2, 6)
  const float* pts;      // (N, 3)
  const float* org;      // (N, 2)
  const float* vis_in;   // (N,)
  float fx, fy, cx, cy;
  int N, WH, WW, patch;
};

// residuals at pose (R, t) for feature n -> r[P2], returns the feature's
// visibility (0/1).
__device__ float lm_residuals(const LmArgs& a, int n, const float (&R)[9], const float (&t)[3],
                              float* r) {
  const float X = a.pts[3 * n], Y = a.pts[3 * n + 1], Z = a.pts[3 * n + 2];
  const float px = X * R[0] + Y * R[1] + Z * R[2] + t[0];
  const float py = X * R[3] + Y * R[4] + Z * R[5] + t[1];
  const float pz = X * R[6] + Y * R[7] + Z * R[8] + t[2];
  const float zs = pz < 1e-6f ? 1.f : pz;
  const float u = a.fx * px / zs + a.cx - a.org[2 * n];
  const float v = a.fy * py / zs + a.cy - a.org[2 * n + 1];
  const int half = a.patch / 2;
  const float x0 = u - half, y0 = v - half;
  const bool ok = patch_support_ok(x0, y0, a.patch, a.WH, a.WW);
  const float vis = (a.vis_in[n] > 0.5f && ok && pz > 1e-6f) ? 1.f : 0.f;
  const float* win = a.win + (size_t)n * a.WH * a.WW;
  const int P2 = a.patch * a.patch;
  for (int p = 0; p < a.patch; ++p)
    for (int q = 0; q < a.patch; ++q) {
      const float val = window_bilinear(win, a.WH, a.WW, x0 + q, y0 + p);
      r[p * a.patch + q] = (val - a.patches[(size_t)n * P2 + p * a.patch + q]) * vis;
    }
  return vis;
}

// two-stage binned median of x (or |x − center| when dev) over the visible
// residuals of the whole level
__device__ float lm_bin_median(const LmArgs& a, const float* r, const float* vis, bool dev,
                               float center, float lo, float hi, float half_n, float* sm) {
  const int P2 = a.patch * a.patch;
  float med = hi;
  for (int stage = 0; stage < 2; ++stage) {
    float thr[kMadBins];
    bin_thresholds(lo, hi, thr);
    float cnt[kMadBins];
#pragma unroll
    for (int b = 0; b < kMadBins; ++b) cnt[b] = 0.f;
    for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
      if (vis[n] < 0.5f) continue;
      for (int k = 0; k < P2; ++k) {
        float x = r[(size_t)n * P2 + k];
        if (dev) x = fabsf(x - center);
#pragma unroll
        for (int b = 0; b < kMadBins; ++b) cnt[b] += (x <= thr[b]) ? 1.f : 0.f;
      }
    }
    block_sum<kMadBins>(cnt, sm);
    bin_median_stage(cnt, half_n, lo, hi, med);
  }
  return med;
}

// Tukey weights of r into w; returns chi².
__device__ float lm_weights(const LmArgs& a, const float* r, const float* vis, float* w,
                            float* sm) {
  const int P2 = a.patch * a.patch;
  float lo = kBig, hi = -kBig, nv[1] = {0.f};
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    if (vis[n] < 0.5f) continue;
    nv[0] += (float)P2;
    for (int k = 0; k < P2; ++k) {
      lo = fminf(lo, r[(size_t)n * P2 + k]);
      hi = fmaxf(hi, r[(size_t)n * P2 + k]);
    }
  }
  block_sum<1>(nv, sm);
  lo = block_min(lo, sm);
  hi = block_max(hi, sm);
  const float n_vis = fmaxf(nv[0], 1.f);
  const float half_n = 0.5f * n_vis;
  const float med = lm_bin_median(a, r, vis, false, 0.f, lo, hi, half_n, sm);
  float hi2 = 0.f;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    if (vis[n] < 0.5f) continue;
    for (int k = 0; k < P2; ++k) hi2 = fmaxf(hi2, fabsf(r[(size_t)n * P2 + k] - med));
  }
  hi2 = block_max(hi2, sm);
  const float mad = lm_bin_median(a, r, vis, true, med, 0.f, hi2, half_n, sm);
  const float c = 4.6851f * fmaxf(1.4826f * mad, 1e-12f);
  float ch[1] = {0.f};
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    for (int k = 0; k < P2; ++k) {
      const float rv = r[(size_t)n * P2 + k];
      float wv = 1.f - (rv * rv) / (c * c);
      wv = (fabsf(rv) <= c) ? wv * wv * vis[n] : 0.f;
      w[(size_t)n * P2 + k] = wv;
      ch[0] += wv * rv * rv;
    }
  }
  block_sum<1>(ch, sm);
  return ch[0];
}

__global__ void __launch_bounds__(kLmThreads) lm_align_level_kernel(
    LmArgs a, const float* __restrict__ pose_in, float* __restrict__ out_pose,
    float* __restrict__ out_stats, float* __restrict__ scratch, int max_iters,
    float min_rel_decrease) {
  __shared__ float sm[32 * 27];
  const int P2 = a.patch * a.patch;
  const size_t NP = (size_t)a.N * P2;
  float* r_acc = scratch;
  float* w_acc = scratch + NP;
  float* r_new = scratch + 2 * NP;
  float* w_new = scratch + 3 * NP;
  float* vis_acc = scratch + 4 * NP;
  float* vis_new = vis_acc + a.N;

  float R[9], t[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[3 * i + j] = pose_in[4 * i + j];
    t[i] = pose_in[4 * i + 3];
  }
  for (int n = threadIdx.x; n < a.N; n += blockDim.x)
    vis_acc[n] = lm_residuals(a, n, R, t, r_acc + (size_t)n * P2);
  float chi = lm_weights(a, r_acc, vis_acc, w_acc, sm);

  float lam = 1e-2f, nu = 2.f;
  int it = 0;
  bool done = false;
  while (it < max_iters && !done) {
    // H = JᵀWJ (lower triangle) and g = JᵀWr at the accepted state
    float hg[27];
#pragma unroll
    for (int i = 0; i < 27; ++i) hg[i] = 0.f;
    for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
      const float vn = vis_acc[n];
      for (int k = 0; k < P2; ++k) {
        const float* Jk = a.J + ((size_t)n * P2 + k) * 6;
        const float wv = w_acc[(size_t)n * P2 + k] * vn;
        const float rv = r_acc[(size_t)n * P2 + k];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float jw = Jk[i] * wv;
          hg[21 + i] += jw * rv;
#pragma unroll
          for (int j = 0; j <= i; ++j) hg[i * (i + 1) / 2 + j] += jw * Jk[j];
        }
      }
    }
    block_sum<27>(hg, sm);
    float H[21], g[6];
    for (int i = 0; i < 21; ++i) H[i] = hg[i];
    for (int i = 0; i < 6; ++i) g[i] = hg[21 + i];
    float diag_max = H[0];
    for (int i = 1; i < 6; ++i) diag_max = fmaxf(diag_max, fabsf(H[i * (i + 1) / 2 + i]));
    const float lam_eff = (it == 0) ? lam * diag_max : lam;
    for (int i = 0; i < 6; ++i) H[i * (i + 1) / 2 + i] += lam_eff;
    float dx[6];
    const bool okc = chol6_solve(H, g, dx);
    float mdx[6];
    for (int i = 0; i < 6; ++i) {
      if (!okc) dx[i] = 0.f;
      mdx[i] = -dx[i];
    }
    float dR[9], dt[3], R_new[9], t_new[3];
    se3_exp(mdx, dR, dt);
    mat3_mul(R, dR, R_new);
    for (int i = 0; i < 3; ++i)
      t_new[i] = R[3 * i] * dt[0] + R[3 * i + 1] * dt[1] + R[3 * i + 2] * dt[2] + t[i];

    for (int n = threadIdx.x; n < a.N; n += blockDim.x)
      vis_new[n] = lm_residuals(a, n, R_new, t_new, r_new + (size_t)n * P2);
    const float chi_n = lm_weights(a, r_new, vis_new, w_new, sm);

    float pred = 0.f, step2 = 0.f;
    for (int i = 0; i < 6; ++i) {
      pred += dx[i] * (lam_eff * dx[i] + g[i]);
      step2 += dx[i] * dx[i];
    }
    const float rho = (chi - chi_n) / fmaxf(pred, 1e-30f);
    const bool success = (chi - chi_n) > 0.f;
    const float lam_next = nielsen_lambda(success, lam_eff, rho, nu);
    const float nu_next = success ? 2.f : nu * 2.f;
    const bool small = step2 < 1e-16f;
    const float rel_dec = (chi - chi_n) / fmaxf(chi, 1e-30f);
    const float rel_pred = pred / fmaxf(chi, 1e-30f);
    done = small || !okc || (success && rel_dec < min_rel_decrease) ||
           (rel_pred < 0.1f * min_rel_decrease);
    const bool accept = success && !small;
    if (accept) {
      for (int i = 0; i < 9; ++i) R[i] = R_new[i];
      for (int i = 0; i < 3; ++i) t[i] = t_new[i];
      chi = chi_n;
      for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
        vis_acc[n] = vis_new[n];
        for (int k = 0; k < P2; ++k) {
          r_acc[(size_t)n * P2 + k] = r_new[(size_t)n * P2 + k];
          w_acc[(size_t)n * P2 + k] = w_new[(size_t)n * P2 + k];
        }
      }
    }
    lam = lam_next;
    nu = nu_next;
    ++it;
  }
  float nv[1] = {0.f};
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) nv[0] += vis_acc[n] * (float)P2;
  block_sum<1>(nv, sm);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) out_pose[4 * i + j] = R[3 * i + j];
      out_pose[4 * i + 3] = t[i];
    }
    out_stats[0] = chi;
    out_stats[1] = fmaxf(nv[0], 1.f);
    out_stats[2] = (float)it;
    out_stats[3] = 0.f;
  }
}

}  // namespace
}  // namespace sdvo

extern "C" int sdvo_lm_align_level(const float* pose_in, const float* windows, const float* patches,
                                   const float* J, const float* pts, const float* org,
                                   const float* vis, float fx, float fy, float cx, float cy,
                                   float* out_pose, float* out_stats, float* scratch, int N,
                                   int WH, int WW, int patch, int max_iters,
                                   float min_rel_decrease, void* stream) {
  sdvo::LmArgs a{windows, patches, J, pts, org, vis, fx, fy, cx, cy, N, WH, WW, patch};
  sdvo::lm_align_level_kernel<<<1, sdvo::kLmThreads, 0, (cudaStream_t)stream>>>(
      a, pose_in, out_pose, out_stats, scratch, max_iters, min_rel_decrease);
  return (int)cudaGetLastError();
}
