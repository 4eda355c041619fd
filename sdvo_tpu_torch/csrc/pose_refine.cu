// K3 — pose-only LM on unit-bearing residuals (the per-frame pose polish).
//
// Replaces sdvo_tpu/ops/pallas_pose.py::pose_refine (body _pose_kernel):
// residuals f(Tp) − b, three per observation; Jacobian (I − ffᵀ)/|p|·[I | −p̂];
// one global Tukey scale from the binned MAD over all three residual columns;
// Nielsen-damped 6×6 Cholesky; the left update T <- exp(−dx)∘T; accept on a
// chi² decrease; the relative-decrease exit.
//
// What bounds it on an H100: one thread block on one SM of 132 holds all
// observations (150 on the main path, 450 residuals). Each iteration is two
// robust-scale evaluations of four 16-bin count stages plus the H/g
// reduction — a chain of ~14 dependent block reductions over a few hundred
// values, so it is latency-bound. Residuals are recomputed from the pose in
// each pass (twelve flops per observation) instead of being stored, so the
// kernel needs no scratch memory at all.
#include "common.cuh"

namespace sdvo {
namespace {

constexpr int kPoseThreads = 256;

struct PoseArgs {
  const float* pts;  // (N, 3) world points
  const float* brg;  // (N, 3) unit bearings
  const float* vis;  // (N,)
  int N;
};

struct PoseObs {
  float r[3], f[3], p[3], inv_n, vis;
};

__device__ PoseObs pose_obs(const PoseArgs& a, int n, const float (&R)[9], const float (&t)[3]) {
  PoseObs o;
  const float X = a.pts[3 * n], Y = a.pts[3 * n + 1], Z = a.pts[3 * n + 2];
  o.p[0] = X * R[0] + Y * R[1] + Z * R[2] + t[0];
  o.p[1] = X * R[3] + Y * R[4] + Z * R[5] + t[1];
  o.p[2] = X * R[6] + Y * R[7] + Z * R[8] + t[2];
  const float nrm = sqrtf(fmaxf(o.p[0] * o.p[0] + o.p[1] * o.p[1] + o.p[2] * o.p[2], 1e-24f));
  o.inv_n = 1.f / nrm;
  o.vis = a.vis[n];
  for (int i = 0; i < 3; ++i) {
    o.f[i] = o.p[i] / nrm;
    o.r[i] = (o.f[i] - a.brg[3 * n + i]) * o.vis;
  }
  return o;
}

__device__ float pose_bin_median(const PoseArgs& a, const float (&R)[9], const float (&t)[3],
                                 bool dev, float center, float lo, float hi, float half_n,
                                 float* sm) {
  float med = hi;
  for (int stage = 0; stage < 2; ++stage) {
    float thr[kMadBins];
    bin_thresholds(lo, hi, thr);
    float cnt[kMadBins];
#pragma unroll
    for (int b = 0; b < kMadBins; ++b) cnt[b] = 0.f;
    for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
      const PoseObs o = pose_obs(a, n, R, t);
      if (o.vis < 0.5f) continue;
      for (int i = 0; i < 3; ++i) {
        const float x = dev ? fabsf(o.r[i] - center) : o.r[i];
#pragma unroll
        for (int b = 0; b < kMadBins; ++b) cnt[b] += (x <= thr[b]) ? 1.f : 0.f;
      }
    }
    block_sum<kMadBins>(cnt, sm);
    bin_median_stage(cnt, half_n, lo, hi, med);
  }
  return med;
}

// Tukey cutoff c of the residuals at (R, t) and their chi².
__device__ void pose_scale(const PoseArgs& a, const float (&R)[9], const float (&t)[3],
                           float* sm, float& c, float& chi) {
  float lo = kBig, hi = -kBig, nv[1] = {0.f};
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const PoseObs o = pose_obs(a, n, R, t);
    nv[0] += o.vis * 3.f;
    if (o.vis < 0.5f) continue;
    for (int i = 0; i < 3; ++i) {
      lo = fminf(lo, o.r[i]);
      hi = fmaxf(hi, o.r[i]);
    }
  }
  block_sum<1>(nv, sm);
  lo = block_min(lo, sm);
  hi = block_max(hi, sm);
  const float half_n = 0.5f * fmaxf(nv[0], 1.f);
  const float med = pose_bin_median(a, R, t, false, 0.f, lo, hi, half_n, sm);
  float hi2 = 0.f;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const PoseObs o = pose_obs(a, n, R, t);
    if (o.vis < 0.5f) continue;
    for (int i = 0; i < 3; ++i) hi2 = fmaxf(hi2, fabsf(o.r[i] - med));
  }
  hi2 = block_max(hi2, sm);
  const float mad = pose_bin_median(a, R, t, true, med, 0.f, hi2, half_n, sm);
  c = 4.6851f * fmaxf(1.4826f * mad, 1e-12f);
  float ch[1] = {0.f};
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const PoseObs o = pose_obs(a, n, R, t);
    for (int i = 0; i < 3; ++i) {
      const float rv = o.r[i];
      float w = 1.f - (rv * rv) / (c * c);
      w = (fabsf(rv) <= c) ? w * w * o.vis : 0.f;
      ch[0] += w * rv * rv;
    }
  }
  block_sum<1>(ch, sm);
  chi = ch[0];
}

__global__ void __launch_bounds__(kPoseThreads) pose_refine_kernel(
    PoseArgs a, const float* __restrict__ pose_in, float* __restrict__ out_pose,
    float* __restrict__ out_stats, int max_iters, float min_rel_decrease) {
  __shared__ float sm[32 * 27];
  float R[9], t[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[3 * i + j] = pose_in[4 * i + j];
    t[i] = pose_in[4 * i + 3];
  }
  float chi, c;
  pose_scale(a, R, t, sm, c, chi);
  float lam = 1e-2f, nu = 2.f;
  int it = 0;
  bool done = false;
  while (it < max_iters && !done) {
    float chi_cur;  // equals chi: the accepted pose's own scale evaluation
    pose_scale(a, R, t, sm, c, chi_cur);
    float hg[27];
#pragma unroll
    for (int i = 0; i < 27; ++i) hg[i] = 0.f;
    for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
      const PoseObs o = pose_obs(a, n, R, t);
      // Q = −hat(p)
      const float Q[3][3] = {{0.f, o.p[2], -o.p[1]}, {-o.p[2], 0.f, o.p[0]}, {o.p[1], -o.p[0], 0.f}};
      for (int i = 0; i < 3; ++i) {
        const float rv = o.r[i];
        float w = 1.f - (rv * rv) / (c * c);
        w = (fabsf(rv) <= c) ? w * w * o.vis : 0.f;
        float Jrow[6];
        float dfdp[3];
        for (int j = 0; j < 3; ++j) dfdp[j] = ((i == j ? 1.f : 0.f) - o.f[i] * o.f[j]) * o.inv_n;
        for (int j = 0; j < 3; ++j) Jrow[j] = dfdp[j];
        for (int k = 0; k < 3; ++k)
          Jrow[3 + k] = dfdp[0] * Q[0][k] + dfdp[1] * Q[1][k] + dfdp[2] * Q[2][k];
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          const float jw = w * Jrow[p];
          hg[21 + p] += jw * rv;
#pragma unroll
          for (int q = 0; q <= p; ++q) hg[p * (p + 1) / 2 + q] += jw * Jrow[q];
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
    float dx[6], mdx[6];
    const bool okc = chol6_solve(H, g, dx);
    for (int i = 0; i < 6; ++i) {
      if (!okc) dx[i] = 0.f;
      mdx[i] = -dx[i];
    }
    float dR[9], dt[3], R_new[9], t_new[3];
    se3_exp(mdx, dR, dt);
    mat3_mul(dR, R, R_new);
    for (int i = 0; i < 3; ++i)
      t_new[i] = dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2] + dt[i];
    float c_n, chi_n;
    pose_scale(a, R_new, t_new, sm, c_n, chi_n);
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
    if (success && !small) {
      for (int i = 0; i < 9; ++i) R[i] = R_new[i];
      for (int i = 0; i < 3; ++i) t[i] = t_new[i];
      chi = chi_n;
    }
    lam = lam_next;
    nu = nu_next;
    ++it;
  }
  float nv[1] = {0.f};
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) nv[0] += a.vis[n] * 3.f;
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

extern "C" int sdvo_pose_refine(const float* pose_in, const float* pts, const float* brg,
                                const float* vis, float* out_pose, float* out_stats, int N,
                                int max_iters, float min_rel_decrease, void* stream) {
  sdvo::PoseArgs a{pts, brg, vis, N};
  sdvo::pose_refine_kernel<<<1, sdvo::kPoseThreads, 0, (cudaStream_t)stream>>>(
      a, pose_in, out_pose, out_stats, max_iters, min_rel_decrease);
  return (int)cudaGetLastError();
}
