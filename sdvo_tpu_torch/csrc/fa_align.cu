// K2 — batched 2D + illumination feature alignment (N independent 3-parameter LMs).
//
// Replaces sdvo_tpu/ops/pallas_fa.py::fa_align_batch (body _fa_kernel): the
// illumination offset starts at minus the mean patch difference; per-feature
// Tukey weights from a 10-step bisection median; a damped 3×3 cofactor
// solve; 10 unrolled iterations in which a feature freezes once it stalls;
// converged = live, moved < 2·patch and final patch variance above the
// contrast threshold.
//
// Layout: one warp per feature, lane k holding patch pixel k (P² ≤ 32), so
// every per-feature sum is a warp shuffle reduction and no shared memory or
// block synchronisation is needed. What bounds it on an H100: 150 features
// give 150 warps — about one warp per SM of 132 — and each iteration is ~40
// dependent shuffle reductions (two bisection medians of ten steps each, two
// Tukey passes, the 3×3 normal equations): latency-bound, with each SM
// nearly idle. The window (24×32 floats = 3 KB per feature) is read through
// L1 by the 4 bilinear taps of each lane.
#include "common.cuh"

namespace sdvo {
namespace {

constexpr int kFaWarpsPerBlock = 4;
constexpr int kBisectSteps = 10;  // sdvo_tpu/ops/pallas_fa.py::_BISECT_STEPS

struct FaArgs {
  const float* win;  // (N, WH, WW)
  const float* refp;  // (N, P2)
  const float* gx;
  const float* gy;
  const float* uv0;  // (N, 2)
  const float* org;  // (N, 2)
  const float* live;  // (N,)
  int N, WH, WW, patch, max_iters;
  float sigma_floor, contrast;
};

// bisection median of the lanes' x among visible lanes (warp-uniform inputs)
__device__ float fa_bisect(float x, float vis, float lo, float hi, float half_n) {
  for (int s = 0; s < kBisectSteps; ++s) {
    const float mid = 0.5f * (lo + hi);
    const float cnt = warp_sum(x <= mid ? vis : 0.f);
    const bool reach = cnt >= half_n;
    lo = reach ? lo : mid;
    hi = reach ? mid : hi;
  }
  return 0.5f * (lo + hi);
}

// per-feature Tukey weight of this lane's residual (_pf_tukey)
__device__ float fa_tukey(float r, float vis, float sigma_floor) {
  const float cnt = warp_sum(vis);
  const float half_n = 0.5f * fmaxf(cnt, 1.f);
  float lo = warp_min(vis > 0.5f ? r : kBig);
  float hi = warp_max(vis > 0.5f ? r : -kBig);
  lo = cnt > 0.5f ? lo : 0.f;
  hi = cnt > 0.5f ? hi : 1.f;
  const float med = fa_bisect(r, vis, lo, hi, half_n);
  const float dev = fabsf(r - med);
  const float hi2 = warp_max(vis > 0.5f ? dev : 0.f);
  const float mad = fa_bisect(dev, vis, 0.f, hi2, half_n);
  const float c = 4.6851f * fmaxf(1.4826f * mad, sigma_floor);
  const float w = 1.f - (r * r) / (c * c);
  return (fabsf(r) <= c ? w * w : 0.f) * vis;
}

__global__ void fa_align_kernel(FaArgs a, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kFaWarpsPerBlock + (threadIdx.x >> 5);
  if (n >= a.N) return;  // warp-uniform
  const int P = a.patch, P2 = P * P, half = P / 2;
  const bool act = lane < P2;
  const int k = act ? lane : 0;
  const float* win = a.win + (size_t)n * a.WH * a.WW;
  const float ref = act ? a.refp[(size_t)n * P2 + k] : 0.f;
  const float gx = act ? a.gx[(size_t)n * P2 + k] : 0.f;
  const float gy = act ? a.gy[(size_t)n * P2 + k] : 0.f;
  const float u0 = a.uv0[2 * n], v0 = a.uv0[2 * n + 1];
  const float ox = a.org[2 * n], oy = a.org[2 * n + 1];
  const bool live = a.live[n] > 0.5f;
  const float dq = (float)(k % P), dp = (float)(k / P);
  const float lane_w = act ? 1.f : 0.f;

  // sample this lane's pixel of the patch centred at (u, v); *vis = feature visibility
  auto sample = [&](float u, float v, float* vis) {
    const float x0 = u - ox - half, y0 = v - oy - half;
    *vis = (live && patch_support_ok(x0, y0, P, a.WH, a.WW)) ? lane_w : 0.f;
    return window_bilinear(win, a.WH, a.WW, x0 + dq, y0 + dp);
  };

  float vis0;
  const float cur0 = sample(u0, v0, &vis0);
  const float cnt0 = fmaxf(warp_sum(vis0), 1.f);
  const float o0 = -warp_sum((cur0 - ref) * vis0) / cnt0;

  float u = u0, v = v0, o = o0;
  float vis;
  float r = -(sample(u, v, &vis) - ref + o) * vis;
  float chi = warp_sum(r * r * fa_tukey(r, vis, a.sigma_floor));
  float lam = 1e-2f, nu = 2.f;
  bool stalled = !live;
  for (int it = 0; it < a.max_iters; ++it) {
    const float w = fa_tukey(r, vis, a.sigma_floor);
    const float H00 = warp_sum(w * gx * gx), H01 = warp_sum(w * gx * gy), H02 = warp_sum(w * gx);
    const float H11 = warp_sum(w * gy * gy), H12 = warp_sum(w * gy), H22 = warp_sum(w);
    const float g0 = warp_sum(w * gx * r), g1 = warp_sum(w * gy * r), g2 = warp_sum(w * r);
    const float diag_max = fmaxf(fabsf(H00), fmaxf(fabsf(H11), fabsf(H22)));
    const float lam_eff = (it == 0) ? lam * diag_max : lam;
    // damped 3×3 cofactor solve (_solve3)
    const float A_ = H00 + lam_eff, B_ = H01, C_ = H02;
    const float E_ = H11 + lam_eff, F_ = H12, I_ = H22 + lam_eff;
    const float cA = E_ * I_ - F_ * F_;
    const float cB = -(B_ * I_ - F_ * C_);
    const float cC = B_ * F_ - E_ * C_;
    const float det = A_ * cA + B_ * cB + C_ * cC;
    const bool bad = fabsf(det) < 1e-12f;
    const float det_s = bad ? 1.f : det;
    const float cE = A_ * I_ - C_ * C_;
    const float cF = -(A_ * F_ - B_ * C_);
    const float cI = A_ * E_ - B_ * B_;
    const float dx0 = bad ? 0.f : (cA * g0 + cB * g1 + cC * g2) / det_s;
    const float dx1 = bad ? 0.f : (cB * g0 + cE * g1 + cF * g2) / det_s;
    const float dx2 = bad ? 0.f : (cC * g0 + cF * g1 + cI * g2) / det_s;
    const float un = u + dx0, vn = v + dx1, on = o + dx2;
    float vis_n;
    const float r_n = -(sample(un, vn, &vis_n) - ref + on) * vis_n;
    const float chi_n = warp_sum(r_n * r_n * fa_tukey(r_n, vis_n, a.sigma_floor));
    const float pred = dx0 * (lam_eff * dx0 + g0) + dx1 * (lam_eff * dx1 + g1) +
                       dx2 * (lam_eff * dx2 + g2);
    const float rho = (chi - chi_n) / fmaxf(pred, 1e-30f);
    const bool success = (chi - chi_n) > 0.f;
    lam = nielsen_lambda(success, lam_eff, rho, nu);
    nu = success ? 2.f : nu * 2.f;
    const float chi_ref = fmaxf(chi, 1e-30f);
    const float rel_dec = (chi - chi_n) / chi_ref;
    const float rel_pred = pred / chi_ref;
    if (success && !stalled) {
      u = un; v = vn; o = on; chi = chi_n; r = r_n; vis = vis_n;
    }
    stalled = stalled || (success && rel_dec < 1e-3f) || (rel_pred < 1e-4f);
  }
  float vis_f;
  const float cur_f = sample(u, v, &vis_f);
  const float r_f = -(cur_f - ref + o) * vis_f;
  const float n_vis = fmaxf(warp_sum(vis_f), 1.f);
  const float rmse = sqrtf(warp_sum(r_f * r_f) / n_vis);
  const float mean_c = warp_sum(cur_f * vis_f) / n_vis;
  const float var_c = warp_sum((cur_f - mean_c) * (cur_f - mean_c) * vis_f) / n_vis;
  const float moved2 = (u - u0) * (u - u0) + (v - v0) * (v - v0);
  const bool conv = live && moved2 < (2.f * P) * (2.f * P) && var_c > a.contrast;
  if (lane == 0) {
    out[4 * n] = u;
    out[4 * n + 1] = v;
    out[4 * n + 2] = rmse;
    out[4 * n + 3] = conv ? 1.f : 0.f;
  }
}

}  // namespace
}  // namespace sdvo

extern "C" int sdvo_fa_align(const float* windows, const float* refp, const float* gx,
                             const float* gy, const float* uv0, const float* org,
                             const float* live, float* out, int N, int WH, int WW, int patch,
                             int max_iters, float sigma_floor, float contrast, void* stream) {
  if (patch * patch > 32) return (int)cudaErrorInvalidValue;
  sdvo::FaArgs a{windows, refp, gx, gy, uv0, org, live, N, WH, WW, patch, max_iters,
                 sigma_floor, contrast};
  const int blocks = (N + sdvo::kFaWarpsPerBlock - 1) / sdvo::kFaWarpsPerBlock;
  if (blocks > 0)
    sdvo::fa_align_kernel<<<blocks, 32 * sdvo::kFaWarpsPerBlock, 0, (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}
