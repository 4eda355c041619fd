// K2 — batched 2D + illumination feature alignment (N independent 3-parameter LMs).
//
// Replaces sdvo_tpu/ops/pallas_fa.py::fa_align_batch (body _fa_kernel): the
// illumination offset starts at minus the mean patch difference; per-feature
// Tukey weights from two 10-step range bisections (median, then MAD); a
// damped 3×3 cofactor solve with lam·diag_max on iteration 0 only; Nielsen
// update; a feature freezes once it stalls; converged = live, moved
// < 2·patch and final patch variance above the contrast threshold.
//
// Layout: one warp per feature, lane k holding patch pixel k (P² ≤ 32), no
// shared memory and no block synchronisation.
//
// What bounds it on an H100: neither bytes (0.5 MB at 150 features, 0.15 µs
// at the card's memory rate) nor operations (≈ 4 MFLOP), but the length of
// one warp's chain of dependent cross-lane steps: 150 warps are about one
// per SM, so nothing hides a step's latency. What the design does about it,
// each point leaving every output bit as the straightforward form gives it
// (one shuffle reduction per sum, count, minimum and maximum; two robust
// scales and nine H/g sums an iteration; always max_iters iterations):
//  - a bisection step's count is one vote (__ballot_sync + __popc), an exact
//    integer, not a five-step shuffle sum of 0/1 floats; visibility is
//    uniform over a feature, so the visible count is P² or 0 with no
//    reduction, and `count ≥ half` is `2·votes ≥ P²`;
//  - two bisection steps a round: the second step's vote is taken for both
//    outcomes of the first, so ten steps are five dependent rounds;
//  - minimum and maximum are one redux.sync each on the order-preserving
//    integer image of the float (common.cuh), and the largest deviation
//    from the median is taken from them (rounding is monotonic), not from a
//    third reduction;
//  - the robust scale is evaluated once per iteration: the weights of the
//    trial residuals, needed for chi², are carried through the accept and
//    are the next iteration's weights (as is the trial sample, which is the
//    epilogue's);
//  - chi² and the nine H/g sums of the trial weights go through one
//    interleaved butterfly; H and g are carried, the trial's on an accept,
//    the unchanged old ones on a reject;
//  - the loop is left at the stall, after which no output can change: a
//    warp's time is what its feature needs, the launch's the slowest
//    feature's.
#include "common.cuh"

namespace sdvo {
namespace {

constexpr int kFaWarpsPerBlock = 4;
constexpr int kBisectSteps = 10;  // sdvo_tpu/ops/pallas_fa.py::_BISECT_STEPS
static_assert(kBisectSteps % 2 == 0, "fa_bisect takes two steps a round");

struct FaArgs {
  const float* win;  // (N, WH, WW)
  const float* refp;  // (N, P2)
  const float* gx;
  const float* gy;
  const float* uv0;  // (N, 2)
  const float* org;  // (N, 2)
  const uint8_t* live;  // (N,) bool
  float* uv;  // (N, 2)
  float* rmse;  // (N,)
  uint8_t* conv;  // (N,) bool
  int N, WH, WW, patch, max_iters;
  float sigma_floor, contrast;
};

// whether at least half of the feature's P² visible pixels have x <= mid:
// one vote. `seen` is false on every lane of an invisible feature and on the
// lanes beyond P², so an invisible feature never reaches.
__device__ __forceinline__ bool fa_reach(float x, bool seen, float mid, int P2) {
  return 2 * __popc(__ballot_sync(kFullMask, seen && x <= mid)) >= P2;
}

// bisection median of the lanes' x among the seen lanes, two steps a round:
// the three votes of a round are at the midpoints the plain sequence forms
__device__ __forceinline__ float fa_bisect(float x, bool seen, float lo, float hi, int P2) {
#pragma unroll
  for (int s = 0; s < kBisectSteps / 2; ++s) {
    const float m1 = 0.5f * (lo + hi);
    const float m0 = 0.5f * (lo + m1), m2 = 0.5f * (m1 + hi);
    const bool r1 = fa_reach(x, seen, m1, P2);
    const bool r0 = fa_reach(x, seen, m0, P2);
    const bool r2 = fa_reach(x, seen, m2, P2);
    const float lo_n = r1 ? (r0 ? lo : m0) : (r2 ? m1 : m2);
    const float hi_n = r1 ? (r0 ? m0 : m1) : (r2 ? m2 : hi);
    lo = lo_n;
    hi = hi_n;
  }
  return 0.5f * (lo + hi);
}

// per-feature Tukey weight of this lane's residual (_pf_tukey); `visible` is
// the feature's, `seen` = visible and lane < P²
__device__ __forceinline__ float fa_tukey(float r, bool seen, bool visible, int P2,
                                          float sigma_floor) {
  float lo = warp_min(seen ? r : kBig);
  float hi = warp_max(seen ? r : -kBig);
  lo = visible ? lo : 0.f;
  hi = visible ? hi : 1.f;
  const float med = fa_bisect(r, seen, lo, hi, P2);
  const float dev = fabsf(r - med);
  // max of |r − med| over the seen lanes lies at the smallest or largest r
  const float hi2 = visible ? fmaxf(fabsf(lo - med), fabsf(hi - med)) : 0.f;
  const float mad = fa_bisect(dev, seen, 0.f, hi2, P2);
  const float c = 4.6851f * fmaxf(1.4826f * mad, sigma_floor);
  const float w = 1.f - (r * r) / (c * c);
  return (seen && fabsf(r) <= c) ? w * w : 0.f;
}

// the sums of n values at once, their butterflies interleaved step by step
template <int n>
__device__ __forceinline__ void warp_sum_n(float (&s)[n]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float t[n];
#pragma unroll
    for (int i = 0; i < n; ++i) t[i] = __shfl_xor_sync(kFullMask, s[i], off);
#pragma unroll
    for (int i = 0; i < n; ++i) s[i] += t[i];
  }
}

// s[0] = chi², s[1..6] = H00 H01 H02 H11 H12 H22, s[7..9] = g of weights w
// and residuals r
__device__ __forceinline__ void fa_sums(float w, float r, float gx, float gy, float (&s)[10]) {
  const float wgx = w * gx, wgy = w * gy;
  s[0] = r * r * w;
  s[1] = wgx * gx; s[2] = wgx * gy; s[3] = wgx; s[4] = wgy * gy; s[5] = wgy; s[6] = w;
  s[7] = wgx * r; s[8] = wgy * r; s[9] = w * r;
  warp_sum_n(s);
}

__global__ void fa_align_kernel(FaArgs a) {
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
  const bool live = a.live[n] != 0;
  const float dq = (float)(k % P), dp = (float)(k / P);

  // this lane's pixel of the patch centred at (u, v); *visible is the feature's
  auto sample = [&](float u, float v, bool* visible) {
    const float x0 = u - ox - half, y0 = v - oy - half;
    *visible = live && patch_support_ok(x0, y0, P, a.WH, a.WW);
    return window_bilinear(win, a.WH, a.WW, x0 + dq, y0 + dp);
  };

  float u = u0, v = v0;
  bool vis;
  float cur = sample(u, v, &vis);
  bool seen = vis && act;
  float o = -warp_sum(seen ? cur - ref : 0.f) / (vis ? (float)P2 : 1.f);
  float r = seen ? -(cur - ref + o) : 0.f;
  float hg[10];  // chi², H, g at the accepted (u, v, o)
  fa_sums(fa_tukey(r, seen, vis, P2, a.sigma_floor), r, gx, gy, hg);
  float lam = 1e-2f, nu = 2.f;
  bool stalled = !live;
  for (int it = 0; it < a.max_iters && !stalled; ++it) {
    const float chi = hg[0];
    const float H00 = hg[1], H01 = hg[2], H02 = hg[3], H11 = hg[4], H12 = hg[5], H22 = hg[6];
    const float g0 = hg[7], g1 = hg[8], g2 = hg[9];
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
    bool vis_n;
    const float cur_n = sample(un, vn, &vis_n);
    const bool seen_n = vis_n && act;
    const float r_n = seen_n ? -(cur_n - ref + on) : 0.f;
    float hg_n[10];
    fa_sums(fa_tukey(r_n, seen_n, vis_n, P2, a.sigma_floor), r_n, gx, gy, hg_n);
    const float chi_n = hg_n[0];
    const float pred = dx0 * (lam_eff * dx0 + g0) + dx1 * (lam_eff * dx1 + g1) +
                       dx2 * (lam_eff * dx2 + g2);
    const float rho = (chi - chi_n) / fmaxf(pred, 1e-30f);
    const bool success = (chi - chi_n) > 0.f;
    lam = nielsen_lambda(success, lam_eff, rho, nu);
    nu = success ? 2.f : nu * 2.f;
    const float chi_ref = fmaxf(chi, 1e-30f);
    const float rel_dec = (chi - chi_n) / chi_ref;
    const float rel_pred = pred / chi_ref;
    if (success) {  // not stalled: the loop has been left otherwise
      u = un; v = vn; o = on;
      cur = cur_n; r = r_n; vis = vis_n; seen = seen_n;
#pragma unroll
      for (int i = 0; i < 10; ++i) hg[i] = hg_n[i];
    }
    stalled = (success && rel_dec < 1e-3f) || (rel_pred < 1e-4f);
  }
  // cur and r are the sample and residual at the final (u, v, o)
  const float n_vis = vis ? (float)P2 : 1.f;
  float s2[2] = {r * r, seen ? cur : 0.f};
  warp_sum_n(s2);
  const float rmse = sqrtf(s2[0] / n_vis);
  const float mean_c = s2[1] / n_vis;
  const float var_c = warp_sum(seen ? (cur - mean_c) * (cur - mean_c) : 0.f) / n_vis;
  const float moved2 = (u - u0) * (u - u0) + (v - v0) * (v - v0);
  const bool conv = live && moved2 < (2.f * P) * (2.f * P) && var_c > a.contrast;
  if (lane == 0) {
    a.uv[2 * n] = u;
    a.uv[2 * n + 1] = v;
    a.rmse[n] = rmse;
    a.conv[n] = conv ? 1 : 0;
  }
}

}  // namespace
}  // namespace sdvo

extern "C" int sdvo_fa_align(const float* windows, const float* refp, const float* gx,
                             const float* gy, const float* uv0, const float* org,
                             const uint8_t* live, float* uv, float* rmse, uint8_t* conv, int N,
                             int WH, int WW, int patch, int max_iters, float sigma_floor,
                             float contrast, void* stream) {
  if (patch * patch > 32) return (int)cudaErrorInvalidValue;
  sdvo::FaArgs a{windows, refp, gx, gy, uv0, org, live, uv, rmse, conv, N, WH, WW, patch,
                 max_iters, sigma_floor, contrast};
  const int blocks = (N + sdvo::kFaWarpsPerBlock - 1) / sdvo::kFaWarpsPerBlock;
  if (blocks > 0)
    sdvo::fa_align_kernel<<<blocks, 32 * sdvo::kFaWarpsPerBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
