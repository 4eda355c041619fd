// K4 — depth-filter epipolar scoring: ZSSD of a bilinear patch per
// (filter, step) row.
//
// Replaces sdvo_tpu/ops/pallas_depth.py::depth_scores (body
// _depth_score_kernel): sample a P×P patch from the row's window at its
// sub-pixel offset, subtract the patch mean, and sum |· − cref| against the
// zero-mean warped reference patch; ok = the value-sampler support rule.
//
// Layout: one warp per row, each lane sampling ceil(P²/32) patch pixels
// (two at P = 7). What bounds it on an H100: it is a streaming pass — 8192
// rows × (12·32 window + 49 reference + 2 offset) floats ≈ 14.3 MB read
// once — so its floor is the ~4 µs that 3.35 TB/s needs for those bytes; the
// 4 bilinear taps per pixel re-read the window through L1. The gather that
// builds the windows stays in PyTorch (sdvo_tpu_torch.ops.window_sampler).
#include "common.cuh"

namespace sdvo {
namespace {

constexpr int kDepthWarpsPerBlock = 8;

__global__ void depth_scores_kernel(const float* __restrict__ win, const float* __restrict__ cref,
                                    const float* __restrict__ offs, float* __restrict__ score,
                                    float* __restrict__ ok_out, int R, int WH, int WW, int patch) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kDepthWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // warp-uniform
  const int P2 = patch * patch, half = patch / 2;
  const float x0 = offs[2 * row] - half, y0 = offs[2 * row + 1] - half;
  const float* w = win + (size_t)row * WH * WW;
  const float* c = cref + (size_t)row * P2;
  float vals[2];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = lane + 32 * j;
    vals[j] = 0.f;
    if (k < P2) vals[j] = window_bilinear(w, WH, WW, x0 + (float)(k % patch), y0 + (float)(k / patch));
    s += vals[j];
  }
  const float mean_v = warp_sum(s) / (float)P2;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = lane + 32 * j;
    if (k < P2) acc += fabsf((vals[j] - mean_v) - c[k]);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    score[row] = acc;
    ok_out[row] = patch_support_ok(x0, y0, patch, WH, WW) ? 1.f : 0.f;
  }
}

}  // namespace
}  // namespace sdvo

extern "C" int sdvo_depth_scores(const float* windows, const float* cref, const float* offs,
                                 float* score, float* ok, int R, int WH, int WW, int patch,
                                 void* stream) {
  if (patch * patch > 64) return (int)cudaErrorInvalidValue;
  const int blocks = (R + sdvo::kDepthWarpsPerBlock - 1) / sdvo::kDepthWarpsPerBlock;
  if (blocks > 0)
    sdvo::depth_scores_kernel<<<blocks, 32 * sdvo::kDepthWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        windows, cref, offs, score, ok, R, WH, WW, patch);
  return (int)cudaGetLastError();
}
