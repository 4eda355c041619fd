// K4 — depth-filter epipolar scoring: ZSSD of a bilinear patch per
// (filter, step) row.
//
// Replaces sdvo_tpu/ops/pallas_depth.py::depth_scores (body
// _depth_score_kernel): sample a P×P patch from the row's window at its
// sub-pixel offset, subtract the patch mean, and sum |· − cref| against the
// zero-mean warped reference patch of the row's filter (row r reads cref row
// r / steps: the reference patch is taken once a filter, not repeated per
// step as the TPU's row blocks wanted it); ok = the value-sampler support
// rule. A tap outside the window contributes 0.
//
// What bounds it on an H100: bytes, 4.16 MB at the main path's 512 × 16 rows
// (the 32-byte sectors the 8×8 bilinear footprints touch, cref once a
// filter, the offsets and the two outputs), 1.24 µs at 3.35 TB/s. What holds
// it back is latency: a footprint's address depends on its row's offsets,
// so every row waits for two dependent loads after the launch. The design
// puts every load of a warp in flight before any arithmetic:
//   1. a warp takes kRows = 4 consecutive rows; their offsets arrive in one
//      coalesced load, and each lane's cref values are loaded before them
//      (their addresses do not depend on the offsets);
//   2. each row's footprint — P + 1 window rows of the two 32-byte sectors
//      that hold its P + 1 columns — is copied into shared memory with one
//      16-byte cp.async a lane (the 32 lanes cover a row's 8 × 4 chunks;
//      zero-filled where the footprint leaves the window, so outside taps
//      read 0; the second sector is skipped where no column needs it);
//   3. each row is finished by 8 lanes, one a patch row: horizontal lerps of
//      two footprint rows from shared memory, the vertical lerp, the patch
//      mean and the ZSSD by xor-shuffle sums within the row's lanes.
// Four rows a warp was the fastest of 1, 2, 4, 8 and 16 rows a warp, of
// per-lane copies and of register-only sampling at both the main shape and
// eight problems in one launch (PERF.md, §6).
// The gather that builds the windows stays in PyTorch
// (sdvo_tpu_torch.ops.window_sampler).
#include "common.cuh"

namespace sdvo {
namespace {

constexpr int kMaxPatch = 7;                       // footprint P + 1 ≤ 8 rows and columns
constexpr int kFootRows = kMaxPatch + 1;
constexpr int kSpan = 16;                          // two 32-byte sectors of a footprint row
constexpr int kRowStride = kFootRows * kSpan + 4;  // floats a row in shared memory (+4: banks)
constexpr int kRows = 4;                           // rows a warp
constexpr int kLanes = 32 / kRows;                 // lanes a row: one a patch row
constexpr int kWarps = 4;                          // warps a block

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__global__ void __launch_bounds__(32 * kWarps)
    depth_scores_kernel(const float* __restrict__ win, const float* __restrict__ cref,
                        const float* __restrict__ offs, float* __restrict__ score,
                        float* __restrict__ ok_out, int R, int WH, int WW, int patch, int steps) {
  __shared__ __align__(16) float foot[kWarps][kRows][kRowStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * kWarps + warp) * kRows;
  if (row0 >= R) return;  // warp-uniform
  const int P2 = patch * patch, half = patch / 2;

  // this lane's row and patch row py, and the row's cref values of it
  const int my = lane / kLanes, py = lane % kLanes;
  const int row = row0 + my;
  const bool live = row < R && py < patch;
  float cr[kMaxPatch];
  {
    const float* c = cref + (size_t)(live ? row / steps : 0) * P2 + (live ? py * patch : 0);
#pragma unroll
    for (int i = 0; i < kMaxPatch; ++i) cr[i] = (live && i < patch) ? c[i] : 0.f;
  }
  // the warp's offsets: x, y of row row0 + k in lanes 2k, 2k + 1
  const float o = (lane < 2 * kRows && 2 * row0 + lane < 2 * R) ? offs[2 * row0 + lane] : 0.f;

  // every row's footprint into shared memory: lane (fr, q) copies the q-th
  // 16 bytes of the two sectors that hold footprint row fr
  {
    const int fr = lane >> 2, q = lane & 3;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const float ox = __shfl_sync(kFullMask, o, 2 * k), oy = __shfl_sync(kFullMask, o, 2 * k + 1);
      const int ix = (int)floorf(ox - (float)half), iy = (int)floorf(oy - (float)half);
      const int a8 = ix & ~7;  // the first sector's column (floor to a multiple of 8)
      const int h = iy + fr, c = a8 + 4 * q;
      const bool valid = (row0 + k < R) && fr <= patch && h >= 0 && h < WH && c >= 0 &&
                         c + 4 <= WW && (q < 2 || ix - a8 + patch >= 8);
      const float* src = valid ? win + ((size_t)(row0 + k) * WH + h) * WW + c : win;
      cp_async16_zfill(&foot[warp][k][fr * kSpan + 4 * q], src, valid);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  const float ox = __shfl_sync(kFullMask, o, 2 * my), oy = __shfl_sync(kFullMask, o, 2 * my + 1);
  const float x0 = ox - (float)half, y0 = oy - (float)half;
  const float xf = floorf(x0), yf = floorf(y0);
  const int s = (int)xf - ((int)xf & ~7);
  const float ax = x0 - xf, ay = y0 - yf;
  const float wx0 = 1.f - ax, wy0 = 1.f - ay;
  // horizontal lerps of footprint rows py and py + 1, then the vertical lerp
  const float* F = foot[warp][my] + min(py, kFootRows - 2) * kSpan + s;
  float hz[2][kMaxPatch];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float t[kFootRows];
#pragma unroll
    for (int i = 0; i < kFootRows; ++i) t[i] = F[j * kSpan + i];
#pragma unroll
    for (int i = 0; i < kMaxPatch; ++i) hz[j][i] = wx0 * t[i] + ax * t[i + 1];
  }
  float v[kMaxPatch];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPatch; ++i) {
    v[i] = wy0 * hz[0][i] + ay * hz[1][i];
    if (live && i < patch) sum += v[i];
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFullMask, sum, off);
  const float mean_v = sum / (float)P2;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPatch; ++i)
    if (live && i < patch) acc += fabsf((v[i] - mean_v) - cr[i]);
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  if (row < R && py == 0) {
    score[row] = acc;
    ok_out[row] = patch_support_ok(x0, y0, patch, WH, WW) ? 1.f : 0.f;
  }
}

}  // namespace
}  // namespace sdvo

extern "C" int sdvo_depth_scores(const float* windows, const float* cref, const float* offs,
                                 float* score, float* ok, int R, int WH, int WW, int patch, int steps,
                                 void* stream) {
  if (patch < 1 || patch > sdvo::kMaxPatch || WW % 4 != 0 || steps < 1 ||
      ((uintptr_t)windows & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int per_block = sdvo::kRows * sdvo::kWarps;
  const int blocks = (R + per_block - 1) / per_block;
  if (blocks > 0)
    sdvo::depth_scores_kernel<<<blocks, 32 * sdvo::kWarps, 0, (cudaStream_t)stream>>>(
        windows, cref, offs, score, ok, R, WH, WW, patch, steps);
  return (int)cudaGetLastError();
}
