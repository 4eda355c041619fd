// K1 — one pyramid level of inverse-compositional photometric LM.
//
// Replaces sdvo_tpu/ops/pallas_lm.py::lm_align_level (body _lm_level_kernel).
// Semantics are the Pallas kernel's: windows sampled bilinearly with the
// value-sampler support rule, Tukey weights with sigma = 1.4826·MAD from the
// 16-bin two-stage binned median, Nielsen-damped 6×6 Cholesky, the right
// update T <- T∘exp(−dx), accept on a chi² decrease, and the relative-decrease
// exit.
//
// What bounds it on an H100: neither bytes nor operations. A level moves
// ~0.7 MB and does 7–15 MFLOP (a fraction of a microsecond of either), but
// the LM loop is a serial chain: per iteration one H/g reduction and the
// seven reductions of the candidate's robust scale, each depending on the one
// before, so the whole level is one thread block on one SM of 132 and its
// time is the chain's latency plus the instructions each link costs. Of an
// iteration at 256 features (~46,000 cycles by thread 0's clock64(); PERF.md
// has the table) the four median stages are ~37 % (counting into bins 26,
// deciding 11), sampling the windows with the count/min/max that waits on it
// ~25 % (scattered taps: a warp's load touches ~7 window rows, 7 cache
// lines), H/g ~20 % (J at a 24-byte lane stride: 18 cache lines a warp and
// slot), the Cholesky and exp in warp 0 ~8 %, chi² ~6 %.
//
// What the design does about it (the shared parts are in lm_block.cuh):
//  * One residual per thread-slot: residual e = feature·P² + pixel belongs to
//    thread e mod T, slot e / T, for the whole solve (T = 1024; 512 threads
//    of 14 slots measured ~9 % slower). With N·P² <= 7168 (the main path has
//    256·25 = 6400) a thread keeps its residuals of the accepted and of the
//    candidate pose in registers, with each slot's place and reference pixel;
//    accepting a step is a register move. There is no scratch buffer in
//    device memory.
//  * J and the windows are read where they lie, through the read-only path:
//    neighbouring threads read neighbouring residuals, so J (24 bytes a
//    residual, the bulk of the traffic) comes in coalesced, once an
//    iteration, and the ~0.7 MB working set stays in L1/L2. The features'
//    points, origins and flags (24 bytes each) are copied to shared memory
//    once.
//  * An evaluation projects each feature once (one thread a feature, into
//    shared memory: per residual it cost a third more), then runs in three
//    sweeps over a thread's slots — where to sample, the four taps, the
//    residual — in straight-line code, so that the loads of all slots are in
//    flight together.
//  * An invisible feature's residuals are 0 and leave the statistics, as in
//    the Pallas kernel.
//  * Larger problems (N·P² > 7168) take the same code with the residuals
//    recomputed from the pose in each pass instead of kept (Resid<0>).
//  * S problems (one per sequence of the multi-sequence path) are one
//    launch of S blocks: block b reads problem b's pose, windows and tables
//    at b times each one's size and writes its own pose and statistics. The
//    blocks are independent, so up to 132 solve at once, one an SM; one
//    problem is the launch of one block, the same code.
//  * Not a thread block cluster with the windows in distributed shared
//    memory: on an H100 a reduction round across a cluster of four blocks
//    measured 2,242 cycles against 677 in one block of 1024 threads (the two
//    barriers alone 1,756 against 282; tools/cluster_sync_cost.cu). With
//    eight rounds an iteration that adds ~12,500 cycles to 46,000, and
//    sampling, which the cluster would speed up, is ~11,500 of them.
#include "lm_block.cuh"

namespace sdvo {
namespace {

constexpr int kLmSlotsTotal = 7168;  // residuals a block keeps in registers

struct LmArgs {
  const float* win;      // (N, WH, WW)
  const float* patches;  // (N, P2)
  const float* J;        // (N, P2, 6)
  const float* pts;      // (N, 3)
  const float* org;      // (N, 2)
  const float* vis_in;   // (N,)
  const float* feat;     // (N, 6): point, origin, visible — the block's copy
  float* spot;           // (N, 3): x0, y0, visible at the pose being evaluated
  float fx, fy, cx, cy;
  int N, WH, WW, patch;
};

// A residual's place, packed: feature << 6 | patch row << 3 | patch column
// (patch <= 7, N < 2^26); kNoResidual past the end.
constexpr uint32_t kNoResidual = 0xffffffffu;
__device__ __forceinline__ uint32_t lm_place(const LmArgs& a, int e) {
  const int P2 = a.patch * a.patch;
  if (e >= a.N * P2) return kNoResidual;
  const int n = e / P2, k = e - n * P2, p = k / a.patch;
  return ((uint32_t)n << 6) | ((uint32_t)p << 3) | (uint32_t)(k - p * a.patch);
}

// Where feature n's patch lies in its window at pose (R, t): the position of
// its top-left pixel (x0, y0) and whether the feature is visible there.
struct LmSpot {
  float x0, y0;
  bool ok;
};
__device__ __forceinline__ LmSpot lm_project(const LmArgs& a, int n, const float (&R)[9],
                                             const float (&t)[3]) {
  const float* f = a.feat + 6 * n;
  const float X = f[0], Y = f[1], Z = f[2];
  const float px = X * R[0] + Y * R[1] + Z * R[2] + t[0];
  const float py = X * R[3] + Y * R[4] + Z * R[5] + t[1];
  const float pz = X * R[6] + Y * R[7] + Z * R[8] + t[2];
  const bool front = pz > 1e-6f;
  const float zs = front ? pz : 1.f;
  const float u = a.fx * px / zs + a.cx - f[3];
  const float v = a.fy * py / zs + a.cy - f[4];
  const int half = a.patch / 2;
  LmSpot spot;
  spot.x0 = u - half;
  spot.y0 = v - half;
  spot.ok = f[5] > 0.5f && front && patch_support_ok(spot.x0, spot.y0, a.patch, a.WH, a.WW);
  return spot;
}

// Where the residual at `place` samples its window, given its feature's spot:
// the offset of the top-left tap and the two fractions; returns whether it is
// a visible residual (a safe offset when it is not). Straight-line code, like
// lm_sample: every load is started whatever the visibility, so that the loads
// of a thread's slots overlap instead of queueing behind each other's
// branches.
struct LmTap {
  size_t off;
  float ax, ay;
};
__device__ __forceinline__ bool lm_tap(const LmArgs& a, uint32_t place, const LmSpot& spot,
                                       LmTap& tap) {
  const bool ok = place != kNoResidual && spot.ok;
  const int n = ok ? (int)(place >> 6) : 0, p = (place >> 3) & 7, q = place & 7;
  // the support rule puts all four taps inside the window
  const float x = spot.x0 + q, y = spot.y0 + p;
  const float xf = floorf(x), yf = floorf(y);
  tap.ax = x - xf;
  tap.ay = y - yf;
  const int ix = ok ? (int)xf : 0, iy = ok ? (int)yf : 0;
  tap.off = ((size_t)n * a.WH + iy) * a.WW + ix;
  return ok;
}
__device__ __forceinline__ float lm_sample(const LmArgs& a, const LmTap& tap) {
  const float* w = a.win + tap.off;
  const float row0 = (1.f - tap.ax) * __ldg(w) + tap.ax * __ldg(w + 1);
  const float row1 = (1.f - tap.ax) * __ldg(w + a.WW) + tap.ax * __ldg(w + a.WW + 1);
  return (1.f - tap.ay) * row0 + tap.ay * row1;
}
// residual e at pose (R, t) -> r (0 when its feature is not visible there)
__device__ __forceinline__ bool lm_residual(const LmArgs& a, int e, uint32_t place,
                                            const float (&R)[9], const float (&t)[3], float& r) {
  const bool in = place != kNoResidual;
  const float ref = __ldg(a.patches + (in ? e : 0));
  LmTap tap;
  const bool ok = lm_tap(a, place, lm_project(a, in ? (int)(place >> 6) : 0, R, t), tap);
  r = ok ? lm_sample(a, tap) - ref : 0.f;
  return ok;
}

// kThreads·S residuals in registers (S > 0), or any number recomputed (S = 0).
template <int kThreads, int S>
struct LmResid {
  static constexpr int kSlots = S;
  float r[S];
  uint32_t vis;  // bit s: slot s is a visible residual
  __device__ bool get(int s, float& x) const {
    x = r[s];
    return (vis >> s) & 1u;
  }
};
template <int kThreads>
struct LmResid<kThreads, 0> {
  static constexpr int kSlots = 0;
  const LmArgs* a;
  float R[9], t[3];
  __device__ int slots() const {
    return (a->N * a->patch * a->patch + kThreads - 1) / kThreads;
  }
  __device__ bool get(int s, float& x) const {
    const int e = s * kThreads + (int)threadIdx.x;
    return lm_residual(*a, e, lm_place(*a, e), R, t, x);
  }
};

template <int kThreads, int S>
struct LmProblem {
  using Resid = LmResid<kThreads, S>;
  static constexpr bool kLeftUpdate = false;
  const LmArgs& a;
  // of this thread's residuals, which never move: place and reference value
  uint32_t place[S > 0 ? S : 1];
  float ref[S > 0 ? S : 1];

  __device__ explicit LmProblem(const LmArgs& args) : a(args) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = s * kThreads + (int)threadIdx.x;
      place[s] = lm_place(a, e);
      ref[s] = __ldg(a.patches + (place[s] != kNoResidual ? e : 0));
    }
  }

  __device__ void evaluate(const float (&R)[9], const float (&t)[3], Resid& out) const {
    if constexpr (S > 0) {
      // each feature is projected once, by one thread, into shared memory;
      // then three sweeps over this thread's slots, so that each sweep's
      // loads are in flight together: where to sample, the four taps, the
      // residual
      for (int n = threadIdx.x; n < a.N; n += kThreads) {
        const LmSpot spot = lm_project(a, n, R, t);
        a.spot[3 * n] = spot.x0;
        a.spot[3 * n + 1] = spot.y0;
        a.spot[3 * n + 2] = spot.ok ? 1.f : 0.f;
      }
      __syncthreads();
      LmTap tap[S];
      out.vis = 0u;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float* sp = a.spot + 3 * (place[s] != kNoResidual ? place[s] >> 6 : 0u);
        const LmSpot spot{sp[0], sp[1], sp[2] > 0.5f};
        out.vis |= (uint32_t)lm_tap(a, place[s], spot, tap[s]) << s;
      }
      float val[S];
#pragma unroll
      for (int s = 0; s < S; ++s) val[s] = lm_sample(a, tap[s]);
#pragma unroll
      for (int s = 0; s < S; ++s) out.r[s] = ((out.vis >> s) & 1u) ? val[s] - ref[s] : 0.f;
    } else {
      out.a = &a;
      for (int i = 0; i < 9; ++i) out.R[i] = R[i];
      for (int i = 0; i < 3; ++i) out.t[i] = t[i];
    }
  }

  // H = JᵀWJ (lower triangle) and g = JᵀWr over this thread's residuals
  __device__ void normal_equations(const Resid& acc, const float (&)[9], const float (&)[3],
                                   float c, float (&hg)[32]) const {
    for_each_slot(acc, [&](int s) {
      float rv;
      const bool vis = acc.get(s, rv);
      const float wv = vis ? tukey_weight(rv, c) : 0.f;
      const size_t e = vis ? (size_t)(s * kThreads + (int)threadIdx.x) : 0;  // a safe row
      const float2* Jp = reinterpret_cast<const float2*>(a.J + e * 6);
      const float2 j01 = __ldg(Jp), j23 = __ldg(Jp + 1), j45 = __ldg(Jp + 2);
      const float Jk[6] = {j01.x, j01.y, j23.x, j23.y, j45.x, j45.y};
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float jw = Jk[i] * wv;
        hg[21 + i] += jw * rv;
#pragma unroll
        for (int j = 0; j <= i; ++j) hg[i * (i + 1) / 2 + j] += jw * Jk[j];
      }
    });
  }
};

template <int kWarps, int S>
__global__ void __launch_bounds__(kWarps * 32, 1) lm_align_level_kernel(
    LmArgs a, const float* __restrict__ pose_in, float* __restrict__ out_pose,
    float* __restrict__ out_stats, int max_iters, float min_rel_decrease, bool freeze_sigma) {
  __shared__ BlockShared<kWarps> sm;
  extern __shared__ float feat[];  // (N, 6), then (N, 3) of spots where S > 0
  const size_t problem = blockIdx.x;  // this block's problem of the launch
  const size_t P2 = (size_t)a.patch * a.patch;
  a.win += problem * a.N * a.WH * a.WW;
  a.patches += problem * a.N * P2;
  a.J += problem * a.N * P2 * 6;
  a.pts += problem * a.N * 3;
  a.org += problem * a.N * 2;
  a.vis_in += problem * a.N;
  pose_in += problem * 12;
  out_pose += problem * 12;
  out_stats += problem * 4;
  for (int n = threadIdx.x; n < a.N; n += kWarps * 32) {
    feat[6 * n] = a.pts[3 * n];
    feat[6 * n + 1] = a.pts[3 * n + 1];
    feat[6 * n + 2] = a.pts[3 * n + 2];
    feat[6 * n + 3] = a.org[2 * n];
    feat[6 * n + 4] = a.org[2 * n + 1];
    feat[6 * n + 5] = a.vis_in[n];
  }
  a.feat = feat;
  a.spot = feat + 6 * a.N;
  __syncthreads();
  Block<kWarps> blk(sm);
  const LmProblem<kWarps * 32, S> prob(a);
  lm_solve(prob, blk, pose_in, out_pose, out_stats, max_iters, min_rel_decrease, freeze_sigma);
}

constexpr int kLmMaxFeatures = 8192;      // 24 bytes each in shared memory
constexpr int kLmMaxFeaturesKept = 2048;  // and 12 more where the residuals are kept

template <int kWarps, int S>
int lm_launch_tier(const LmArgs& a, const float* pose_in, float* out_pose, float* out_stats,
                   int max_iters, float min_rel_decrease, bool freeze_sigma, int n_problems,
                   cudaStream_t stream) {
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      lm_align_level_kernel<kWarps, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLmMaxFeatures * 6 * (int)sizeof(float));
  if (opted_in != cudaSuccess) return (int)opted_in;
  lm_align_level_kernel<kWarps, S>
      <<<n_problems, kWarps * 32, a.N * (S > 0 ? 9 : 6) * sizeof(float), stream>>>(
          a, pose_in, out_pose, out_stats, max_iters, min_rel_decrease, freeze_sigma);
  return (int)cudaGetLastError();
}

constexpr int kLmWarps = 32;

int lm_launch(const LmArgs& a, const float* pose_in, float* out_pose, float* out_stats,
              int max_iters, float min_rel_decrease, bool freeze_sigma, int n_problems,
              cudaStream_t stream) {
  if (a.N > kLmMaxFeatures || n_problems < 1) return (int)cudaErrorInvalidValue;
  if ((long long)a.N * a.patch * a.patch <= kLmSlotsTotal && a.N <= kLmMaxFeaturesKept)
    return lm_launch_tier<kLmWarps, kLmSlotsTotal / (kLmWarps * 32)>(
        a, pose_in, out_pose, out_stats, max_iters, min_rel_decrease, freeze_sigma, n_problems,
        stream);
  return lm_launch_tier<kLmWarps, 0>(a, pose_in, out_pose, out_stats, max_iters,
                                     min_rel_decrease, freeze_sigma, n_problems, stream);
}

}  // namespace
}  // namespace sdvo

// n_problems problems of one shape, each array holding them one after the
// other (pose_in (S, 3, 4), windows (S, N, WH, WW), ..., out_stats (S, 4)).
// freeze_sigma != 0: the Tukey cutoff stays at its value at the entry pose.
extern "C" int sdvo_lm_align_level(const float* pose_in, const float* windows, const float* patches,
                                   const float* J, const float* pts, const float* org,
                                   const float* vis, float fx, float fy, float cx, float cy,
                                   float* out_pose, float* out_stats, int N, int WH, int WW,
                                   int patch, int max_iters, float min_rel_decrease,
                                   int freeze_sigma, int n_problems, void* stream) {
  const sdvo::LmArgs a{windows, patches, J,  pts, org, vis, nullptr, nullptr,
                       fx,      fy,      cx, cy,  N,   WH,  WW,      patch};
  return sdvo::lm_launch(a, pose_in, out_pose, out_stats, max_iters, min_rel_decrease,
                         freeze_sigma != 0, n_problems, (cudaStream_t)stream);
}
