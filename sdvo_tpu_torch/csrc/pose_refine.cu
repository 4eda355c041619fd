// K3 — pose-only LM on unit-bearing residuals (the per-frame pose polish).
//
// Replaces sdvo_tpu/ops/pallas_pose.py::pose_refine (body _pose_kernel):
// residuals f(Tp) − b, three per observation; Jacobian (I − ffᵀ)/|p|·[I | −p̂];
// one global Tukey scale from the binned MAD over all three residual columns;
// Nielsen-damped 6×6 Cholesky; the left update T <- exp(−dx)∘T; accept on a
// chi² decrease; the relative-decrease exit.
//
// What bounds it on an H100: latency alone. The problem is 4.3 KB (150
// observations on the main path) and a few hundred kFLOP, nanoseconds of
// either; the time is the serial chain of an LM iteration — the H/g sum, the
// Cholesky and SE(3) exp, and the seven dependent reductions of the robust
// scale of the candidate pose.
//
// What the design does about it (the shared parts are in lm_block.cuh):
//  * The block is sized to the problem. Up to 160 observations run as five
//    warps, one observation (three residuals) a thread, so that a pass over
//    the residuals is a handful of instructions and the chain is the
//    reductions alone; the same in one warp at five observations a lane
//    (no block barrier at all, `__syncwarp` only) measured twice as slow,
//    because one warp runs its 15 values' passes one instruction at a
//    time. Larger problems take eight warps, four observations a thread.
//  * The accepted pose carries its scale c and chi²: an iteration evaluates
//    the robust scale once, for the candidate, not a second time for the
//    pose it already knows.
//  * A thread keeps an evaluation's residuals in registers for its seven
//    passes (count/min/max, four histogram stages, max deviation, chi²); the
//    observation's p, f and 1/|p| are formed once more for the H/g pass.
//  * The Cholesky, the SE(3) exp and each median stage's decision run in
//    warp 0 alone and are published through shared memory.
//  * Problems beyond the register tiers recompute the residual in each pass
//    (Resid<0>), so any N runs.
//  * S problems (one per sequence of the multi-sequence path) are one
//    launch of S blocks, block b on problem b's arrays; one problem is the
//    launch of one block.
#include "lm_block.cuh"

namespace sdvo {
namespace {

struct PoseArgs {
  const float* pts;  // (N, 3) world points
  const float* brg;  // (N, 3) unit bearings
  const float* vis;  // (N,)
  int N;
};

struct PoseObs {
  float r[3], f[3], p[3], inv_n;
};

// observation n at pose (R, t); false when n is out of range or not valid
// (the loads then come from observation 0 and r = 0: no branch)
__device__ __forceinline__ bool pose_obs(const PoseArgs& a, int n, const float (&R)[9],
                                         const float (&t)[3], PoseObs& o) {
  const bool in = n < a.N;
  n = in ? n : 0;
  const bool ok = in && __ldg(a.vis + n) > 0.5f;
  const float X = __ldg(a.pts + 3 * n), Y = __ldg(a.pts + 3 * n + 1), Z = __ldg(a.pts + 3 * n + 2);
  o.p[0] = X * R[0] + Y * R[1] + Z * R[2] + t[0];
  o.p[1] = X * R[3] + Y * R[4] + Z * R[5] + t[1];
  o.p[2] = X * R[6] + Y * R[7] + Z * R[8] + t[2];
  const float nrm = sqrtf(fmaxf(o.p[0] * o.p[0] + o.p[1] * o.p[1] + o.p[2] * o.p[2], 1e-24f));
  o.inv_n = 1.f / nrm;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o.f[i] = o.p[i] / nrm;
    o.r[i] = ok ? o.f[i] - __ldg(a.brg + 3 * n + i) : 0.f;
  }
  return ok;
}

// S observations a thread (3·S residual slots) in registers, or any number
// recomputed (S = 0). Observation j of thread t is n = j·kThreads + t.
template <int kThreads, int S>
struct PoseResid {
  static constexpr int kSlots = 3 * S;
  float r[3 * S];
  uint32_t vis;  // bit j: observation j is valid
  __device__ bool get(int s, float& x) const {
    x = r[s];
    return (vis >> (s / 3)) & 1u;
  }
};
template <int kThreads>
struct PoseResid<kThreads, 0> {
  static constexpr int kSlots = 0;
  const PoseArgs* a;
  float R[9], t[3];
  __device__ int slots() const { return 3 * ((a->N + kThreads - 1) / kThreads); }
  __device__ bool get(int s, float& x) const {
    PoseObs o;
    const int j = s / 3;
    const bool ok = pose_obs(*a, j * kThreads + (int)threadIdx.x, R, t, o);
    x = o.r[s - 3 * j];
    return ok;
  }
};

template <int kThreads, int S>
struct PoseProblem {
  using Resid = PoseResid<kThreads, S>;
  static constexpr bool kLeftUpdate = true;
  const PoseArgs& a;

  __device__ void evaluate(const float (&R)[9], const float (&t)[3], Resid& out) const {
    if constexpr (S > 0) {
      out.vis = 0u;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        PoseObs o;
        const bool ok = pose_obs(a, j * kThreads + (int)threadIdx.x, R, t, o);
#pragma unroll
        for (int i = 0; i < 3; ++i) out.r[3 * j + i] = o.r[i];
        out.vis |= (uint32_t)ok << j;
      }
    } else {
      out.a = &a;
      for (int i = 0; i < 9; ++i) out.R[i] = R[i];
      for (int i = 0; i < 3; ++i) out.t[i] = t[i];
    }
  }

  __device__ void normal_equations(const Resid&, const float (&R)[9], const float (&t)[3],
                                   float c, float (&hg)[32]) const {
    for (int n = threadIdx.x; n < a.N; n += kThreads) {
      PoseObs o;
      const bool ok = pose_obs(a, n, R, t, o);
      // Q = −hat(p)
      const float Q[3][3] = {{0.f, o.p[2], -o.p[1]}, {-o.p[2], 0.f, o.p[0]}, {o.p[1], -o.p[0], 0.f}};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float rv = o.r[i];
        const float w = ok ? tukey_weight(rv, c) : 0.f;
        float Jrow[6];
#pragma unroll
        for (int j = 0; j < 3; ++j) Jrow[j] = ((i == j ? 1.f : 0.f) - o.f[i] * o.f[j]) * o.inv_n;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          Jrow[3 + k] = Jrow[0] * Q[0][k] + Jrow[1] * Q[1][k] + Jrow[2] * Q[2][k];
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          const float jw = w * Jrow[p];
          hg[21 + p] += jw * rv;
#pragma unroll
          for (int q = 0; q <= p; ++q) hg[p * (p + 1) / 2 + q] += jw * Jrow[q];
        }
      }
    }
  }
};

template <int kWarps, int S>
__global__ void __launch_bounds__(kWarps * 32, 1) pose_refine_kernel(
    PoseArgs a, const float* __restrict__ pose_in, float* __restrict__ out_pose,
    float* __restrict__ out_stats, int max_iters, float min_rel_decrease) {
  __shared__ BlockShared<kWarps> sm;
  const size_t problem = blockIdx.x;  // this block's problem of the launch
  a.pts += problem * a.N * 3;
  a.brg += problem * a.N * 3;
  a.vis += problem * a.N;
  pose_in += problem * 12;
  out_pose += problem * 12;
  out_stats += problem * 4;
  Block<kWarps> blk(sm);
  const PoseProblem<kWarps * 32, S> prob{a};
  lm_solve(prob, blk, pose_in, out_pose, out_stats, max_iters, min_rel_decrease);
}

}  // namespace
}  // namespace sdvo

// Five warps (one observation a thread) up to 160 observations, eight (four
// a thread) up to 1024, eight recomputing beyond. n_problems problems of one
// shape, each array holding them one after the other (pose_in (S, 3, 4),
// pts (S, N, 3), ..., out_stats (S, 4)).
extern "C" int sdvo_pose_refine(const float* pose_in, const float* pts, const float* brg,
                                const float* vis, float* out_pose, float* out_stats, int N,
                                int max_iters, float min_rel_decrease, int n_problems,
                                void* stream) {
  if (n_problems < 1) return (int)cudaErrorInvalidValue;
  const sdvo::PoseArgs a{pts, brg, vis, N};
  const cudaStream_t s = (cudaStream_t)stream;
  if (N <= 160)
    sdvo::pose_refine_kernel<5, 1><<<n_problems, 160, 0, s>>>(a, pose_in, out_pose, out_stats,
                                                              max_iters, min_rel_decrease);
  else if (N <= 1024)
    sdvo::pose_refine_kernel<8, 4><<<n_problems, 256, 0, s>>>(a, pose_in, out_pose, out_stats,
                                                              max_iters, min_rel_decrease);
  else
    sdvo::pose_refine_kernel<8, 0><<<n_problems, 256, 0, s>>>(a, pose_in, out_pose, out_stats,
                                                              max_iters, min_rel_decrease);
  return (int)cudaGetLastError();
}
