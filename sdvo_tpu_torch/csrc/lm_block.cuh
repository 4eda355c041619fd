// One Levenberg–Marquardt solve on SE(3) by one thread block: the block-wide
// reductions, the robust scale and the LM loop that K1 (lm_align.cu) and K3
// (pose_refine.cu) share.
//
// An LM iteration is a chain of dependent reductions over a few thousand
// residuals, so what sets its time on one SM is the length of that chain and
// the instructions each link costs, not bytes or flops. On an H100 one link
// — partials to shared memory, a barrier, warp 0 combining, a barrier — costs
// about 1,000 cycles with 32 warps, whatever is reduced, and a median stage
// about 4,000: 2,800 to count seven values a thread into bins (the SM's instruction
// slots: 32 warps of ~45 instructions a value) and 1,200 to decide (thread
// 0's clock64() around each section of a solve; PERF.md has the table). The
// design:
//
//  * A thread owns its residuals for a whole evaluation (in registers where
//    the problem fits, see each kernel's Resid); only reductions cross threads.
//  * A reduction is two block barriers: every warp leaves its partials in
//    shared memory; warp 0 combines them across its lanes (one lane a warp)
//    and publishes the totals; every thread reads the same totals. All
//    threads therefore take the same accept/reject branch from bit-identical
//    numbers, summed in one fixed order.
//  * Seven reductions an evaluation, not nine: count, minimum and maximum
//    are one reduction, and the largest deviation from the median needs none
//    (it is at the minimum or the maximum).
//  * One warp decides. What follows a reduction and is scalar — the prefix
//    sum and the hit bin of a median stage, the 6×6 Cholesky, the SE(3) exp
//    and the candidate pose — runs in warp 0 alone and is published through
//    shared memory, instead of costing every warp's instruction slots.
//  * Few shuffles, sent in batches (warp-collective instructions stay in
//    source order, so they are written step by step over all values). The 27
//    float sums of H and g take a transposing reduction (31 shuffles a warp
//    instead of 135), the 16 bin counts the same (17), a packed histogram 7.
//    The warp-reduce instruction (`__reduce_add_sync`) in their place
//    measured no faster.
//  * The 16-bin median finds a value's bin once (five compares against the
//    thresholds in shared memory), counts in a 4-bit-per-bin packed word, and
//    takes the prefix sum at the end: the cumulative counts
//    cnt[b] = #{x <= thr[b]} are small integers and come out exactly as a
//    compare against each threshold would give them. (Finding the bin by
//    arithmetic instead, with a check against the neighbouring thresholds,
//    measured half as fast: it is more instructions.)
#pragma once

#include "common.cuh"

namespace sdvo {

// uint32 key whose unsigned order is the float order (for integer min/max)
__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float tukey_weight(float r, float c) {
  const float w = 1.f - (r * r) / (c * c);
  return (fabsf(r) <= c) ? w * w : 0.f;
}

// One halving step of a transposing warp sum: 2·N values a lane -> N, across
// the lanes that differ in bit OFF.
template <int N, int OFF, class T, int K>
__device__ __forceinline__ void transpose_sum_step(T (&v)[K], int lane) {
  static_assert(2 * N <= K, "the step halves 2·N values");
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T keep = upper ? v[i + N] : v[i];
    const T send = upper ? v[i] : v[i + N];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, OFF);
  }
}

// Sums 32 values a lane over the warp in 31 shuffles (5·32 one by one); lane
// l ends with the total of value l in v[0].
__device__ __forceinline__ void warp_transpose_sum(float (&v)[32], int lane) {
  transpose_sum_step<16, 16>(v, lane);
  transpose_sum_step<8, 8>(v, lane);
  transpose_sum_step<4, 4>(v, lane);
  transpose_sum_step<2, 2>(v, lane);
  transpose_sum_step<1, 1>(v, lane);
}

// Sums 16 counts a lane over the warp in 17 shuffles; lane b < 16 (and
// b + 16) gets the total of count b.
__device__ __forceinline__ uint32_t warp_transpose_sum16(uint32_t (&v)[16], int lane) {
  transpose_sum_step<8, 16>(v, lane);
  transpose_sum_step<4, 8>(v, lane);
  transpose_sum_step<2, 4>(v, lane);
  transpose_sum_step<1, 2>(v, lane);
  v[0] += __shfl_xor_sync(kFullMask, v[0], 1);  // lanes 2b and 2b + 1 hold count b
  return __shfl_sync(kFullMask, v[0], 2 * (lane & 15));
}

// K values a lane combined over the warp (every lane gets the results), one
// butterfly step for all values before the next: warp-collective instructions
// stay in source order, so value after value would wait out each latency.
template <int K, class Op>
__device__ __forceinline__ void warp_combine(uint32_t (&x)[K], Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = op(x[k], __shfl_xor_sync(kFullMask, x[k], off), k);
  }
}

constexpr int kPartStride = 33;  // words a warp's partials take (odd: no bank conflicts)
constexpr int kHgValues = 27;    // 21 of H (lower triangle) + 6 of g
constexpr int kChunk = 7;        // values a lane counts into one packed histogram (4 bits a bin)
constexpr int kStepWords = 16;   // what warp 0 publishes of an LM step

template <int kWarps>
struct BlockShared {
  uint32_t part[kWarps * kPartStride];
  uint32_t tot[32];
  float thr[kWarps * kMadBins];
  float step[kStepWords];
};

// How two partials of value k combine (commutative, so that a butterfly
// leaves the same bits in every lane), and what fills the lanes beyond the
// last warp.
struct AddF {
  __device__ uint32_t identity(int) const { return 0u; }
  __device__ uint32_t operator()(uint32_t a, uint32_t b, int) const {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
};
struct CountMinMax {  // value 0 a count, value 1 a minimum, value 2 a maximum
  __device__ uint32_t identity(int k) const { return k == 1 ? 0xffffffffu : 0u; }
  __device__ uint32_t operator()(uint32_t a, uint32_t b, int k) const {
    return k == 0 ? a + b : k == 1 ? min(a, b) : max(a, b);
  }
};

template <int kWarps>
struct Block {
  BlockShared<kWarps>& sm;
  const int lane, warp;

  __device__ explicit Block(BlockShared<kWarps>& s)
      : sm(s), lane(threadIdx.x & 31), warp(threadIdx.x >> 5) {}

  __device__ void sync() const { __syncthreads(); }

  // Every warp has left K partials at part[warp][0..K). After the barrier
  // warp 0 takes them one warp a lane and combines them across its lanes;
  // lane k returns the total of value k (other threads return nothing of
  // use). The order is fixed, so the totals are the same from run to run.
  template <int K, class Op>
  __device__ uint32_t combine(Op op) {
    static_assert(kWarps <= 32 && K <= 32, "one lane a warp, one lane a value");
    sync();
    uint32_t mine = 0u;
    if (warp == 0) {
      uint32_t x[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        x[k] = lane < kWarps ? sm.part[lane * kPartStride + k] : op.identity(k);
      warp_combine(x, op);
#pragma unroll
      for (int k = 0; k < K; ++k) mine = (lane == k) ? x[k] : mine;
    }
    return mine;
  }

  // ... and publishes the K totals to every thread through tot[0..K)
  template <int K, class Op>
  __device__ void combine_all(Op op) {
    const uint32_t x = combine<K>(op);
    if (warp == 0 && lane < K) sm.tot[lane] = x;
    sync();
  }

  // v[0..27) summed over the block (v[27..32) is padding and must be 0): a
  // transposing sum in every warp, then the same over the warps' partials in
  // warp 0. The totals come back in every lane of warp 0 only.
  __device__ void sum_hg(float (&v)[32]) {
    warp_transpose_sum(v, lane);
    sm.part[warp * kPartStride + lane] = __float_as_uint(v[0]);
    sync();
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < 32; ++k)
        v[k] = (lane < kWarps && k < kHgValues)
                   ? __uint_as_float(sm.part[lane * kPartStride + k])
                   : 0.f;
      warp_transpose_sum(v, lane);
      const float total = v[0];
#pragma unroll
      for (int k = 0; k < kHgValues; ++k) v[k] = __shfl_sync(kFullMask, total, k);
    }
  }

  __device__ float sum(float x) {
    x = warp_sum(x);
    if (lane == 0) sm.part[warp * kPartStride] = __float_as_uint(x);
    combine_all<1>(AddF());
    return __uint_as_float(sm.tot[0]);
  }

  // count, minimum and maximum in one reduction
  __device__ void count_min_max(uint32_t& n, float& lo, float& hi) {
    uint32_t x[3] = {n, float_key(lo), float_key(hi)};
    warp_combine(x, CountMinMax());
    if (lane < 3) sm.part[warp * kPartStride + lane] = lane == 0 ? x[0] : lane == 1 ? x[1] : x[2];
    combine_all<3>(CountMinMax());
    n = sm.tot[0];
    lo = key_float(sm.tot[1]);
    hi = key_float(sm.tot[2]);
  }

  // One zoom stage of the 16-bin median
  // (sdvo_tpu/ops/pallas_lm.py::_bin_median). Lane b < 16 of every warp
  // brings its warp's count of bin b. Warp 0 adds them over the warps, takes
  // the prefix sum cnt[b] = #{x <= lo + (b+1)/16·span}, and the one bin with
  // cnt[b−1] < half_n <= cnt[b] sets the median estimate and narrows
  // [lo, hi] to itself; every thread gets the new (lo, hi, med).
  __device__ void median_stage(uint32_t bin_count, float half_n, float& lo, float& hi,
                               float& med) {
    if (lane < kMadBins) sm.part[warp * kPartStride + lane] = bin_count;
    sync();
    if (warp == 0) {
      uint32_t per_warp[kMadBins];  // this lane's warp's counts
#pragma unroll
      for (int b = 0; b < kMadBins; ++b)
        per_warp[b] = lane < kWarps ? sm.part[lane * kPartStride + b] : 0u;
      const uint32_t tot = warp_transpose_sum16(per_warp, lane);  // of bin `lane & 15`
      uint32_t cum = tot;
#pragma unroll
      for (int off = 1; off < kMadBins; off <<= 1) {
        const uint32_t up = __shfl_up_sync(kFullMask, cum, off);
        if (lane >= off) cum += up;
      }
      const float cnt = (float)cum, prev = (float)(cum - tot);
      const bool hit = lane < kMadBins && prev < half_n && cnt >= half_n;
      const unsigned hits = __ballot_sync(kFullMask, hit);
      if (hits != 0u && lane == __ffs(hits) - 1) {
        const float span = fmaxf(hi - lo, 1e-12f);
        const float frac = (half_n - prev) / fmaxf(cnt - prev, 1.f);
        sm.tot[0] = __float_as_uint(lo + (float)lane * (span / kMadBins));
        sm.tot[1] = __float_as_uint(lo + ((float)lane + 1.f) * (span / kMadBins));
        sm.tot[2] = __float_as_uint(lo + ((float)lane + frac) * (span / kMadBins));
      } else if (hits == 0u && lane == 0) {
        sm.tot[0] = __float_as_uint(lo);
        sm.tot[1] = __float_as_uint(hi);
        sm.tot[2] = __float_as_uint(med);
      }
    }
    sync();
    lo = __uint_as_float(sm.tot[0]);
    hi = __uint_as_float(sm.tot[1]);
    med = __uint_as_float(sm.tot[2]);
  }
};

// A Vals type holds the residuals of one evaluated pose as the block's
// threads own them: `kSlots` values a thread (0: a run-time number,
// `slots()`, the same for every thread), and `get(s, x)` gives slot s and
// whether it is a visible residual. The loop is unrolled for a compile-time
// count so that the values stay in registers. f(s) is called for every slot
// by every thread.
template <class Vals, class F>
__device__ __forceinline__ void for_each_slot(const Vals& vals, F f) {
  if constexpr (Vals::kSlots > 0) {
#pragma unroll
    for (int s = 0; s < Vals::kSlots; ++s) f(s);
  } else {
    const int n = vals.slots();
    for (int s = 0; s < n; ++s) f(s);
  }
}

// A thread's values, up to kChunk at a time, for the passes that are written
// "vertically": each step for all values of the chunk before the next step.
// A warp runs its instructions in order and the compiler keeps close to the source's order,
// so this is what lets the values' dependent chains (five loads each in the
// bin search) overlap instead of running one after the other.
template <int W>
struct Chunk {
  float x[W];
  uint32_t vis;  // bit i: x[i] is a visible residual
};

template <class Vals>
__host__ __device__ constexpr int chunk_width() {
  return (Vals::kSlots > 0 && Vals::kSlots < kChunk) ? Vals::kSlots : kChunk;
}

template <class Vals, class F>
__device__ __forceinline__ void for_each_chunk(const Vals& vals, F f) {
  constexpr int W = chunk_width<Vals>();
  int n = (Vals::kSlots + W - 1) / W;
  if constexpr (Vals::kSlots == 0) n = (vals.slots() + W - 1) / W;
#pragma unroll
  for (int c = 0; c < n; ++c) {
    Chunk<W> ch;
    ch.vis = 0u;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      ch.x[i] = 0.f;
      // a run-time count: get() is false past the last value
      if (Vals::kSlots == 0 || c * W + i < Vals::kSlots)
        ch.vis |= (uint32_t)vals.get(c * W + i, ch.x[i]) << i;
    }
    f(ch);
  }
}

// v << n for n up to 64 (the PTX shift gives 0 from 64 on; in C++ it would be
// undefined)
__device__ __forceinline__ unsigned long long shl64(unsigned long long v, int n) {
  unsigned long long r;
  asm("shl.b64 %0, %1, %2;" : "=l"(r) : "l"(v), "r"(n));
  return r;
}

// For each value of the chunk the first b with x <= thr[b], 16 when there is
// none (thr is non-decreasing), added into the packed histogram: 4 bits a
// bin, bin b at bit 4·b, so that "none" shifts out. The search keeps 4·b: it
// is the byte offset of thr[b] and the shift of bin b at once.
template <int W>
__device__ __forceinline__ unsigned long long count_bins(const Chunk<W>& ch, const float* thr,
                                                         bool dev, float center) {
  const char* base = reinterpret_cast<const char*>(thr);
  const auto at = [base](int b4) { return *reinterpret_cast<const float*>(base + b4); };
  const float thr7 = thr[7];
  float x[W];
  int b4[W];
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = dev ? fabsf(ch.x[i] - center) : ch.x[i];
#pragma unroll
  for (int i = 0; i < W; ++i) b4[i] = (x[i] <= thr7) ? 0 : 32;
#pragma unroll
  for (int i = 0; i < W; ++i) b4[i] += (x[i] <= at(b4[i] + 12)) ? 0 : 16;
#pragma unroll
  for (int i = 0; i < W; ++i) b4[i] += (x[i] <= at(b4[i] + 4)) ? 0 : 8;
#pragma unroll
  for (int i = 0; i < W; ++i) b4[i] += (x[i] <= at(b4[i])) ? 0 : 4;
#pragma unroll
  for (int i = 0; i < W; ++i) b4[i] += (x[i] <= at(b4[i])) ? 0 : 4;  // 15 against 16
  unsigned long long packed = 0ull;
#pragma unroll
  for (int i = 0; i < W; ++i) packed += shl64((ch.vis >> i) & 1u, b4[i]);
  return packed;
}

// sums a lane-packed histogram (4 bits a bin, at most kChunk a bin) over the
// warp in 7 shuffles; lane b < 16 (and lane b + 16) gets the count of bin b
__device__ __forceinline__ uint32_t flush_packed(unsigned long long packed, int lane) {
  const uint32_t lo32 = (uint32_t)packed, hi32 = (uint32_t)(packed >> 32);
  // a byte a bin, <= 32·7 each: even bins of 0..7, odd of 0..7, even of 8..15, odd of 8..15
  uint32_t a[4] = {lo32 & 0x0f0f0f0fu, (lo32 >> 4) & 0x0f0f0f0fu, hi32 & 0x0f0f0f0fu,
                   (hi32 >> 4) & 0x0f0f0f0fu};
  transpose_sum_step<2, 16>(a, lane);
  transpose_sum_step<1, 8>(a, lane);  // lanes 8j..8j+7 hold word j
  uint32_t word = a[0];
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) word += __shfl_xor_sync(kFullMask, word, off);
  const int b = lane & 15;
  word = __shfl_sync(kFullMask, word, (((b >> 3) << 1) | (b & 1)) << 3);
  return (word >> (8 * ((b & 7) >> 1))) & 0xffu;
}

// two-stage binned median of x (or |x − center| when dev) over the visible
// values (sdvo_tpu/ops/pallas_lm.py::_bin_median). The passes over a
// thread's values here and in robust_scale hold no branch on visibility, so
// that the slots' dependent chains may overlap.
template <int kWarps, class Vals>
__device__ float block_bin_median(Block<kWarps>& blk, const Vals& vals, bool dev, float center,
                                  float lo, float hi, float half_n) {
  float* thr = blk.sm.thr + blk.warp * kMadBins;
  float med = hi;
  for (int stage = 0; stage < 2; ++stage) {
    const float span = fmaxf(hi - lo, 1e-12f);
    if (blk.lane < kMadBins) thr[blk.lane] = lo + (((float)blk.lane + 1.f) / kMadBins) * span;
    __syncwarp();
    uint32_t bin_count = 0u;  // of bin `lane & 15`, over this warp
    for_each_chunk(vals, [&](const auto& ch) {
      bin_count += flush_packed(count_bins(ch, thr, dev, center), blk.lane);
    });
    blk.median_stage(bin_count, half_n, lo, hi, med);  // its barriers also fence thr
  }
  return med;
}

// Tukey cutoff c = 4.6851·max(1.4826·MAD, 1e-12) of the visible values, their
// chi² under it, and their count (at least 1).
template <int kWarps, class Vals>
__device__ void robust_scale(Block<kWarps>& blk, const Vals& vals, float& c, float& chi,
                             float& n_vis) {
  uint32_t n = 0;
  float lo = kBig, hi = -kBig;
  for_each_slot(vals, [&](int s) {
    float x;
    const bool vis = vals.get(s, x);
    n += vis;
    lo = fminf(lo, vis ? x : kBig);
    hi = fmaxf(hi, vis ? x : -kBig);
  });
  blk.count_min_max(n, lo, hi);
  n_vis = fmaxf((float)n, 1.f);
  const float half_n = 0.5f * n_vis;
  const float med = block_bin_median(blk, vals, false, 0.f, lo, hi, half_n);
  // the largest |x − med|: x − med rounds monotonically in x, so it is at the
  // smallest or the largest visible value — bit for bit the maximum a pass
  // over the values would find, without the pass and its reduction
  const float hi2 = n > 0u ? fmaxf(fabsf(hi - med), fabsf(lo - med)) : 0.f;
  const float mad = block_bin_median(blk, vals, true, med, 0.f, hi2, half_n);
  c = 4.6851f * fmaxf(1.4826f * mad, 1e-12f);
  float ch = 0.f;
  for_each_slot(vals, [&](int s) {
    float x;
    const bool vis = vals.get(s, x);
    ch += vis ? tukey_weight(x, c) * x * x : 0.f;
  });
  chi = blk.sum(ch);
}

// The LM loop. Problem gives:
//   Resid                                 the Vals type of one evaluation
//   evaluate(R, t, Resid&)                residuals at the pose (R, t)
//   normal_equations(Resid, R, t, c, hg)  this thread's share of H (lower
//                                         triangle, 21) and g (6) into hg
//   kLeftUpdate                           T <- exp(−dx)∘T, else T∘exp(−dx)
// Nielsen damping with lam·diag_max on iteration 0 only; accept on a chi²
// decrease; ends on a small step, a failed Cholesky, a small relative or
// predicted decrease, or max_iters. out_stats = [chi, n_vis, iterations, 0].
// The accepted pose carries its residuals, scale c and chi², so each
// iteration evaluates one pose: the candidate.
template <int kWarps, class Problem>
__device__ void lm_solve(const Problem& prob, Block<kWarps>& blk,
                         const float* __restrict__ pose_in, float* __restrict__ out_pose,
                         float* __restrict__ out_stats, int max_iters, float min_rel_decrease) {
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[3 * i + j] = pose_in[4 * i + j];
    t[i] = pose_in[4 * i + 3];
  }
  typename Problem::Resid acc, cand;
  prob.evaluate(R, t, acc);
  float c, chi, n_vis;
  robust_scale(blk, acc, c, chi, n_vis);

  float lam = 1e-2f, nu = 2.f;
  int it = 0;
  bool done = false;
  while (it < max_iters && !done) {
    float hg[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hg[i] = 0.f;
    prob.normal_equations(acc, R, t, c, hg);
    blk.sum_hg(hg);
    // warp 0 solves for the step and publishes the candidate pose
    if (blk.warp == 0) {
      float H[21], g[6];
#pragma unroll
      for (int i = 0; i < 21; ++i) H[i] = hg[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) g[i] = hg[21 + i];
      float diag_max = H[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) diag_max = fmaxf(diag_max, fabsf(H[i * (i + 1) / 2 + i]));
      const float lam_eff = (it == 0) ? lam * diag_max : lam;
#pragma unroll
      for (int i = 0; i < 6; ++i) H[i * (i + 1) / 2 + i] += lam_eff;
      float dx[6], mdx[6];
      const bool okc = chol6_solve(H, g, dx);
      float pred = 0.f, step2 = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        if (!okc) dx[i] = 0.f;
        mdx[i] = -dx[i];
        pred += dx[i] * (lam_eff * dx[i] + g[i]);
        step2 += dx[i] * dx[i];
      }
      float dR[9], dt[3], Rn[9], tn[3];
      se3_exp(mdx, dR, dt);
      if (Problem::kLeftUpdate) {
        mat3_mul(dR, R, Rn);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          tn[i] = dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2] + dt[i];
      } else {
        mat3_mul(R, dR, Rn);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          tn[i] = R[3 * i] * dt[0] + R[3 * i + 1] * dt[1] + R[3 * i + 2] * dt[2] + t[i];
      }
      if (blk.lane == 0) {
        float* out = blk.sm.step;
#pragma unroll
        for (int i = 0; i < 9; ++i) out[i] = Rn[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) out[9 + i] = tn[i];
        out[12] = pred;
        out[13] = step2;
        out[14] = lam_eff;
        out[15] = okc ? 1.f : 0.f;
      }
    }
    blk.sync();
    float R_new[9], t_new[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R_new[i] = blk.sm.step[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t_new[i] = blk.sm.step[9 + i];
    const float pred = blk.sm.step[12], step2 = blk.sm.step[13], lam_eff = blk.sm.step[14];
    const bool okc = blk.sm.step[15] > 0.5f;
    prob.evaluate(R_new, t_new, cand);
    float c_n, chi_n, n_vis_n;
    robust_scale(blk, cand, c_n, chi_n, n_vis_n);

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
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = R_new[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = t_new[i];
      chi = chi_n;
      c = c_n;
      n_vis = n_vis_n;
      acc = cand;
    }
    lam = lam_next;
    nu = nu_next;
    ++it;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) out_pose[4 * i + j] = R[3 * i + j];
      out_pose[4 * i + 3] = t[i];
    }
    out_stats[0] = chi;
    out_stats[1] = n_vis;
    out_stats[2] = (float)it;
    out_stats[3] = 0.f;
  }
}

}  // namespace sdvo
