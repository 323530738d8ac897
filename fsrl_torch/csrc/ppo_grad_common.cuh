// Shared by the two fused PPO-Lagrangian gradient kernels (bf16 with wgmma
// in fused_ppo_grad.cu, f32 as three TF32 products with mma.sync in
// fused_ppo_grad_f32.cu): the envelope, the flat parameter layout, the
// arguments, the per-row loss, the row copies and the helpers that work on
// accumulator fragments.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ppo {

constexpr int H = 128;      // hidden width (both layers)
constexpr int R = 128;      // rows per chunk
constexpr int NT = 256;     // threads per block
// Any observation width D >= 1. Up to DMAX_RESIDENT the bf16 kernel keeps
// the whole of x and W1 in shared memory; above it, it takes them in slices
// of 64 (four 16-deep steps). The f32 kernel reads x and W1 from L2 above
// DMAX_F32_NARROW and takes P4 in slices of 128 columns.
constexpr int DMAX_RESIDENT = 64;
constexpr int DMAX_F32_NARROW = 12;   // the f32 kernel stages x in shared
                                      // memory up to this width
constexpr int AMAX_NARROW = 4;   // up to this action width the kernels keep
                                 // a row's per-action values in registers
constexpr int AM_SLICE = 8;      // above it, a row's per-action values go
                                 // through shared memory, taken in slices of
                                 // this many actions
constexpr int AMAX = 32;    // largest action width (both kernels): what the
                            // f32 kernel's shared memory holds at K 6
constexpr int MMAX = 5;     // largest number of constraints
constexpr int AUXW = 8;     // aux partial width per tower

// Offsets of one tower's tensors. Segments s: 0 W1 (H,D), 1 b1 (H),
// 2 W2 (H,H), 3 b2 (H), 4 head weight (O,H), 5 head bias (O),
// 6 log-sigma (A, actor only). Tower-local order is the segment order; the
// flat parameter vector holds the actor's segments in order, then each
// critic segment stacked over the K critics.
struct Layout {
  int D, A, K;
  __host__ __device__ int seg_len(int t, int s) const {
    switch (s) {
      case 0: return H * D;
      case 1: return H;
      case 2: return H * H;
      case 3: return H;
      case 4: return t == 0 ? A * H : H;
      case 5: return t == 0 ? A : 1;
      case 6: return t == 0 ? A : 0;
      default: return 0;
    }
  }
  __host__ __device__ int local_off(int t, int s) const {
    int o = 0;
    for (int i = 0; i < s; ++i) o += seg_len(t, i);
    return o;
  }
  __host__ __device__ int tower_size(int t) const { return local_off(t, 7); }
  __host__ __device__ int global_off(int t, int s) const {
    if (t == 0) return local_off(0, s);
    int base = tower_size(0);
    for (int i = 0; i < s; ++i) base += K * seg_len(1, i);
    return base + (t - 1) * seg_len(1, s);
  }
};

// What a gradient kernel gets. Both kernels run on a grid (G, 1+K):
// blockIdx.y picks the tower (0 = actor, 1..K = critics), the block walks the
// row chunks blockIdx.x, blockIdx.x + G, ... and writes one partial:
// part [G][1+K][tower_size(0)] gradients in tower-local order, part_aux
// [G][1+K][AUXW] sums (actor: sum(logp_old - logp), sum(min surrogate),
// sum(ratio * cadv_m); critic: sum(diff^2)).
struct Args {
  const float *params, *obs, *act, *logp_old, *adv, *ret, *lam, *resc;
  float *part, *part_aux;
  int B, D, A, K;
  float clip_lo, clip_hi, gv_scale, a_log_sqrt_2pi;
  bool aligned16;   // obs, act, logp_old, adv and ret start on 16 bytes
};

// The actor's loss at one row from the pre-tanh mean `s` (bias included):
// gradient at the mean head's output, per-row d loss / d log-sigma, and the
// row's aux terms. Tie conventions are JAX's: d min(s1, s2) splits 0.5/0.5
// where s1 == s2, and the clip passes 0.5 where ratio == 1 +- eps.
template <int AM>
struct ActorRow {
  float g_mu[AM], g_ls[AM], kl, mins, ratio;
};
template <int AM>
__device__ __forceinline__ ActorRow<AM> actor_row(
    const float (&s)[AM], const float* act_row, float logp_old,
    const float* adv_row, const float (&sig)[AM], float lsig_sum,
    const float (&lamv)[MMAX], float resc, const Args& a) {
  ActorRow<AM> o;
  float mu[AM], z[AM], sq = 0.f;
#pragma unroll
  for (int i = 0; i < AM; ++i)
    if (i < a.A) {
      mu[i] = tanhf(s[i]);
      z[i] = (act_row[i] - mu[i]) / sig[i];
      sq += -0.5f * z[i] * z[i];
    }
  const float logp = sq - lsig_sum - a.a_log_sqrt_2pi;
  const float ratio = expf(logp - logp_old);
  const float advr = adv_row[0];
  const float rc = fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
  const float s1 = ratio * advr, s2 = rc * advr;
  const float w1 = s1 < s2 ? 1.f : (s1 == s2 ? 0.5f : 0.f);
  const float w2 = 1.f - w1;
  const float inside =
      (ratio > a.clip_lo && ratio < a.clip_hi)
          ? 1.f
          : ((ratio == a.clip_lo || ratio == a.clip_hi) ? 0.5f : 0.f);
  const float dmin = advr * (w1 + w2 * inside);
  float lsum = 0.f;
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
    if (m < a.K - 1) lsum += adv_row[1 + m] * lamv[m];
  const float g_ratio = resc * (-dmin + lsum) / (float)a.B;
  const float g_logp = g_ratio * ratio;
#pragma unroll
  for (int i = 0; i < AM; ++i)
    if (i < a.A) {
      o.g_mu[i] = g_logp * (z[i] / sig[i]) * (1.f - mu[i] * mu[i]);
      o.g_ls[i] = g_logp * (z[i] * z[i] - 1.f);
    } else {
      o.g_mu[i] = 0.f;
      o.g_ls[i] = 0.f;
    }
  o.kl = logp_old - logp;
  o.mins = fminf(s1, s2);
  o.ratio = ratio;
  return o;
}

// Adds the sum of v over the warp (a fixed shuffle tree) to *dst, by
// lane 0. The whole warp calls it.
__device__ __forceinline__ void warp_add(float* dst, float v, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) *dst += v;
}

__device__ __forceinline__ float r_exp(float x) { return expf(x); }
__device__ __forceinline__ double r_exp(double x) { return exp(x); }
__device__ __forceinline__ float r_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double r_tanh(double x) { return tanh(x); }

// The row's -z^2 / 2 at action i (actor_row_shared).
template <class Real>
__device__ __forceinline__ Real row_sq(const float* s, const float* act_row,
                                       const float* ls, int i) {
  const Real mu = r_tanh((Real)s[i]);
  const Real z = ((Real)act_row[i] - mu) / r_exp((Real)ls[i]);
  return (Real)-0.5 * z * z;
}

// The row's gradient at action i (actor_row_shared): d loss / d the head's
// output into g_out[i] (0 on a dead row) and into the warp's sums.
template <int AM, class Real, class Add>
__device__ __forceinline__ void row_grad(const float* s, float* g_out,
                                         bool own, bool live,
                                         const float* act_row,
                                         const float* ls, Real g_logp, int i,
                                         Add& add) {
  float gm = 0.f, gl = 0.f;
  if (own) {
    const Real sig = r_exp((Real)ls[i]);
    const Real mu = r_tanh((Real)s[i]);
    const Real z = ((Real)act_row[i] - mu) / sig;
    gm = (float)(g_logp * (z / sig) * ((Real)1 - mu * mu));
    gl = (float)(g_logp * (z * z - (Real)1));
    g_out[i] = live ? gm : 0.f;
  }
  const bool mine = own && live;
  add(i, mine ? gm : 0.f);
  add(AM + i, mine ? gl : 0.f);
}

// actor_row for the instances above AMAX_NARROW actions, which hold no
// per-action array in registers: the row's pre-tanh means s[0, A) are read
// from shared memory twice (for the log-prob, then for the gradient), the
// gradient at the head's output goes to g_out (shared memory, 0 on a dead
// row), and each of the row's terms goes straight to add(k, v), a sum over
// the warp that every lane calls with the same k: k < AM the head bias
// gradient, AM + i d loss / d log-sigma_i, 2 AM kl, 2 AM + 1 the min
// surrogate, 2 AM + 3 + m ratio * cadv_m. Up to AM_SLICE actions the
// loops are unrolled; above, they take AM_SLICE actions at a time in a loop
// that is not unrolled. Only a lane with `own` reads s
// and writes g_out (one lane a row); the others add zeros. `ls` is the
// log-sigma vector. The row's arithmetic is in Real: float, as actor_row,
// or double (the f32 kernel), where the log-prob's float32 rounding (its
// constant terms are rounded alike in every row, so their errors add up
// over the rows) would otherwise dominate the aux sums' error.
template <int AM, class Real, class Add>
__device__ __forceinline__ void actor_row_shared(
    const float* s, float* g_out, bool own, bool live, const float* act_row,
    float logp_old, const float* adv_row, const float* ls, const float* lamv,
    float resc, const Args& a, Add&& add) {
  Real lsig_sum = 0;
  if constexpr (AM <= AM_SLICE) {
#pragma unroll
    for (int i = 0; i < AM; ++i)
      if (i < a.A) lsig_sum += (Real)ls[i];
  } else {
#pragma unroll 1
    for (int i = 0; i < a.A; ++i) lsig_sum += (Real)ls[i];
  }
  Real sq = 0;
  if (own) {
    if constexpr (AM <= AM_SLICE) {
#pragma unroll
      for (int i = 0; i < AM; ++i)
        if (i < a.A) sq += row_sq<Real>(s, act_row, ls, i);
    } else {
#pragma unroll 1
      for (int i0 = 0; i0 < a.A; i0 += AM_SLICE)
#pragma unroll
        for (int u = 0; u < AM_SLICE; ++u)
          if (i0 + u < a.A) sq += row_sq<Real>(s, act_row, ls, i0 + u);
    }
  }
  const Real c = sizeof(Real) == sizeof(float)
                     ? (Real)a.a_log_sqrt_2pi
                     : (Real)a.A * (Real)0.91893853320467274178;
  const Real logp = sq - lsig_sum - c;
  const Real ratio = r_exp(logp - (Real)logp_old);
  const Real advr = adv_row[0];
  const Real lo = a.clip_lo, hi = a.clip_hi;
  const Real rc = ratio < lo ? lo : (ratio > hi ? hi : ratio);
  const Real s1 = ratio * advr, s2 = rc * advr;
  const Real w1 = s1 < s2 ? (Real)1 : (s1 == s2 ? (Real)0.5 : (Real)0);
  const Real w2 = (Real)1 - w1;
  const Real inside = (ratio > lo && ratio < hi)
                          ? (Real)1
                          : ((ratio == lo || ratio == hi) ? (Real)0.5
                                                          : (Real)0);
  const Real dmin = advr * (w1 + w2 * inside);
  Real lsum = 0;
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
    if (m < a.K - 1) lsum += (Real)adv_row[1 + m] * (Real)lamv[m];
  const Real g_ratio = (Real)resc * (-dmin + lsum) / (Real)a.B;
  const Real g_logp = g_ratio * ratio;
  const bool mine = own && live;
  if constexpr (AM <= AM_SLICE) {
#pragma unroll
    for (int i = 0; i < AM; ++i)
      if (i < a.A)
        row_grad<AM, Real>(s, g_out, own, live, act_row, ls, g_logp, i, add);
  } else {
#pragma unroll 1
    for (int i0 = 0; i0 < a.A; i0 += AM_SLICE)
#pragma unroll
      for (int u = 0; u < AM_SLICE; ++u)
        if (i0 + u < a.A)
          row_grad<AM, Real>(s, g_out, own, live, act_row, ls, g_logp,
                             i0 + u, add);
  }
  add(2 * AM, mine ? (float)((Real)logp_old - logp) : 0.f);
  add(2 * AM + 1, mine ? (float)(s1 < s2 ? s1 : s2) : 0.f);
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
    if (m < a.K - 1)
      add(2 * AM + 3 + m,
          mine ? (float)(ratio * (Real)adv_row[1 + m]) : 0.f);
}

// Asynchronous copies of a chunk's rows into shared memory.
namespace cp {

// n_total floats from global to shared memory by the block's NT threads. A
// whole chunk from a 16-byte aligned source goes 16 bytes a copy; else 4
// bytes a copy, and the floats from n_valid on are zero-filled (source size
// 0 reads nothing).
__device__ __forceinline__ void rows(float* dst, const float* src,
                                     int n_valid, int n_total, bool vec) {
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(dst);
  if (vec && n_valid == n_total) {
    for (int i = 4 * threadIdx.x; i < n_total; i += 4 * NT)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + 4 * i),
                   "l"(src + i)
                   : "memory");
    return;
  }
  for (int i = threadIdx.x; i < n_total; i += NT) {
    const bool ok = i < n_valid;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     base + 4 * i),
                 "l"(src + (ok ? i : 0)), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cp

// Both kernels give a warp 16 rows of a 128-column product. Its
// accumulator fragment (wgmma's m64 slab, or 16 mma.sync m16n8 tiles side
// by side) holds in lane l rows l / 4 and l / 4 + 8 at the columns
// 8 jb + 2 (l % 4) + e, as elements 4 jb + 2 h + e.

// The 32 columns of a thread's fragment (8 * jb + 2 * q, + 1) of a row of
// floats in shared memory, loaded together so that their latencies overlap.
__device__ __forceinline__ void load_cols(float2 (&ld)[16], const float* row,
                                          int q) {
#pragma unroll
  for (int jb = 0; jb < 16; ++jb)
    ld[jb] = *reinterpret_cast<const float2*>(row + 8 * jb + 2 * q);
}

// One level of the sum over a warp's eight row lanes (lane bits 2..4): the
// lanes of a pair split the N2 * 2 values, each keeps one half and adds the
// partner's.
template <int N2, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane, int bit) {
  const bool up = lane & bit;
#pragma unroll
  for (int i = 0; i < N2; ++i) {
    const float send = up ? v[i] : v[i + N2];
    const float keep = up ? v[i + N2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}

// Column sums of a fragment-shaped array over the warp's 16 rows: v[2 nt +
// e] holds the sum of the lane's two rows at column 8 nt + 2 (lane % 4) + e
// (N / 2 tiles of 8 columns). Afterwards v[i], i < N / 8, holds the warp's
// sum of column column_of<N>(lane, i), and each column is one lane's.
template <int N>
__device__ __forceinline__ void column_sums(float (&v)[N], int lane) {
  halve<N / 2>(v, lane, 16);
  halve<N / 4>(v, lane, 8);
  halve<N / 8>(v, lane, 4);
}
template <int N>
__device__ __forceinline__ int column_of(int lane, int i) {
  const int idx = N / 8 * (lane >> 2) + i;
  return 8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1);
}

// The f32 kernel's launcher and its dynamic shared memory
// (fused_ppo_grad_f32.cu).
cudaError_t launch_f32(const Args& a, int G, cudaStream_t stream);
size_t smem_bytes_f32(int D, int A, int K);

}  // namespace ppo
