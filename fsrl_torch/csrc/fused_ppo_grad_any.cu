// Fused PPO-Lagrangian minibatch loss gradient at any widths: the form of
// K2 for every shape of the gate that the tuned forms (fused_ppo_grad.cu,
// fused_ppo_grad_f32.cu: hidden (128, 128), up to 32 actions) do not take.
// Two hidden layers of widths H1 and H2 (the same in the actor and the
// critics), any observation width D, any number of actions A, K <= 6 value
// channels; operands rounded to bf16 (`bf16`) or not.
//
// Replaces: fsrl_tpu/ops/fused_ppo_grad.py `_kernel` (line 68; its
// pallas_call at line 235 in `ppo_grad_minibatch`), which reads H from the
// weights and holds every weight whole as a block, so it takes any widths.
// The arithmetic is the Pallas kernel's and ppo_grad_plain's: the trunk,
// critic-head and weight-gradient products on operands rounded to bf16
// where `bf16` is set, the actor's mean head and its gradients in float32,
// biases and activations in float32, JAX's 0.5 / 0.5 tie conventions.
//
// Bound on this card: operations. Per row and tower the products take
// 6 H1 H2 + 4 D H1 + 6 H2 O FLOP (O = A for the actor, 1 for a critic):
// about 39 GFLOP at hidden (256, 256), D 9, A 2, K 2 and 32,768 rows, 0.04
// ms at the bf16 tensor-core peak. This form runs them on the FP32 pipes
// (67 TFLOP/s, 0.58 ms there): a correct first form, not a fast one.
//
// Design: a sequence of launches on the caller's stream, each a plain
// kernel, with every intermediate in global scratch:
//   1. h1 = relu(x W1^T + b1)          rows x H1, depth D    (X1)
//   2. h2 = relu(h1 W2^T + b2)         rows x H2, depth H1   (X2)
//   3. heads: s = h2 Wmu^T + bmu,      rows x A  (actor, f32)  (RV)
//             v = h2 Wv^T + bv         rows x 1  (critics)
//   4. the row loss: from s (or v) each row's head gradient and its terms
//      of the sums over rows, written over its row of RV
//   5. dWmu = g_mu^T h2, dWv = g_v^T h2               depth: rows
//   6. g_h2 = (g_mu Wmu or g_v Wv) * (h2 > 0)         over X2 in place
//   7. dW2 = g_h2^T h1                                depth: rows
//   8. g_h1 = (g_h2 W2) * (h1 > 0)                    over X1 in place
//   9. dW1 = g_h1^T x                                 depth: rows
//  10. column sums of RV, g_h2 and g_h1 over the rows: the bias and
//      log-sigma gradients and the aux sums
//  11. the fixed-order sum of the row slices' partials into grad and aux.
// Every product (1-3, 5-9) is one generic tiled kernel (`gemm_kernel`):
// C = A B on 64 x 64 tiles, 16 deep, a thread owning a 4 x 4 block of C,
// float32 FMAs, the operands read through strides (so that no operand is
// transposed in memory) and rounded to bf16 as they enter shared memory.
// A product of two bf16 values is exact in float32, so this is what the
// tensor cores would compute, up to the order of the sums. One launch
// takes the product of every tower (blockIdx.y); towers whose product has
// another shape (the heads) exit in the blocks they do not need.
// The products whose depth is the rows (5, 7, 9) and the column sums (10)
// are split into slices of at least ROWS_MIN rows (blockIdx.z), each
// slice writing its own partial; 11 sums the partials in slice order. The
// column sums and 11 add in float64. No float atomics and fixed summation
// orders, so a launch reproduces bit for bit.
// The f32 form takes the row loss (4) in float64, as the tuned f32 form
// does: each row's log-prob carries the float32 rounding of its constant
// terms alike, and over many rows that would dominate the aux sums' error.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ppo_any {
namespace {

constexpr int TMAX = 7;         // towers: the actor and up to 6 critics
constexpr int MMAX = 5;         // constraints
constexpr int AUXW = 8;         // aux sums a tower
constexpr int BM = 64, BN = 64, BK = 16;   // a product's tile
constexpr int NT = 256;         // threads of a product's block
constexpr int NT_ROW = 128;     // threads of the other kernels' blocks
constexpr int ROWS_MIN = 512;   // rows of a slice, at least
constexpr int SMAX = 64;        // row slices, at most
constexpr int FULL = 1 << 30;   // the depth of a product that is not split

// The flat parameter vector at widths (D, H1, H2, A, K): the actor's
// segments in order, then each critic segment stacked over the K critics.
// Segments s of tower t: 0 W1 (H1, D), 1 b1 (H1), 2 W2 (H2, H1), 3 b2 (H2),
// 4 head weight (O, H2), 5 head bias (O), 6 log-sigma (A, actor only).
struct Layout {
  int D, H1, H2, A, K;
  __host__ __device__ long seg_len(int t, int s) const {
    const long O = t == 0 ? A : 1;
    switch (s) {
      case 0: return (long)H1 * D;
      case 1: return H1;
      case 2: return (long)H2 * H1;
      case 3: return H2;
      case 4: return O * H2;
      case 5: return O;
      case 6: return t == 0 ? A : 0;
      default: return 0;
    }
  }
  __host__ __device__ long local_off(int t, int s) const {
    long o = 0;
    for (int i = 0; i < s; ++i) o += seg_len(t, i);
    return o;
  }
  __host__ __device__ long tower_size(int t) const { return local_off(t, 7); }
  __host__ __device__ long global_off(int t, int s) const {
    if (t == 0) return local_off(0, s);
    long base = tower_size(0);
    for (int i = 0; i < s; ++i) base += K * seg_len(1, i);
    return base + (t - 1) * seg_len(1, s);
  }
  // A slice's partial of one tower: its gradient in tower-local order,
  // then its AUXW aux sums (actor: sum(logp_old - logp), sum(min
  // surrogate), 0, sum(ratio * cadv_m); critic: 0, 0, sum(diff^2)).
  __host__ __device__ long part_width() const { return tower_size(0) + AUXW; }
  // A row of RV: actor [g_mu (A) | d loss / d log-sigma (A) | kl | min
  // surrogate | 0 | ratio * cadv (M)], critic [g_v | 0 | 0 | diff^2].
  __host__ __device__ int rv_width() const { return 2 * A + 2 + K; }
  __host__ __device__ int rv_heads(int t) const { return t == 0 ? 2 * A : 1; }
  __host__ __device__ int rv_cols(int t) const {
    return t == 0 ? rv_width() : 4;
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------- products

// One tower's product C (M x N) = A (M x Kd) B (Kd x N): A(m, k) at
// a[m a_m + k a_k], B(k, n) at b[k b_k + n b_n], C(m, n) at c[m c_m + n c_n]
// (plus the slice's offset). `round`: both operands rounded to bf16.
struct Gemm {
  const float* a;
  const float* b;
  float* c;
  const float* bias;   // bias[n] (EPI_BIAS, EPI_BIAS_RELU)
  long a_m, a_k, b_k, b_n, c_m, c_n;
  int M, N, Kd, round;
};

enum Epi { EPI_STORE = 0, EPI_BIAS = 1, EPI_BIAS_RELU = 2, EPI_MASK = 3 };

struct GemmBatch {
  Gemm g[TMAX];   // blockIdx.y picks one
  int epi;
  int kps;        // depth of a slice (blockIdx.z): [z kps, (z + 1) kps)
  long c_split;   // offset of slice z's C: z c_split
};

__global__ void __launch_bounds__(NT)
    gemm_kernel(const __grid_constant__ GemmBatch p) {
  const Gemm& g = p.g[blockIdx.y];
  const int tn = (g.N + BN - 1) / BN, tm = (g.M + BM - 1) / BM;
  if ((int)blockIdx.x >= tm * tn) return;   // a tower of a smaller product
  const int m0 = (blockIdx.x / tn) * BM, n0 = (blockIdx.x % tn) * BN;
  const long k0 = (long)blockIdx.z * p.kps;
  const long k1 = k0 + p.kps < g.Kd ? k0 + p.kps : g.Kd;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // neighbouring threads read neighbouring addresses along whichever
  // index has stride 1
  const bool a_kfast = g.a_k == 1, b_kfast = g.b_k == 1;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long kt = k0; kt < k1; kt += BK) {
#pragma unroll
    for (int q = 0; q < BM * BK / NT; ++q) {
      const int e = tid + q * NT;
      const int m = a_kfast ? e / BK : e % BM;
      const int k = a_kfast ? e % BK : e / BM;
      const long gm = m0 + m, gk = kt + k;
      float v = 0.f;
      if (gm < g.M && gk < k1) v = g.a[gm * g.a_m + gk * g.a_k];
      As[k][m] = g.round ? round_bf16(v) : v;
    }
#pragma unroll
    for (int q = 0; q < BN * BK / NT; ++q) {
      const int e = tid + q * NT;
      const int n = b_kfast ? e / BK : e % BN;
      const int k = b_kfast ? e % BK : e / BN;
      const long gn = n0 + n, gk = kt + k;
      float v = 0.f;
      if (gn < g.N && gk < k1) v = g.b[gk * g.b_k + gn * g.b_n];
      Bs[k][n] = g.round ? round_bf16(v) : v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* c = g.c + (long)blockIdx.z * p.c_split;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long gm = m0 + 4 * ty + i;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long gn = n0 + 4 * tx + j;
      if (gn >= g.N) continue;
      float* dst = c + gm * g.c_m + gn * g.c_n;
      float v = acc[i][j];
      if (p.epi == EPI_BIAS) {
        v += g.bias[gn];
      } else if (p.epi == EPI_BIAS_RELU) {
        v = fmaxf(v + g.bias[gn], 0.f);
      } else if (p.epi == EPI_MASK) {
        v = *dst > 0.f ? v : 0.f;   // dst holds the activation
      }
      *dst = v;
    }
  }
}

// ---------------------------------------------------------------- row loss

struct LossArgs {
  float* rv;   // T x B x W row values; on entry column 0.. the heads
  const float *act, *logp_old, *adv, *ret, *lam, *resc, *lsig;
  int B, A, K, W;
  float clip_lo, clip_hi, gv_scale, a_log_sqrt_2pi;
};

__device__ __forceinline__ float r_exp(float x) { return expf(x); }
__device__ __forceinline__ double r_exp(double x) { return exp(x); }
__device__ __forceinline__ float r_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double r_tanh(double x) { return tanh(x); }

// One thread a row of one tower (blockIdx.y). The actor's arithmetic in
// Real: float (the bf16 form) or double (the f32 form).
template <class Real>
__global__ void __launch_bounds__(NT_ROW)
    loss_kernel(const __grid_constant__ LossArgs a) {
  const long r = (long)blockIdx.x * NT_ROW + threadIdx.x;
  const int t = blockIdx.y;
  if (r >= a.B) return;
  float* row = a.rv + ((long)t * a.B + r) * a.W;
  if (t > 0) {
    const float diff = row[0] - a.ret[r * a.K + (t - 1)];
    row[0] = a.gv_scale * diff;
    row[1] = 0.f;
    row[2] = 0.f;
    row[3] = diff * diff;
    return;
  }
  const float* act = a.act + r * a.A;
  const float* adv = a.adv + r * a.K;
  Real lsig_sum = 0, sq = 0;
  for (int i = 0; i < a.A; ++i) {
    lsig_sum += (Real)a.lsig[i];
    const Real mu = r_tanh((Real)row[i]);
    const Real z = ((Real)act[i] - mu) / r_exp((Real)a.lsig[i]);
    sq += (Real)-0.5 * z * z;
  }
  const Real c = sizeof(Real) == sizeof(float)
                     ? (Real)a.a_log_sqrt_2pi
                     : (Real)a.A * (Real)0.91893853320467274178;
  const Real logp = sq - lsig_sum - c;
  const Real logp_old = a.logp_old[r];
  const Real ratio = r_exp(logp - logp_old);
  const Real advr = adv[0];
  const Real lo = a.clip_lo, hi = a.clip_hi;
  const Real rc = ratio < lo ? lo : (ratio > hi ? hi : ratio);
  const Real s1 = ratio * advr, s2 = rc * advr;
  // JAX's conventions: d min(s1, s2) splits 0.5 / 0.5 where s1 == s2, the
  // clip passes 0.5 where ratio == 1 +- eps
  const Real w1 = s1 < s2 ? (Real)1 : (s1 == s2 ? (Real)0.5 : (Real)0);
  const Real w2 = (Real)1 - w1;
  const Real inside = (ratio > lo && ratio < hi)
                          ? (Real)1
                          : ((ratio == lo || ratio == hi) ? (Real)0.5
                                                          : (Real)0);
  const Real dmin = advr * (w1 + w2 * inside);
  Real lsum = 0;
  for (int m = 0; m < a.K - 1; ++m) lsum += (Real)adv[1 + m] * (Real)a.lam[m];
  const Real g_ratio = (Real)a.resc[0] * (-dmin + lsum) / (Real)a.B;
  const Real g_logp = g_ratio * ratio;
  for (int i = 0; i < a.A; ++i) {
    const Real sig = r_exp((Real)a.lsig[i]);
    const Real mu = r_tanh((Real)row[i]);
    const Real z = ((Real)act[i] - mu) / sig;
    row[i] = (float)(g_logp * (z / sig) * ((Real)1 - mu * mu));
    row[a.A + i] = (float)(g_logp * (z * z - (Real)1));
  }
  float* aux = row + 2 * a.A;
  aux[0] = (float)(logp_old - logp);
  aux[1] = (float)(s1 < s2 ? s1 : s2);
  aux[2] = 0.f;
  for (int m = 0; m < a.K - 1; ++m) aux[3 + m] = (float)(ratio * (Real)adv[1 + m]);
}

// ------------------------------------------------------------- column sums

// The sum over a slice of rows of each column c < ncols of m (row stride
// ld), into the slice's partial at dst1 + c (c < n1) or dst2 + c - n1.
// Summed in float64: a float32 sum of a slice's 512 or more rows in row
// order would carry ~sqrt(rows) roundings of its running sum, more than
// the aux sums' tolerance allows where they cancel.
struct ColSum {
  const float* m;
  long ld, dst1, dst2;
  int ncols, n1;
};

struct ColSumBatch {
  ColSum c[3 * TMAX];   // blockIdx.y picks one
  float* part;
  long part_split;      // floats of a slice's partial
  int B, rps;           // rows, rows of a slice (blockIdx.z)
};

__global__ void __launch_bounds__(NT_ROW)
    colsum_kernel(const __grid_constant__ ColSumBatch p) {
  const ColSum& cs = p.c[blockIdx.y];
  const int c = blockIdx.x * NT_ROW + threadIdx.x;
  if (c >= cs.ncols) return;
  const long r0 = (long)blockIdx.z * p.rps;
  const long r1 = r0 + p.rps < p.B ? r0 + p.rps : p.B;
  const float* src = cs.m + c;
  double s = 0.0;
  long r = r0;
  // eight loads in flight, added in row order
  for (; r + 8 <= r1; r += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = src[(r + u) * cs.ld];
#pragma unroll
    for (int u = 0; u < 8; ++u) s += (double)v[u];
  }
  for (; r < r1; ++r) s += (double)src[r * cs.ld];
  p.part[(long)blockIdx.z * p.part_split +
         (c < cs.n1 ? cs.dst1 + c : cs.dst2 + (c - cs.n1))] = (float)s;
}

// ------------------------------------------------------------------ reduce

// grad[global] = the sum of the S slices' partials, in slice order, in
// float64; the last block: aux[q] by thread q.
__global__ void __launch_bounds__(NT)
    reduce_kernel(const float* __restrict__ part, float* __restrict__ grad,
                  float* __restrict__ aux, const Layout L, int S) {
  const int T = L.K + 1;
  const long P = L.part_width(), stride = (long)T * P;
  const long aux0 = L.tower_size(0);
  if (blockIdx.x == gridDim.x - 1) {
    const int q = threadIdx.x;
    if (q >= AUXW) return;
    double s = 0.0;
    if (q == 2) {
      for (int z = 0; z < S; ++z)
        for (int t = 1; t < T; ++t) s += part[z * stride + t * P + aux0 + q];
    } else if (q < 3 + L.K - 1) {
      for (int z = 0; z < S; ++z) s += part[z * stride + aux0 + q];
    }
    aux[q] = (float)s;
    return;
  }
  const long id = (long)blockIdx.x * NT + threadIdx.x;
  if (id >= (long)T * P) return;
  const int t = (int)(id / P);
  const long l = id % P;
  if (l >= L.tower_size(t)) return;
  double s = 0.0;
  for (int z = 0; z < S; ++z) s += part[z * stride + id];
  int seg = 0;
  while (l >= L.local_off(t, seg + 1)) ++seg;
  grad[L.global_off(t, seg) + (l - L.local_off(t, seg))] = (float)s;
}

// ------------------------------------------------------------------- host

bool valid(int B, int D, int H1, int H2, int A, int K) {
  return B >= 1 && D >= 1 && H1 >= 1 && H2 >= 1 && A >= 1 && K >= 1 &&
         K - 1 <= MMAX;
}

// Row slices of the products whose depth is the rows: one a ROWS_MIN
// rows, at most SMAX.
int splits(int B) {
  const int s = (B + ROWS_MIN - 1) / ROWS_MIN;
  return s < SMAX ? s : SMAX;
}

long part_floats(const Layout& L, int S) {
  return (long)S * (L.K + 1) * L.part_width();
}

long scratch_floats(int B, const Layout& L) {
  const long T = L.K + 1;
  return T * B * ((long)L.H1 + L.H2 + L.rv_width()) +
         part_floats(L, splits(B));
}

cudaError_t launch_gemm(const GemmBatch& gb, int T, int S, cudaStream_t s) {
  int tiles = 1;
  for (int t = 0; t < T; ++t) {
    const Gemm& g = gb.g[t];
    const int n = ((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN);
    if (n > tiles) tiles = n;
  }
  gemm_kernel<<<dim3(tiles, T, S), NT, 0, s>>>(gb);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* part, float* grad, float* aux,
                          const Layout& L, int S, cudaStream_t s) {
  const long n = (long)(L.K + 1) * L.part_width();
  reduce_kernel<<<(unsigned)((n + NT - 1) / NT + 1), NT, 0, s>>>(
      part, grad, aux, L, S);
  return cudaGetLastError();
}

#define FSRL_TRY(x)                          \
  do {                                       \
    const cudaError_t err_ = (x);            \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

cudaError_t run(const float* params, const float* obs, const float* act,
                const float* logp_old, const float* adv, const float* ret,
                const float* lam, const float* resc, float* grad, float* aux,
                float* scratch, int B, const Layout& L, bool bf16,
                float clip_lo, float clip_hi, float vf_coef, cudaStream_t s) {
  const int T = L.K + 1, D = L.D, H1 = L.H1, H2 = L.H2, A = L.A;
  const int W = L.rv_width(), S = splits(B);
  const int rps = (B + S - 1) / S;
  const long P = L.part_width();
  float* X1 = scratch;                        // h1, then g_h1
  float* X2 = X1 + (long)T * B * H1;          // h2, then g_h2
  float* RV = X2 + (long)T * B * H2;          // heads, then row values
  float* part = RV + (long)T * B * W;
  auto x1 = [&](int t) { return X1 + (long)t * B * H1; };
  auto x2 = [&](int t) { return X2 + (long)t * B * H2; };
  auto rv = [&](int t) { return RV + (long)t * B * W; };
  auto prm = [&](int t, int seg) { return params + L.global_off(t, seg); };
  auto prt = [&](int t, int seg) { return part + t * P + L.local_off(t, seg); };
  const int rb = (int)bf16;
  GemmBatch gb{};

  // 1. h1 = relu(x W1^T + b1)
  gb.epi = EPI_BIAS_RELU;
  gb.kps = FULL;
  for (int t = 0; t < T; ++t)
    gb.g[t] = Gemm{obs, prm(t, 0), x1(t), prm(t, 1), D, 1, 1, D, H1, 1,
                   B, H1, D, rb};
  FSRL_TRY(launch_gemm(gb, T, 1, s));
  // 2. h2 = relu(h1 W2^T + b2)
  for (int t = 0; t < T; ++t)
    gb.g[t] = Gemm{x1(t), prm(t, 2), x2(t), prm(t, 3), H1, 1, 1, H1, H2, 1,
                   B, H2, H1, rb};
  FSRL_TRY(launch_gemm(gb, T, 1, s));
  // 3. the heads: the actor's mean head in float32, the critics' value
  // heads on rounded operands
  gb.epi = EPI_BIAS;
  gb.g[0] = Gemm{x2(0), prm(0, 4), rv(0), prm(0, 5), H2, 1, 1, H2, W, 1,
                 B, A, H2, 0};
  for (int t = 1; t < T; ++t)
    gb.g[t] = Gemm{x2(t), prm(t, 4), rv(t), prm(t, 5), H2, 1, 1, H2, W, 1,
                   B, 1, H2, rb};
  FSRL_TRY(launch_gemm(gb, T, 1, s));
  // 4. the row loss
  const LossArgs la{RV, act, logp_old, adv, ret, lam, resc, prm(0, 6), B, A,
                    L.K, W, clip_lo, clip_hi,
                    (float)(2.0 * (double)vf_coef / (double)B),
                    (float)(A * 0.91893853320467274178)};
  const dim3 rows_grid((B + NT_ROW - 1) / NT_ROW, T);
  if (bf16)
    loss_kernel<float><<<rows_grid, NT_ROW, 0, s>>>(la);
  else
    loss_kernel<double><<<rows_grid, NT_ROW, 0, s>>>(la);
  FSRL_TRY(cudaGetLastError());
  // 5. the head weights' gradients, depth the rows, by slices
  gb.epi = EPI_STORE;
  gb.kps = rps;
  gb.c_split = (long)T * P;
  gb.g[0] = Gemm{rv(0), x2(0), prt(0, 4), nullptr, 1, W, H2, 1, H2, 1,
                 A, H2, B, 0};
  for (int t = 1; t < T; ++t)
    gb.g[t] = Gemm{rv(t), x2(t), prt(t, 4), nullptr, 1, W, H2, 1, H2, 1,
                   1, H2, B, rb};
  FSRL_TRY(launch_gemm(gb, T, S, s));
  // 6. g_h2 = (g_out W_head) * (h2 > 0), over h2
  gb.epi = EPI_MASK;
  gb.kps = FULL;
  gb.c_split = 0;
  gb.g[0] = Gemm{rv(0), prm(0, 4), x2(0), nullptr, W, 1, H2, 1, H2, 1,
                 B, H2, A, 0};
  for (int t = 1; t < T; ++t)
    gb.g[t] = Gemm{rv(t), prm(t, 4), x2(t), nullptr, W, 1, H2, 1, H2, 1,
                   B, H2, 1, rb};
  FSRL_TRY(launch_gemm(gb, T, 1, s));
  // 7. dW2 = g_h2^T h1, by slices
  gb.epi = EPI_STORE;
  gb.kps = rps;
  gb.c_split = (long)T * P;
  for (int t = 0; t < T; ++t)
    gb.g[t] = Gemm{x2(t), x1(t), prt(t, 2), nullptr, 1, H2, H1, 1, H1, 1,
                   H2, H1, B, rb};
  FSRL_TRY(launch_gemm(gb, T, S, s));
  // 8. g_h1 = (g_h2 W2) * (h1 > 0), over h1
  gb.epi = EPI_MASK;
  gb.kps = FULL;
  gb.c_split = 0;
  for (int t = 0; t < T; ++t)
    gb.g[t] = Gemm{x2(t), prm(t, 2), x1(t), nullptr, H2, 1, H1, 1, H1, 1,
                   B, H1, H2, rb};
  FSRL_TRY(launch_gemm(gb, T, 1, s));
  // 9. dW1 = g_h1^T x, by slices
  gb.epi = EPI_STORE;
  gb.kps = rps;
  gb.c_split = (long)T * P;
  for (int t = 0; t < T; ++t)
    gb.g[t] = Gemm{x1(t), obs, prt(t, 0), nullptr, 1, H1, D, 1, D, 1,
                   H1, D, B, rb};
  FSRL_TRY(launch_gemm(gb, T, S, s));
  // 10. column sums: bias and log-sigma gradients, aux sums
  ColSumBatch cb{};
  int widest = 1;
  for (int t = 0; t < T; ++t) {
    const long base = t * P;
    cb.c[3 * t] = ColSum{rv(t), W, base + L.local_off(t, 5),
                         base + L.tower_size(0), L.rv_cols(t),
                         L.rv_heads(t)};
    cb.c[3 * t + 1] = ColSum{x2(t), H2, base + L.local_off(t, 3), 0, H2, H2};
    cb.c[3 * t + 2] = ColSum{x1(t), H1, base + L.local_off(t, 1), 0, H1, H1};
    const int w = L.rv_cols(t) > H1 ? L.rv_cols(t) : H1;
    widest = w > widest ? w : widest;
    widest = H2 > widest ? H2 : widest;
  }
  cb.part = part;
  cb.part_split = (long)T * P;
  cb.B = B;
  cb.rps = rps;
  colsum_kernel<<<dim3((widest + NT_ROW - 1) / NT_ROW, 3 * T, S), NT_ROW, 0,
                  s>>>(cb);
  FSRL_TRY(cudaGetLastError());
  // 11. the slices' sum
  return launch_reduce(part, grad, aux, L, S, s);
}

}  // namespace
}  // namespace ppo_any

using namespace ppo_any;

// Floats of scratch that a launch at (B, D, H1, H2, A, K) takes.
extern "C" long fsrl_ppo_grad_any_scratch_floats(int B, int D, int H1, int H2,
                                                 int A, int K) {
  if (!valid(B, D, H1, H2, A, K)) return -1;
  return scratch_floats(B, Layout{D, H1, H2, A, K});
}

// Row slices that the products over the rows are split into at B rows.
extern "C" int fsrl_ppo_grad_any_splits(int B) { return splits(B); }

// The largest shared memory of the form's kernels (all static, the same at
// every shape), in bytes.
extern "C" long fsrl_ppo_grad_any_smem_bytes() {
  cudaFuncAttributes at[5];
  cudaFuncGetAttributes(&at[0], gemm_kernel);
  cudaFuncGetAttributes(&at[1], loss_kernel<float>);
  cudaFuncGetAttributes(&at[2], loss_kernel<double>);
  cudaFuncGetAttributes(&at[3], colsum_kernel);
  cudaFuncGetAttributes(&at[4], reduce_kernel);
  long most = 0;
  for (const auto& a : at)
    most = (long)a.sharedSizeBytes > most ? (long)a.sharedSizeBytes : most;
  return most;
}

// params: flat parameter vector; obs (B, D), act (B, A), logp_old (B,),
// adv (B, K) normalized, ret (B, K), lam (K - 1,), resc (): float32 on the
// device. grad: flat gradient (the layout of params); aux: 8 floats.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int fsrl_ppo_grad_any(const float* params, const float* obs,
                                 const float* act, const float* logp_old,
                                 const float* adv, const float* ret,
                                 const float* lam, const float* resc,
                                 float* grad, float* aux, float* scratch,
                                 int B, int D, int H1, int H2, int A, int K,
                                 int bf16, long scratch_n, float clip_lo,
                                 float clip_hi, float vf_coef, void* stream) {
  if (!valid(B, D, H1, H2, A, K)) return (int)cudaErrorInvalidValue;
  const Layout L{D, H1, H2, A, K};
  if (scratch_n < scratch_floats(B, L)) return (int)cudaErrorInvalidValue;
  return (int)run(params, obs, act, logp_old, adv, ret, lam, resc, grad, aux,
                  scratch, B, L, bf16 != 0, clip_lo, clip_hi, vf_coef,
                  (cudaStream_t)stream);
}

// The last launch alone, on partials already in scratch (for timing it).
extern "C" int fsrl_ppo_grad_any_reduce_only(const float* scratch,
                                             float* grad, float* aux, int B,
                                             int D, int H1, int H2, int A,
                                             int K, void* stream) {
  if (!valid(B, D, H1, H2, A, K)) return (int)cudaErrorInvalidValue;
  const Layout L{D, H1, H2, A, K};
  const long T = K + 1;
  const float* part =
      scratch + T * B * ((long)H1 + H2 + L.rv_width());
  return (int)launch_reduce(part, grad, aux, L, splits(B),
                            (cudaStream_t)stream);
}
