// Fused PPO-Lagrangian minibatch loss gradient: actor and K critic towers,
// forward and hand-derived backward, in one launch plus a reduce launch.
//
// Replaces: fsrl_tpu/ops/fused_ppo_grad.py `_kernel` (entry
// `ppo_grad_minibatch`). That Pallas kernel walks the minibatch in row
// chunks on one TPU core and accumulates every gradient into one resident
// output block with `+=`, relying on the grid running in order.
//
// Bound on this card: operations. Per row and tower the forward and
// backward take three 128x128 matmul-vector products (h1 W2, h1^T g_h2,
// g_h2 W2^T) plus small ones: ~312k FLOP per row for 3 towers, ~10.2 GFLOP
// per launch at 32768 rows, ~10 us at the bf16 tensor-core peak of
// 989 TFLOP/s. The inputs are ~2.5 MB. This first version uses the FP32
// pipes (67 TFLOP/s peak), not the tensor cores, so its floor is ~150 us.
//
// Design:
// * Grid (G, 1+K): blockIdx.y picks the tower (0 = actor, 1..K = critics).
//   The actor and each critic depend only on their own parameters, so
//   towers never exchange data. Each block loops over row chunks
//   c = blockIdx.x, blockIdx.x + G, ...; G is chosen so the grid about
//   fills the SMs once.
// * No accumulation across blocks: each block keeps its tower's gradient
//   partial (H*H in registers, 8x8 per thread; the rest in shared memory),
//   writes it to scratch once, and a second kernel sums the G partials in a
//   fixed order. No float atomics, so runs reproduce bit for bit.
// * A chunk is 128 rows. x, h1, h2 (later g_h2) and W2 live in shared
//   memory (~218 KB at D=9); the three large products use an interleaved
//   8x8 register tile per thread over a 16x16 thread grid, with a row
//   stride of H+1 floats so row and column reads are both free of bank
//   conflicts. The ragged last chunk is masked: its rows get zero
//   gradient and no aux contribution.
// * Tie conventions are JAX's (fused_ppo_grad.py:103-111): d min(s1, s2)
//   splits 0.5/0.5 where s1 == s2, and the clip passes 0.5 where
//   ratio == 1 +- eps.
// * bf16 (BF = true): every matmul operand that the Pallas kernel casts to
//   bf16 is rounded with __float2bfloat16 and multiplied in f32, which is
//   exact, with f32 accumulation. Activations, biases, the actor's mean head
//   and every bias gradient stay f32, as in the Pallas kernel.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int H = 128;      // hidden width (both layers)
constexpr int R = 128;      // rows per chunk
constexpr int NT = 256;     // threads per block (16 x 16)
constexpr int HP = H + 1;   // padded shared-memory row stride
constexpr int DMAX = 12;    // largest observation width that fits
constexpr int AMAX = 4;     // largest action width
constexpr int MMAX = 5;     // largest number of constraints
constexpr int AUXW = 8;     // aux partial width per tower

template <bool BF>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

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

__host__ __device__ int smem_floats(int D) {
  return R * D + D * H + 2 * R * HP + H * HP + 2 * H + AMAX * H + AMAX +
         2 * R * AMAX + 2 * H + H * D + 2 * H + AMAX * H + 2 * AMAX + NT;
}

// Deterministic block sum of one value per thread; result valid in tid 0.
__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

template <bool BF>
__global__ void __launch_bounds__(NT, 1)
ppo_grad_kernel(const float* __restrict__ params,
                const float* __restrict__ obs, const float* __restrict__ act,
                const float* __restrict__ logp_old,
                const float* __restrict__ adv, const float* __restrict__ ret,
                const float* __restrict__ lam,
                const float* __restrict__ resc_p, float* __restrict__ part,
                float* __restrict__ part_aux, int B, int D, int A, int K,
                float clip_lo, float clip_hi, float gv_scale,
                float a_log_sqrt_2pi) {
  extern __shared__ float sm[];
  const Layout L{D, A, K};
  const int tower = blockIdx.y;
  const int g = blockIdx.x, G = gridDim.x;
  const bool actor = tower == 0;
  const int O = actor ? A : 1;
  const int M = K - 1;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float* xs = sm;                  // [R][D]
  float* W1s = xs + R * D;         // [D][H]  (in, out)
  float* h1s = W1s + D * H;        // [R][HP] h1, later g_h1
  float* h2s = h1s + R * HP;       // [R][HP] h2, later g_h2
  float* W2s = h2s + R * HP;       // [H][HP] (in, out)
  float* b1s = W2s + H * HP;
  float* b2s = b1s + H;
  float* whs = b2s + H;            // [O][H] head weight
  float* bhs = whs + AMAX * H;
  float* gs = bhs + AMAX;          // [R][AMAX] per-row head gradient
  float* rowv = gs + R * AMAX;     // [R][AMAX] per-row d logp / d log-sigma
  float* colp = rowv + R * AMAX;   // [2][H] column partial sums
  float* pW1 = colp + 2 * H;       // [H][D] gradient partials from here on
  float* pb1 = pW1 + H * D;
  float* pb2 = pb1 + H;
  float* pWh = pb2 + H;            // [O][H]
  float* pbh = pWh + AMAX * H;
  float* pls = pbh + AMAX;
  float* red = pls + AMAX;         // [NT]

  const float* gW1 = params + L.global_off(tower, 0);
  const float* gb1 = params + L.global_off(tower, 1);
  const float* gW2 = params + L.global_off(tower, 2);
  const float* gb2 = params + L.global_off(tower, 3);
  const float* gWh = params + L.global_off(tower, 4);
  const float* gbh = params + L.global_off(tower, 5);
  const float* gls = params + L.global_off(0, 6);

  for (int i = tid; i < H * D; i += NT) {
    const int j = i / D, d = i % D;
    W1s[d * H + j] = rnd<BF>(gW1[i]);
    pW1[i] = 0.f;
  }
  for (int i = tid; i < H * H; i += NT) {
    const int j = i / H, k = i % H;
    W2s[k * HP + j] = rnd<BF>(gW2[i]);
  }
  for (int i = tid; i < H; i += NT) {
    b1s[i] = gb1[i];
    b2s[i] = gb2[i];
    pb1[i] = 0.f;
    pb2[i] = 0.f;
  }
  for (int i = tid; i < O * H; i += NT) {
    whs[i] = actor ? gWh[i] : rnd<BF>(gWh[i]);
    pWh[i] = 0.f;
  }
  if (tid < O) {
    bhs[tid] = gbh[tid];
    pbh[tid] = 0.f;
  }
  if (tid < AMAX) pls[tid] = 0.f;

  float lsig[AMAX], sig[AMAX], lsig_sum = 0.f, lamv[MMAX];
  if (actor) {
    for (int a = 0; a < A; ++a) {
      lsig[a] = gls[a];
      sig[a] = expf(lsig[a]);
      lsig_sum += lsig[a];
    }
  }
  for (int m = 0; m < M; ++m) lamv[m] = lam[m];
  const float resc = *resc_p;

  float dW2[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dW2[i][j] = 0.f;
  float a_kl = 0.f, a_mins = 0.f, a_vf = 0.f, a_c[MMAX];
  for (int m = 0; m < MMAX; ++m) a_c[m] = 0.f;

  const int n_chunks = (B + R - 1) / R;
  __syncthreads();
  for (int c = g; c < n_chunks; c += G) {
    const int r0 = c * R;
    const int nr = min(R, B - r0);

    for (int i = tid; i < R * D; i += NT)
      xs[i] = (i / D) < nr ? rnd<BF>(obs[(size_t)r0 * D + i]) : 0.f;
    __syncthreads();

    // h1 = relu(x W1 + b1)
    for (int i = tid; i < R * H; i += NT) {
      const int r = i / H, j = i % H;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += xs[r * D + d] * W1s[d * H + j];
      h1s[r * HP + j] = rnd<BF>(fmaxf(s + b1s[j], 0.f));
    }
    __syncthreads();

    // h2 = relu(h1 W2 + b2)
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < H; ++k) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = h1s[(ty + 16 * i) * HP + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = W2s[k * HP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = tx + 16 * j;
          h2s[(ty + 16 * i) * HP + col] = fmaxf(acc[i][j] + b2s[col], 0.f);
        }
    }
    __syncthreads();

    // per-row head, loss terms and the gradient at the head's output
    if (tid < R) {
      const int r = tid;
      const size_t row = (size_t)r0 + r;
      const bool live = r < nr;
      if (actor) {
        if (live) {
          float mu[AMAX], z[AMAX], sq = 0.f;
          for (int a = 0; a < A; ++a) {
            float s = 0.f;
            for (int j = 0; j < H; ++j) s += h2s[r * HP + j] * whs[a * H + j];
            mu[a] = tanhf(s + bhs[a]);
            z[a] = (act[row * A + a] - mu[a]) / sig[a];
            sq += -0.5f * z[a] * z[a];
          }
          const float logp = sq - lsig_sum - a_log_sqrt_2pi;
          const float lo = logp_old[row];
          const float ratio = expf(logp - lo);
          const float advr = adv[row * K];
          const float rc = fminf(fmaxf(ratio, clip_lo), clip_hi);
          const float s1 = ratio * advr, s2 = rc * advr;
          const float w1 = s1 < s2 ? 1.f : (s1 == s2 ? 0.5f : 0.f);
          const float w2 = 1.f - w1;
          const float inside =
              (ratio > clip_lo && ratio < clip_hi)
                  ? 1.f
                  : ((ratio == clip_lo || ratio == clip_hi) ? 0.5f : 0.f);
          const float dmin = advr * (w1 + w2 * inside);
          float lsum = 0.f;
          for (int m = 0; m < M; ++m) {
            const float ca = adv[row * K + 1 + m];
            lsum += ca * lamv[m];
            a_c[m] += ratio * ca;
          }
          const float g_ratio = resc * (-dmin + lsum) / (float)B;
          const float g_logp = g_ratio * ratio;
          for (int a = 0; a < A; ++a) {
            gs[r * AMAX + a] = g_logp * (z[a] / sig[a]) * (1.f - mu[a] * mu[a]);
            rowv[r * AMAX + a] = g_logp * (z[a] * z[a] - 1.f);
          }
          a_kl += lo - logp;
          a_mins += fminf(s1, s2);
        } else {
          for (int a = 0; a < A; ++a) {
            gs[r * AMAX + a] = 0.f;
            rowv[r * AMAX + a] = 0.f;
          }
        }
      } else {
        if (live) {
          float s = 0.f;
          for (int j = 0; j < H; ++j) s += rnd<BF>(h2s[r * HP + j]) * whs[j];
          const float diff = (s + bhs[0]) - ret[row * K + (tower - 1)];
          a_vf += diff * diff;
          gs[r * AMAX] = gv_scale * diff;
        } else {
          gs[r * AMAX] = 0.f;
        }
      }
    }
    __syncthreads();

    // head weight / bias / log-sigma gradients
    for (int o = tid; o < O * H; o += NT) {
      const int a = o / H, j = o % H;
      float s = 0.f;
      if (actor) {
        for (int r = 0; r < nr; ++r) s += h2s[r * HP + j] * gs[r * AMAX + a];
      } else {
        for (int r = 0; r < nr; ++r)
          s += rnd<BF>(h2s[r * HP + j]) * rnd<BF>(gs[r * AMAX]);
      }
      pWh[o] += s;
    }
    if (tid < O) {
      float s = 0.f;
      for (int r = 0; r < nr; ++r) s += gs[r * AMAX + tid];
      pbh[tid] += s;
    }
    if (actor && tid >= H && tid - H < A) {
      const int a = tid - H;
      float s = 0.f;
      for (int r = 0; r < nr; ++r) s += rowv[r * AMAX + a];
      pls[a] += s;
    }
    __syncthreads();

    // g_h2 = (g_head Wh) * (h2 > 0), in place of h2; column sums for b2
    {
      const int j = tid & (H - 1), half = tid >> 7;
      float cs = 0.f;
      for (int r = half; r < R; r += 2) {
        float s;
        if (actor) {
          s = 0.f;
          for (int a = 0; a < A; ++a) s += gs[r * AMAX + a] * whs[a * H + j];
        } else {
          s = rnd<BF>(gs[r * AMAX]) * whs[j];
        }
        const float gv = h2s[r * HP + j] > 0.f ? s : 0.f;
        cs += gv;
        h2s[r * HP + j] = rnd<BF>(gv);
      }
      colp[half * H + j] = cs;
    }
    __syncthreads();
    if (tid < H) pb2[tid] += colp[tid] + colp[H + tid];

    // dW2 += h1^T g_h2  (registers, [in k = ty+16i][out j = tx+16j])
    for (int r = 0; r < nr; ++r) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = h1s[r * HP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = h2s[r * HP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dW2[i][j] += a[i] * b[j];
    }
    __syncthreads();

    // g_h1 = (g_h2 W2^T) * (h1 > 0), in place of h1
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int jj = 0; jj < H; ++jj) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = h2s[(ty + 16 * i) * HP + jj];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = W2s[(tx + 16 * j) * HP + jj];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int idx = (ty + 16 * i) * HP + tx + 16 * j;
          h1s[idx] = h1s[idx] > 0.f ? acc[i][j] : 0.f;
        }
    }
    __syncthreads();

    // b1 column sums and dW1 += g_h1^T x  (torch layout [out j][in d])
    {
      const int j = tid & (H - 1), half = tid >> 7;
      float cs = 0.f;
      for (int r = half; r < R; r += 2) cs += h1s[r * HP + j];
      colp[half * H + j] = cs;
    }
    for (int o = tid; o < H * D; o += NT) {
      const int j = o / D, d = o % D;
      float s = 0.f;
      for (int r = 0; r < nr; ++r) s += rnd<BF>(h1s[r * HP + j]) * xs[r * D + d];
      pW1[o] += s;
    }
    __syncthreads();
    if (tid < H) pb1[tid] += colp[tid] + colp[H + tid];
  }
  __syncthreads();

  // one partial per block: [G][1+K][Pmax] gradients, [G][1+K][AUXW] aux
  const int T = K + 1;
  const int Pmax = L.tower_size(0);
  float* out = part + ((size_t)g * T + tower) * Pmax;
  for (int i = tid; i < H * D; i += NT) out[L.local_off(tower, 0) + i] = pW1[i];
  for (int i = tid; i < H; i += NT) {
    out[L.local_off(tower, 1) + i] = pb1[i];
    out[L.local_off(tower, 3) + i] = pb2[i];
  }
  {
    float* oW2 = out + L.local_off(tower, 2);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        oW2[(tx + 16 * j) * H + ty + 16 * i] = dW2[i][j];
  }
  for (int i = tid; i < O * H; i += NT) out[L.local_off(tower, 4) + i] = pWh[i];
  if (tid < O) out[L.local_off(tower, 5) + tid] = pbh[tid];
  if (actor && tid < A) out[L.local_off(0, 6) + tid] = pls[tid];

  float* oaux = part_aux + ((size_t)g * T + tower) * AUXW;
  if (actor) {
    float v = block_sum(a_kl, red);
    if (tid == 0) oaux[0] = v;
    v = block_sum(a_mins, red);
    if (tid == 0) oaux[1] = v;
    for (int m = 0; m < M; ++m) {
      v = block_sum(a_c[m], red);
      if (tid == 0) oaux[2 + m] = v;
    }
  } else {
    const float v = block_sum(a_vf, red);
    if (tid == 0) oaux[0] = v;
  }
}

// Sums the G block partials in a fixed order into the flat gradient and
// the aux row [sum(logp_old - logp), sum(min surrogate), sum_k sum(diff^2),
// sum(ratio * cadv_m) for m < M].
__global__ void ppo_grad_reduce(const float* __restrict__ part,
                                const float* __restrict__ part_aux,
                                float* __restrict__ grad,
                                float* __restrict__ aux, int G, int D, int A,
                                int K) {
  const Layout L{D, A, K};
  const int T = K + 1;
  const int Pmax = L.tower_size(0);
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  if (id < T * Pmax) {
    const int t = id / Pmax, l = id % Pmax;
    if (l >= L.tower_size(t)) return;
    float s = 0.f;
    for (int b = 0; b < G; ++b) s += part[((size_t)b * T + t) * Pmax + l];
    int seg = 0;
    while (l >= L.local_off(t, seg + 1)) ++seg;
    grad[L.global_off(t, seg) + (l - L.local_off(t, seg))] = s;
  } else if (id - T * Pmax < AUXW) {
    const int q = id - T * Pmax;
    float s = 0.f;
    if (q < 2) {
      for (int b = 0; b < G; ++b) s += part_aux[(size_t)b * T * AUXW + q];
    } else if (q == 2) {
      for (int b = 0; b < G; ++b)
        for (int t = 1; t < T; ++t) s += part_aux[((size_t)b * T + t) * AUXW];
    } else if (q - 3 < K - 1) {
      for (int b = 0; b < G; ++b)
        s += part_aux[(size_t)b * T * AUXW + 2 + (q - 3)];
    }
    aux[q] = s;
  }
}

int grid_g(int B, int K) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_chunks = (B + R - 1) / R;
  int G = sms / (K + 1);
  if (G < 1) G = 1;
  if (G > n_chunks) G = n_chunks;
  return G;
}

}  // namespace

extern "C" long fsrl_ppo_grad_scratch_floats(int B, int D, int Hd, int A,
                                             int K) {
  const Layout L{D, A, K};
  return (long)grid_g(B, K) * (K + 1) * (L.tower_size(0) + AUXW);
}

// params: flat parameter vector; obs (B,D), act (B,A), logp_old (B,),
// adv (B,K) normalized, ret (B,K), lam (K-1,), resc (): float32 on device.
// grad: flat gradient (same layout as params); aux: 8 floats.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int fsrl_ppo_grad(const float* params, const float* obs,
                             const float* act, const float* logp_old,
                             const float* adv, const float* ret,
                             const float* lam, const float* resc, float* grad,
                             float* aux, float* scratch, int B, int D, int Hd,
                             int A, int K, int bf16, long scratch_floats,
                             float clip_lo, float clip_hi, float vf_coef,
                             void* stream) {
  if (Hd != H || D < 1 || D > DMAX || A < 1 || A > AMAX || K < 1 ||
      K - 1 > MMAX || B < 1 ||
      scratch_floats < fsrl_ppo_grad_scratch_floats(B, D, Hd, A, K))
    return (int)cudaErrorInvalidValue;
  const Layout L{D, A, K};
  const int G = grid_g(B, K);
  const int T = K + 1;
  float* part = scratch;
  float* part_aux = scratch + (size_t)G * T * L.tower_size(0);
  const size_t smem = sizeof(float) * smem_floats(D);
  const float gv_scale = (float)(2.0 * (double)vf_coef / (double)B);
  const float a_l2p = (float)(A * 0.91893853320467274178);
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(G, T);
  if (bf16) {
    cudaFuncSetAttribute(ppo_grad_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ppo_grad_kernel<true><<<grid, NT, smem, s>>>(
        params, obs, act, logp_old, adv, ret, lam, resc, part, part_aux, B,
        D, A, K, clip_lo, clip_hi, gv_scale, a_l2p);
  } else {
    cudaFuncSetAttribute(ppo_grad_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ppo_grad_kernel<false><<<grid, NT, smem, s>>>(
        params, obs, act, logp_old, adv, ret, lam, resc, part, part_aux, B,
        D, A, K, clip_lo, clip_hi, gv_scale, a_l2p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = T * L.tower_size(0) + AUXW;
  ppo_grad_reduce<<<(n + 255) / 256, 256, 0, s>>>(part, part_aux, grad, aux,
                                                   G, D, A, K);
  return (int)cudaGetLastError();
}
