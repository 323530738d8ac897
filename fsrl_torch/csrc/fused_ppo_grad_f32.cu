// Fused PPO-Lagrangian minibatch loss gradient in float32 on the FMA pipes:
// the kernel behind `compute_dtype` None / float32. Same grid, partials and
// reduce launch as the bf16 tensor-core kernel in fused_ppo_grad.cu, which
// holds the entry point; see there for what the kernel computes.
//
// Replaces: fsrl_tpu/ops/fused_ppo_grad.py `_kernel` run with
// compute_dtype=None. float32 on the tensor cores would be TF32, another
// result, so this kernel stays on the FP32 pipes.
//
// Bound on this card: operations on the FP32 pipes (67 TFLOP/s peak):
// ~312k FLOP per row for 3 towers, ~10.2 GFLOP per launch at 32768 rows,
// ~0.15 ms.
//
// Design: a chunk is 128 rows. x, h1, h2 (later g_h2) and W2 live in shared
// memory as float32 (~218 KB at D=9, one block per SM); the three large
// products use an interleaved 8x8 register tile per thread over a 16x16
// thread grid, with a row stride of H+1 floats so row and column reads are
// both free of bank conflicts. The H*H gradient partial stays in registers
// (8x8 per thread) across the block's chunks; the rest accumulates in shared
// memory. The ragged last chunk is masked: its rows get zero gradient and no
// aux contribution.

#include "ppo_grad_common.cuh"

namespace ppo {
namespace {

constexpr int HP = H + 1;   // padded shared-memory row stride

// Deterministic block sum of one value per thread; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
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

__host__ __device__ int smem_floats(int D) {
  return R * D + D * H + 2 * R * HP + H * HP + 2 * H + AMAX * H + AMAX +
         2 * R * AMAX + 2 * H + H * D + 2 * H + AMAX * H + 2 * AMAX + NT;
}

__global__ void __launch_bounds__(NT, 1)
ppo_grad_f32_kernel(const Args p) {
  extern __shared__ float sm[];
  const float* __restrict__ params = p.params;
  const float* __restrict__ obs = p.obs;
  const float* __restrict__ adv = p.adv;
  const float* __restrict__ ret = p.ret;
  const int B = p.B, D = p.D, A = p.A, K = p.K;
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
    W1s[d * H + j] = gW1[i];
    pW1[i] = 0.f;
  }
  for (int i = tid; i < H * H; i += NT) {
    const int j = i / H, k = i % H;
    W2s[k * HP + j] = gW2[i];
  }
  for (int i = tid; i < H; i += NT) {
    b1s[i] = gb1[i];
    b2s[i] = gb2[i];
    pb1[i] = 0.f;
    pb2[i] = 0.f;
  }
  for (int i = tid; i < O * H; i += NT) {
    whs[i] = gWh[i];
    pWh[i] = 0.f;
  }
  if (tid < O) {
    bhs[tid] = gbh[tid];
    pbh[tid] = 0.f;
  }
  if (tid < AMAX) pls[tid] = 0.f;

  float sig[AMAX], lsig_sum = 0.f, lamv[MMAX];
#pragma unroll
  for (int a = 0; a < AMAX; ++a) {
    const float ls = (actor && a < A) ? gls[a] : 0.f;
    sig[a] = expf(ls);
    lsig_sum += ls;
  }
#pragma unroll
  for (int m = 0; m < MMAX; ++m) lamv[m] = m < M ? p.lam[m] : 0.f;
  const float resc = *p.resc;

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
      xs[i] = (i / D) < nr ? obs[(size_t)r0 * D + i] : 0.f;
    __syncthreads();

    // h1 = relu(x W1 + b1)
    for (int i = tid; i < R * H; i += NT) {
      const int r = i / H, j = i % H;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += xs[r * D + d] * W1s[d * H + j];
      h1s[r * HP + j] = fmaxf(s + b1s[j], 0.f);
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
          float s[AMAX];
#pragma unroll
          for (int a = 0; a < AMAX; ++a) {
            s[a] = 0.f;
            if (a < A) {
              for (int j = 0; j < H; ++j)
                s[a] += h2s[r * HP + j] * whs[a * H + j];
              s[a] += bhs[a];
            }
          }
          const ActorRow o =
              actor_row(s, p.act + row * A, p.logp_old[row], adv + row * K,
                        sig, lsig_sum, lamv, resc, p);
#pragma unroll
          for (int a = 0; a < AMAX; ++a)
            if (a < A) {
              gs[r * AMAX + a] = o.g_mu[a];
              rowv[r * AMAX + a] = o.g_ls[a];
            }
#pragma unroll
          for (int m = 0; m < MMAX; ++m)
            if (m < M) a_c[m] += o.ratio * adv[row * K + 1 + m];
          a_kl += o.kl;
          a_mins += o.mins;
        } else {
          for (int a = 0; a < A; ++a) {
            gs[r * AMAX + a] = 0.f;
            rowv[r * AMAX + a] = 0.f;
          }
        }
      } else {
        if (live) {
          float s = 0.f;
          for (int j = 0; j < H; ++j) s += h2s[r * HP + j] * whs[j];
          const float diff = (s + bhs[0]) - ret[row * K + (tower - 1)];
          a_vf += diff * diff;
          gs[r * AMAX] = p.gv_scale * diff;
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
      for (int r = 0; r < nr; ++r) s += h2s[r * HP + j] * gs[r * AMAX + a];
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
          s = gs[r * AMAX] * whs[j];
        }
        const float gv = h2s[r * HP + j] > 0.f ? s : 0.f;
        cs += gv;
        h2s[r * HP + j] = gv;
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
      for (int r = 0; r < nr; ++r) s += h1s[r * HP + j] * xs[r * D + d];
      pW1[o] += s;
    }
    __syncthreads();
    if (tid < H) pb1[tid] += colp[tid] + colp[H + tid];
  }
  __syncthreads();

  // one partial per block: [G][1+K][Pmax] gradients, [G][1+K][AUXW] aux
  const int T = K + 1;
  const int Pmax = L.tower_size(0);
  float* out = p.part + ((size_t)g * T + tower) * Pmax;
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

  float* oaux = p.part_aux + ((size_t)g * T + tower) * AUXW;
  if (actor) {
    float v = block_sum(a_kl, red);
    if (tid == 0) oaux[0] = v;
    v = block_sum(a_mins, red);
    if (tid == 0) oaux[1] = v;
#pragma unroll
    for (int m = 0; m < MMAX; ++m)
      if (m < M) {
        v = block_sum(a_c[m], red);
        if (tid == 0) oaux[2 + m] = v;
      }
  } else {
    const float v = block_sum(a_vf, red);
    if (tid == 0) oaux[0] = v;
  }
}

}  // namespace

cudaError_t launch_f32(const Args& a, int G, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.D);
  cudaFuncSetAttribute(ppo_grad_f32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ppo_grad_f32_kernel<<<dim3(G, a.K + 1), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ppo
