// GAE over stacked (reward, cost) value channels: one reverse linear
// recurrence per column of the time-major (T, N*K) view.
//
// Replaces: fsrl_tpu/ops/pallas_gae.py `_gae_kernel` / `_gae_pallas_2d`
// (entry `gae_advantages_pallas`). The Pallas wrapper forms
// delta = m + gamma*v' - v and disc = (1 - end)*gamma*lam in XLA, pads the
// column axis to 128 lanes, runs the recurrence per (T, 128) block in VMEM
// and adds the values back afterwards.
//
// Bound on this card: memory. Each element is touched once (3 f32 reads, 2
// f32 writes, plus one flag byte per env and step): at T=64, N=4096, K=2
// that is ~10.7 MB, ~3.2 us at 3.35 TB/s. There is almost no arithmetic.
//
// Design: one thread per column, adjacent threads on adjacent columns, so
// every load and store of a time step is coalesced. The kernel walks t from
// T-1 down to 0 with the carry in a register and fuses the prologue (delta,
// disc) and the epilogue (ret = adv + v), so nothing is padded or written
// twice; the ragged edge is masked. The arithmetic is spelled with
// __fmul_rn/__fadd_rn so the compiler does not contract it into FMAs: the
// result is then the sequential reference's, rounding for rounding.

#include <cstdint>
#include <cuda_runtime.h>

__global__ void gae_kernel(const float* __restrict__ m,
                           const float* __restrict__ v,
                           const float* __restrict__ vn,
                           const uint8_t* __restrict__ end,
                           float* __restrict__ adv, float* __restrict__ ret,
                           int T, int N, int K, float gamma, float gl) {
  const int cols = N * K;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int n = c / K;
  float gae = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = (size_t)t * cols + c;
    const float vt = v[i];
    // delta = (m + gamma * v') - v, in the reference's order
    const float delta = __fadd_rn(__fadd_rn(m[i], __fmul_rn(gamma, vn[i])),
                                  -vt);
    const float disc = end[(size_t)t * N + n] ? 0.0f : gl;
    gae = __fadd_rn(delta, __fmul_rn(disc, gae));
    adv[i] = gae;
    ret[i] = __fadd_rn(gae, vt);
  }
}

extern "C" int fsrl_gae(const float* m, const float* v, const float* vn,
                        const uint8_t* end, float* adv, float* ret, int T,
                        int N, int K, float gamma, float gl, void* stream) {
  const int cols = N * K;
  const int threads = 128;
  const int blocks = (cols + threads - 1) / threads;
  if (blocks > 0)
    gae_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        m, v, vn, end, adv, ret, T, N, K, gamma, gl);
  return (int)cudaGetLastError();
}
