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
// Design: the recurrence is serial in t, its inputs are not, so the loads
// are taken out of the serial loop.
// * A block owns a strip of CW = 32 columns, so 8192 columns make 256 blocks
//   of 256 threads, several to an SM, all resident at once.
// * Phase 1, all threads: load the strip's m, v, v' (16 bytes a thread where
//   the column count and the pointers allow, else 4) and the end flags for a
//   tile of up to TT = 64 steps, form delta and disc, and put delta, disc
//   and v into shared memory (24 KB). Every load of the tile is in flight
//   before any is used.
// * Phase 2, one thread per column: the recurrence out of shared memory,
//   adv left in place of delta.
// * Phase 3, all threads: adv and ret = adv + v written back, coalesced.
// * A T above TT walks the time tiles from the end with the carry kept in
//   the column thread's register. Ragged edges in T and columns are masked;
//   nothing is padded or written twice.
// The arithmetic is spelled with __fmul_rn/__fadd_rn in the sequential
// reference's order, so the compiler does not contract it into FMAs and the
// result is the reference's, rounding for rounding.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CW = 32;    // columns per block
constexpr int TT = 64;    // time steps per tile
constexpr int NT = 256;   // threads per block

// V = 4: 16-byte accesses (columns a multiple of 4, pointers aligned);
// V = 1: 4-byte accesses.
template <int V>
__global__ void __launch_bounds__(NT)
gae_kernel(const float* __restrict__ m, const float* __restrict__ v,
           const float* __restrict__ vn, const uint8_t* __restrict__ end,
           float* __restrict__ adv, float* __restrict__ ret, int T, int N,
           int K, float gamma, float gl) {
  __shared__ __align__(16) float s_adv[TT][CW];   // delta, then adv
  __shared__ __align__(16) float s_disc[TT][CW];
  __shared__ __align__(16) float s_v[TT][CW];
  struct alignas(4 * V) Vec { float f[V]; };
  constexpr int GW = CW / V;   // accesses per row of the strip
  const int cols = N * K;
  const int c0 = blockIdx.x * CW;
  const int tid = threadIdx.x;
  float gae = 0.0f;
  for (int t_hi = T; t_hi > 0; t_hi -= TT) {
    const int t0 = t_hi > TT ? t_hi - TT : 0;
    const int nt = t_hi - t0;
#pragma unroll 2
    for (int i = tid; i < nt * GW; i += NT) {
      const int tl = i / GW, cl = V * (i % GW), c = c0 + cl;
      if (c >= cols) continue;
      const size_t at = (size_t)(t0 + tl) * cols + c;
      const Vec mm = *reinterpret_cast<const Vec*>(m + at);
      const Vec vv = *reinterpret_cast<const Vec*>(v + at);
      const Vec nn = *reinterpret_cast<const Vec*>(vn + at);
      const uint8_t* e = end + (size_t)(t0 + tl) * N;
      Vec delta, disc;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // delta = (m + gamma * v') - v, in the reference's order
        delta.f[j] = __fadd_rn(
            __fadd_rn(mm.f[j], __fmul_rn(gamma, nn.f[j])), -vv.f[j]);
        disc.f[j] = e[(c + j) / K] ? 0.0f : gl;
      }
      *reinterpret_cast<Vec*>(&s_adv[tl][cl]) = delta;
      *reinterpret_cast<Vec*>(&s_disc[tl][cl]) = disc;
      *reinterpret_cast<Vec*>(&s_v[tl][cl]) = vv;
    }
    __syncthreads();
    if (tid < CW && c0 + tid < cols) {
#pragma unroll 8
      for (int tl = nt - 1; tl >= 0; --tl) {
        gae = __fadd_rn(s_adv[tl][tid], __fmul_rn(s_disc[tl][tid], gae));
        s_adv[tl][tid] = gae;
      }
    }
    __syncthreads();
    for (int i = tid; i < nt * GW; i += NT) {
      const int tl = i / GW, cl = V * (i % GW), c = c0 + cl;
      if (c >= cols) continue;
      const size_t at = (size_t)(t0 + tl) * cols + c;
      const Vec a = *reinterpret_cast<const Vec*>(&s_adv[tl][cl]);
      const Vec vv = *reinterpret_cast<const Vec*>(&s_v[tl][cl]);
      Vec r;
#pragma unroll
      for (int j = 0; j < V; ++j) r.f[j] = __fadd_rn(a.f[j], vv.f[j]);
      *reinterpret_cast<Vec*>(adv + at) = a;
      *reinterpret_cast<Vec*>(ret + at) = r;
    }
    __syncthreads();
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int fsrl_gae(const float* m, const float* v, const float* vn,
                        const uint8_t* end, float* adv, float* ret, int T,
                        int N, int K, float gamma, float gl, void* stream) {
  const int cols = N * K;
  const int blocks = (cols + CW - 1) / CW;
  if (blocks == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (cols % 4 == 0 && aligned16(m) && aligned16(v) && aligned16(vn) &&
      aligned16(adv) && aligned16(ret))
    gae_kernel<4><<<blocks, NT, 0, s>>>(m, v, vn, end, adv, ret, T, N, K,
                                        gamma, gl);
  else
    gae_kernel<1><<<blocks, NT, 0, s>>>(m, v, vn, end, adv, ret, T, N, K,
                                        gamma, gl);
  return (int)cudaGetLastError();
}

// The tiling constants, for the wrapper's module to check its copies against.
extern "C" int fsrl_gae_strip() { return CW; }
extern "C" int fsrl_gae_time_tile() { return TT; }
