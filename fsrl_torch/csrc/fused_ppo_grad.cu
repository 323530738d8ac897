// Fused PPO-Lagrangian minibatch loss gradient: actor and K critic towers,
// forward and hand-derived backward, in one launch plus a reduce launch.
// This file holds the bf16 kernel (the main path), the reduce launch and the
// entry point; the float32 kernel is in fused_ppo_grad_f32.cu.
//
// Replaces: fsrl_tpu/ops/fused_ppo_grad.py `_kernel` (entry
// `ppo_grad_minibatch`). That Pallas kernel walks the minibatch in row
// chunks on one TPU core and accumulates every gradient into one resident
// output block with `+=`, relying on the grid running in order.
//
// Bound on this card: operations. Per row and tower the forward and
// backward take three 128x128 matrix-vector products (h1 W2, h1^T g_h2,
// g_h2 W2^T) plus small ones: ~312k FLOP per row for 3 towers, ~10.2 GFLOP
// per launch at 32768 rows, ~10 us at the bf16 tensor-core peak of
// 989 TFLOP/s. The inputs are ~2.5 MB.
//
// Design:
// * Grid (G, 1+K): blockIdx.y picks the tower (0 = actor, 1..K = critics);
//   towers never exchange data. A block of two warpgroups walks the 128-row
//   chunks blockIdx.x, blockIdx.x + G, ...; G is the smallest grid that keeps
//   the longest walk as short as filling the SMs once allows, so blocks do
//   equal numbers of chunks up to one.
// * All five products of a chunk run on the tensor cores with `wgmma`
//   (m64n128k16, and m64n16k16 for dW1), each warpgroup owning 64 of the M
//   rows:
//     P0  h1  = relu(x W1^T + b1)       M rows,  N out, K = D padded to 16 KD
//     P1  h2  = relu(h1 W2^T + b2)      M rows,  N out, K in
//     P2  dW2 += g_h2^T h1              M out,   N in,  K rows
//     P3  g_h1 = (g_h2 W2) * (h1 > 0)   M rows,  N in,  K out
//     P4  dW1 += g_h1^T x               M out,   N = D padded to 16 KD, K rows
//   KD = ceil(D / 16) 16-deep steps (P0) or 16-wide slices (P4); the kernel
//   is a template on KD, and KD = 1 (D <= 16) is the design below as it
//   was written for D <= 12. Above D 64, and above 8 actions, it is the
//   sliced form (KD_SLICED), which takes any D (see below).
//   Operands are bf16 tiles in shared memory in wgmma's unswizzled
//   core-matrix layout (wgmma.cuh). One stored copy of W2 serves P1 and P3,
//   one of h1 P1 and P2, one of g_h2 P2 and P3, one of x P0 and P4, through
//   the descriptors' transpose bits. h1, g_h2 and g_h1 are written into
//   that layout by the threads that hold the accumulator fragments.
// * dW2 (64 registers a thread) and, for KD = 1, dW1 (8) accumulate in the
//   wgmma accumulators across the block's chunks and leave registers once.
//   For KD > 1 each chunk's dW1 is taken one 16-wide slice at a time in
//   8 fresh registers and added into the block's partial (L2), each thread
//   alone reading and writing its entries, so no registers are held for it
//   between chunks.
// * Epilogues work on the fragments: bias, ReLU and the bf16 rounding. h2
//   stays in registers until g_h2 replaces it, so it never reaches shared
//   memory and is its own ReLU mask; the h1 > 0 mask is read back from the
//   h1 tile. A row of a fragment is spread over the four lanes of a
//   quad, so the heads' dot products on unrounded f32 h2 are a partial sum
//   per lane and two shuffles; two lanes of the quad then evaluate one
//   row's loss each and hand the head's gradient to the quad. Column sums
//   over rows (head weight and bias gradients) are a halving exchange over
//   the warp's eight row lanes into per-warp accumulators in shared memory,
//   summed over the warps at the end.
// * The chunk's rows (obs, act, logp_old, adv / ret) are fetched one chunk
//   ahead with cp.async into a two-slot ring; weights are loaded once.
//   Shared memory is the limit on D: the ring costs 1 KB a column of x, so
//   for KD > 1 x is not in the ring. The next chunk's x is fetched as f32
//   into the g_h1 tile, which is free from the chunk's start until P3's
//   epilogue, and converted there into the second of two bf16 x tiles
//   (double-buffered, 4 KB per KD each): 221 KB at D 64, A 4, K 6.
// * The sliced form (D > 64, or A > 8, whose head leaves no room for the
//   resident x and W1 tiles): shared memory holds no x and no W1. P0 takes
//   the depth in slices of 64 columns, each slice's x (the chunk's rows,
//   read from L2 or device memory) and W1 (read-only, in L2 after the
//   first chunk) converted to bf16 into the g_h1 tile (free until P3's
//   epilogue: 16 KB each), both warpgroups' products of a slice summed
//   into the same accumulators; P4 stages each slice's x again in the h1
//   tile (free once P3's epilogue has read the mask) and adds its
//   16-wide dW1 slices into the block's partial as KD > 1 does. The
//   partial is H x D floats a tower: at D 348, A 17, K 2 and 32,768 rows,
//   44 blocks a tower, 33.5 MB of partials, which the reduce reads once.
//   Its shared memory does not grow with D: 206,360 bytes at (348, 17, 6).
// * Actions above 8 (AM = AMAX, 32): the AM 8 instance's layout with every
//   per-action loop taken 8 actions at a time (a loop over the slices that
//   is not unrolled), the head values in shared memory [NW][16][32], and
//   the head-weight fold staged through the g_h2 tile one slice of 8 at a
//   time (the tile holds 8 warps x 8 actions x 128 floats).
// * No accumulation across blocks: each block writes its partial to scratch
//   and `ppo_grad_reduce` sums the G partials in a fixed order. No float
//   atomics and fixed shuffle orders, so runs reproduce bit for bit.
// * The ragged last chunk is zero-filled and masked: its rows get zero
//   gradient and no aux contribution.
// * bf16 cast points are the Pallas kernel's: operands of the trunk
//   products, of the critic head and of every dW are rounded to bf16
//   (products exact, sums in f32); biases, activations, the actor's mean
//   head, its weight gradient and every bias gradient stay f32.

#include "ppo_grad_common.cuh"
#include "wgmma.cuh"

namespace ppo {
namespace {

constexpr int NCG = H / 8;        // column groups of a 128-wide tile
constexpr int TILE = R * H * 2;   // bytes of a 128x128 bf16 tile
constexpr int XTILE = R * 16 * 2; // bytes of a 128x16 bf16 tile (one KD)
constexpr int NW = NT / 32;       // warps per block
// The sliced form (template KD = KD_SLICED): x and W1 in slices of XS
// 16-deep steps (64 columns), each a 128 x 64 bf16 tile of XSLICE bytes
constexpr int KD_SLICED = 0;
constexpr int XS = 4;
constexpr int XSLICE = XS * XTILE;
// the sums over a block's rows (head bias and log-sigma gradients, kl, min
// surrogate, diff^2, ratio * cadv) at AM actions
__host__ __device__ constexpr int nsum(int AM) { return 2 * AM + 3 + MMAX; }
// floats of the block's row sums (WIDE_A: [NW][nsum]) and reduce scratch
__host__ __device__ constexpr int redn(int AM) {
  return NW * nsum(AM) > NT ? NW * nsum(AM) : NT;
}

// 16-deep steps of x and W1 for an observation width D.
__host__ __device__ constexpr int kd_of(int D) { return (D + 15) / 16; }
// The form that takes (D, A): the sliced one above DMAX_RESIDENT
// observations or above AM_SLICE actions (whose head leaves no room for
// resident x and W1 tiles), else KD = kd_of(D).
__host__ __device__ constexpr int form_of(int D, int A) {
  return D > DMAX_RESIDENT || A > AM_SLICE ? KD_SLICED : kd_of(D);
}

// A ring slot: x (KD = 1 only), act, logp_old, adv, ret.
__host__ __device__ int slot_floats(int KD, int D, int A, int K) {
  return R * ((KD == 1 ? D : 0) + A + 1 + 2 * K);
}
// The tiles (W2, h1, g_h2, g_h1; x, once for KD = 1 and twice above, and W1;
// none in the sliced form, which stages its slices in the g_h1 and h1
// tiles), then the floats. The instance for AM = AMAX_NARROW actions keeps
// per-warp head-weight partials; the wider ones keep instead the rows' head
// values and the loss's constants (see the kernel).
template <int AM>
__host__ __device__ size_t smem_bytes_am(int D, int A, int K) {
  const int KD = form_of(D, A);
  const int own = AM > AMAX_NARROW ? NW * 16 * AM + AM + MMAX + 1
                                   : NW * AM * H;
  return 4 * TILE +
         (KD == KD_SLICED ? 0 : (KD == 1 ? 2 : 3) * KD * XTILE) +
         sizeof(float) * (2 * H + AM * H + AM + own + 2 * NW * H +
                          2 * slot_floats(KD, D, A, K) + redn(AM));
}
__host__ __device__ size_t smem_bytes(int D, int A, int K) {
  if (A > AM_SLICE) return smem_bytes_am<AMAX>(D, A, K);
  return A > AMAX_NARROW || form_of(D, A) == KD_SLICED
             ? smem_bytes_am<AM_SLICE>(D, A, K)
             : smem_bytes_am<AMAX_NARROW>(D, A, K);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Column sums of a fragment-shaped array over the warp's 16 rows, added
// into acc[col] (column_sums in ppo_grad_common.cuh).
__device__ __forceinline__ void add_column_sums(float (&v)[32], int lane,
                                                float* acc) {
  column_sums(v, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[column_of<32>(lane, i)] += v[i];
}

// KD: 1 to 4 16-deep steps of x and W1 kept whole in shared memory, or
// KD_SLICED: any D, x and W1 taken in 64-wide slices (see the design).
// AM: the actions the instance takes (A <= AM). AM = AMAX_NARROW is the
// kernel as it was written for A <= 4. Above it (WIDE_A) a row's per-action
// values do not fit in the registers beside h2 and dW2, so they go through
// shared memory: the heads' outputs and gradients ([NW][16 rows][AM]), the
// loss's constants, and the row sums, added up over the warp in each chunk
// (actor_row_shared); and the head weight gradient's per-warp column sums
// are staged in the g_h2 tile (free until g_h2 is written) and folded over
// the warps, in order, into the block's partial chunk by chunk. The
// actions are taken AM_SLICE at a time (AM = AMAX: slices of the AM_SLICE
// instance's code in a loop that is not unrolled), and the fold goes
// through the tile one slice at a time.
template <int KD, int AM>
__global__ void __launch_bounds__(NT, 1)
ppo_grad_bf16_kernel(const Args p) {
  constexpr bool SLICED = KD == KD_SLICED;
  // column groups of the x / W1 tiles (SLICED: of one slice)
  constexpr int XCG = SLICED ? 2 * XS : 2 * KD;
  constexpr bool WIDE_A = AM > AMAX_NARROW;
  constexpr int NSUM = nsum(AM);
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = p.B, D = p.D, A = p.A, K = p.K;
  const Layout L{D, A, K};
  const int tower = blockIdx.y;
  const int g = blockIdx.x, G = gridDim.x;
  const bool actor = tower == 0;
  const int O = actor ? A : 1;
  const int M = K - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgid = tid >> 7, q = lane & 3;
  const int m0 = 64 * wgid;                          // the warpgroup's M rows
  const int row_lo = m0 + 16 * (warp & 3) + (lane >> 2);  // and row_lo + 8
  const int XD = KD == 1 ? D : 0;       // x's floats in a ring row

  unsigned char* W2t = smem;            // [out][in]
  unsigned char* h1t = W2t + TILE;      // [row][in]
  unsigned char* g2t = h1t + TILE;      // [row][out]  g_h2
  unsigned char* g1t = g2t + TILE;      // [row][in]   g_h1
  unsigned char* xt = g1t + TILE;       // [row][16 KD] x, columns >= D zero
                                        // (two of them for KD > 1)
  unsigned char* W1t = xt + (KD == 1 ? 1 : 2) * KD * XTILE;   // [out][16 KD]
  // (SLICED: neither; a slice of x and one of W1 are staged in the g_h1
  // tile for P0, a slice of x in the h1 tile for P4)
  float* b1s = reinterpret_cast<float*>(SLICED ? xt : W1t + KD * XTILE);
  float* b2s = b1s + H;
  float* whs = b2s + H;                 // [O][H] head weight
  float* bhs = whs + AM * H;
  float* pWh = bhs + AM;                // [NW][AM][H] per-warp partials
                                        // (WIDE_A: none)
  float* pb2 = pWh + (WIDE_A ? 0 : NW * AM * H);   // [NW][H]
  float* pb1 = pb2 + NW * H;            // [NW][H]
  float* ring = pb1 + NW * H;           // [2][slot]
  const int slot = slot_floats(KD, D, A, K);
  float* red = ring + 2 * slot;         // [redn] (WIDE_A: [NW][NSUM] row
                                        // sums)
  // WIDE_A: the warp's rows' head outputs, then their gradients
  float* hw = red + redn(AM) + 16 * AM * warp;   // [16][AM]
  float* cst = red + redn(AM) + 16 * AM * NW;    // log-sigma [AM], lambda
                                                 // [MMAX], rescale
  const uint32_t aW2 = wg::smem_addr(W2t), ah1 = wg::smem_addr(h1t),
                 ag2 = wg::smem_addr(g2t), ag1 = wg::smem_addr(g1t),
                 ax = wg::smem_addr(xt), aW1 = wg::smem_addr(W1t);

  const float* gW1 = p.params + L.global_off(tower, 0);
  const float* gb1 = p.params + L.global_off(tower, 1);
  const float* gW2 = p.params + L.global_off(tower, 2);
  const float* gb2 = p.params + L.global_off(tower, 3);
  const float* gWh = p.params + L.global_off(tower, 4);
  const float* gbh = p.params + L.global_off(tower, 5);
  const float* gls = p.params + L.global_off(0, 6);

  // The chunk's rows, one chunk ahead.
  const int n_chunks = (B + R - 1) / R;
  auto fetch = [&](int c, int s) {
    float* dst = ring + s * slot;
    const size_t r0 = (size_t)c * R;
    const int nr = min(R, B - (int)r0);
    const bool vec = p.aligned16;
    if constexpr (KD == 1) {
      cp::rows(dst, p.obs + r0 * D, nr * D, R * D, vec);
      dst += R * D;
    } else if constexpr (!SLICED) {
      // x as f32 into the g_h1 tile (R * D <= R * H floats)
      cp::rows(reinterpret_cast<float*>(g1t), p.obs + r0 * D, nr * D, R * D,
               vec);
    }
    if (actor) {
      cp::rows(dst, p.act + r0 * A, nr * A, R * A, vec);
      cp::rows(dst + R * A, p.logp_old + r0, nr, R, vec);
      cp::rows(dst + R * (A + 1), p.adv + r0 * K, nr * K, R * K, vec);
    } else {
      cp::rows(dst + R * (A + 1 + K), p.ret + r0 * K, nr * K, R * K, vec);
    }
    cp::commit();
  };
  fetch(g, 0);

  // KD > 1: a chunk's x, staged as f32 in the g_h1 tile, as a bf16 tile
  auto convert_x = [&](unsigned char* dst) {
    const float* xs = reinterpret_cast<const float*>(g1t);
    for (int u = tid; u < R * XCG; u += NT) {
      const int r = u / XCG, d0 = 8 * (u % XCG);
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = d0 + i < D ? xs[r * D + d0 + i] : 0.f;
      *reinterpret_cast<uint4*>(dst + wg::tile_off(r, d0, XCG)) =
          make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                     pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
    }
  };

  // SLICED: columns [d0, d0 + 64) of n rows of a row-major (., D) float
  // array as a bf16 tile, zero past D and past row n (the chunk's dead rows)
  auto stage_slice = [&](unsigned char* dst, const float* src, int n,
                         int d0) {
#pragma unroll
    for (int u = tid; u < R * XCG; u += NT) {
      const int r = u / XCG, c0 = 8 * (u % XCG), d = d0 + c0;
      const float* row = src + (size_t)r * D + d;
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = r < n && d + i < D ? row[i] : 0.f;
      *reinterpret_cast<uint4*>(dst + wg::tile_off(r, c0, XCG)) =
          make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                     pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
    }
  };

  // Weights, once: W2 and W1 as bf16 tiles (16-byte units of 8 inputs).
  // (unrolled, so that all of a thread's loads are in flight together)
#pragma unroll
  for (int u = tid; u < H * NCG; u += NT) {
    const int j = 8 * (u >> 7) + (u & 7), k = 8 * ((u >> 3) & 15);
    const float* w = gW2 + j * H + k;   // a tower's offset may be odd
    *reinterpret_cast<uint4*>(W2t + wg::tile_off(j, k, NCG)) =
        make_uint4(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]),
                   pack_bf16(w[4], w[5]), pack_bf16(w[6], w[7]));
  }
  if constexpr (KD == 1) {
    const int j = 8 * (tid >> 4) + (tid & 7), d0 = 8 * ((tid >> 3) & 1);
    float w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = d0 + i < D ? gW1[j * D + d0 + i] : 0.f;
    *reinterpret_cast<uint4*>(W1t + wg::tile_off(j, d0, XCG)) =
        make_uint4(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]),
                   pack_bf16(w[4], w[5]), pack_bf16(w[6], w[7]));
  } else if constexpr (!SLICED) {
    for (int u = tid; u < H * XCG; u += NT) {
      const int j = u / XCG, d0 = 8 * (u % XCG);
      float w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = d0 + i < D ? gW1[j * D + d0 + i] : 0.f;
      *reinterpret_cast<uint4*>(W1t + wg::tile_off(j, d0, XCG)) =
          make_uint4(pack_bf16(w[0], w[1]), pack_bf16(w[2], w[3]),
                     pack_bf16(w[4], w[5]), pack_bf16(w[6], w[7]));
    }
  }
  for (int i = tid; i < H; i += NT) {
    b1s[i] = gb1[i];
    b2s[i] = gb2[i];
  }
  for (int i = tid; i < O * H; i += NT)
    whs[i] = actor ? gWh[i] : round_bf16(gWh[i]);
  if (tid < O) bhs[tid] = gbh[tid];
  if constexpr (WIDE_A) {
    for (int i = tid; i < NW * NSUM; i += NT) red[i] = 0.f;
    if (tid == 0) {
      for (int a = 0; a < AM; ++a) cst[a] = (actor && a < A) ? gls[a] : 0.f;
      for (int m = 0; m < MMAX; ++m) cst[AM + m] = m < M ? p.lam[m] : 0.f;
      cst[AM + MMAX] = *p.resc;
    }
  } else {
    for (int i = tid; i < NW * AM * H; i += NT) pWh[i] = 0.f;
  }
  for (int i = tid; i < NW * H; i += NT) {
    pb2[i] = 0.f;
    pb1[i] = 0.f;
  }

  float sig[AM], lsig_sum = 0.f, lamv[MMAX];
  if constexpr (!WIDE_A) {
#pragma unroll
    for (int a = 0; a < AM; ++a) {
      const float ls = (actor && a < A) ? gls[a] : 0.f;
      sig[a] = expf(ls);
      lsig_sum += ls;
    }
#pragma unroll
    for (int m = 0; m < MMAX; ++m) lamv[m] = m < M ? p.lam[m] : 0.f;
  }
  const float resc = *p.resc;

  float dW2[64], dW1[8], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dW2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) dW1[i] = 0.f;
  // per-thread sums over the block's rows (lanes 0 and 1 of each quad)
  float s_bh[AM], s_ls[AM], a_c[MMAX], a_kl = 0.f, a_mins = 0.f,
                                       a_vf = 0.f;
#pragma unroll
  for (int a = 0; a < AM; ++a) s_bh[a] = s_ls[a] = 0.f;
#pragma unroll
  for (int m = 0; m < MMAX; ++m) a_c[m] = 0.f;

  if constexpr (KD > 1) {   // the first chunk's x
    cp::wait<0>();
    __syncthreads();
    convert_x(xt);
  }
  // KD > 1: the block's partial, where each chunk's dW1 is summed
  float* pW1 = p.part + ((size_t)g * (K + 1) + tower) * L.tower_size(0) +
               L.local_off(tower, 0);
  wg::fence_async_smem();
  int it = 0;
  for (int c = g; c < n_chunks; c += G, ++it) {
    const int nr = min(R, B - c * R);
    const float* rows = ring + (it & 1) * slot;
    // the chunk's x tile
    const uint32_t axc = KD == 1 ? ax : ax + (it & 1) * KD * XTILE;
    if constexpr (KD == 1 || SLICED) {
      if (c + G < n_chunks) {
        fetch(c + G, (it + 1) & 1);
        cp::wait<1>();
      } else {
        cp::wait<0>();
      }
    } else {
      cp::wait<0>();
    }
    // the chunk's rows have landed, and every warp has left the last chunk
    __syncthreads();

    if constexpr (KD == 1) {
      // x as a bf16 tile; each warpgroup converts the rows it multiplies
      const int r = 8 * (tid >> 4) + (tid & 7), d0 = 8 * ((tid >> 3) & 1);
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = d0 + i < D ? rows[r * D + d0 + i] : 0.f;
      *reinterpret_cast<uint4*>(xt + wg::tile_off(r, d0, XCG)) =
          make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                     pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
      wg::fence_async_smem();
      wg::warpgroup_sync(wgid);
    } else if constexpr (!SLICED) {
      // the next chunk's rows, and its x into the g_h1 tile (free: every
      // warpgroup has finished the last chunk's P4)
      if (c + G < n_chunks) fetch(c + G, (it + 1) & 1);
    }
    // SLICED: the chunk's x in global memory
    const float* xg = p.obs + (size_t)c * R * D;

    // P0: h1 = relu(x W1^T + b1), rounded to bf16 into its tile
    if constexpr (SLICED) {
      // slice by slice through the g_h1 tile (free until P3's epilogue):
      // x's columns [d0, d0 + 64) and W1's, summed into the accumulators
#pragma unroll 1
      for (int d0 = 0; d0 < D; d0 += 16 * XS) {
        if (d0 > 0) __syncthreads();   // both warpgroups are done with the
                                       // last slice
        stage_slice(g1t, xg, nr, d0);
        stage_slice(g1t + XSLICE, gW1, H, d0);
        wg::fence_async_smem();
        __syncthreads();
        wg::arrive();
#pragma unroll
        for (int ks = 0; ks < XS; ++ks)
          wg::mma_m64n128k16<0, 0>(
              acc, wg::desc_kmajor(ag1, XCG, m0, 16 * ks),
              wg::desc_kmajor(ag1 + XSLICE, XCG, 0, 16 * ks),
              d0 > 0 || ks > 0);
        wg::commit();
        wg::wait_all();
      }
    } else {
      wg::arrive();
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        wg::mma_m64n128k16<0, 0>(acc, wg::desc_kmajor(axc, XCG, m0, 16 * ks),
                                 wg::desc_kmajor(aW1, XCG, 0, 16 * ks),
                                 ks > 0);
      wg::commit();
      wg::wait_all();
    }
    wg::fence_regs(acc);
    float2 ld[16];   // a fragment's worth of loads, issued before their use
    load_cols(ld, b1s, q);
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = fmaxf(acc[4 * jb + 2 * h] + ld[jb].x, 0.f);
        const float v1 = fmaxf(acc[4 * jb + 2 * h + 1] + ld[jb].y, 0.f);
        *reinterpret_cast<uint32_t*>(
            h1t + wg::tile_off(row_lo + 8 * h, 8 * jb + 2 * q, NCG)) =
            pack_bf16(v0, v1);
      }
    }
    wg::fence_async_smem();
    wg::warpgroup_sync(wgid);

    // P1: h2 = relu(h1 W2^T + b2), kept in registers as f32
    wg::arrive();
#pragma unroll
    for (int ks = 0; ks < H / 16; ++ks)
      wg::mma_m64n128k16<0, 0>(acc, wg::desc_kmajor(ah1, NCG, m0, 16 * ks),
                               wg::desc_kmajor(aW2, NCG, 0, 16 * ks), ks > 0);
    wg::commit();
    wg::wait_all();
    wg::fence_regs(acc);
    load_cols(ld, b2s, q);
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = fmaxf(acc[4 * jb + 2 * h] + ld[jb].x, 0.f);
        const float v1 = fmaxf(acc[4 * jb + 2 * h + 1] + ld[jb].y, 0.f);
        // the critic's head and its weight gradient take h2 in bf16
        // (rounding keeps the sign, so h2 > 0 can still be read off it)
        acc[4 * jb + 2 * h] = actor ? v0 : round_bf16(v0);
        acc[4 * jb + 2 * h + 1] = actor ? v1 : round_bf16(v1);
      }
    }

    // heads: a partial dot product per lane, summed over the quad
    float gh[2][AM];   // (WIDE_A: the gradients are in hw)
    if constexpr (WIDE_A) {
      // the rows' head outputs into hw, by lane 0 of the quad
#pragma unroll 1
      for (int a0 = 0; a0 < O; a0 += AM_SLICE)
#pragma unroll
        for (int u = 0; u < AM_SLICE; ++u) {
          const int a = a0 + u;
          if (a < O) {
            load_cols(ld, whs + a * H, q);
            float o0 = 0.f, o1 = 0.f;
#pragma unroll
            for (int jb = 0; jb < 16; ++jb) {
              o0 += acc[4 * jb] * ld[jb].x + acc[4 * jb + 1] * ld[jb].y;
              o1 += acc[4 * jb + 2] * ld[jb].x + acc[4 * jb + 3] * ld[jb].y;
            }
            o0 += __shfl_xor_sync(0xffffffffu, o0, 1);
            o0 += __shfl_xor_sync(0xffffffffu, o0, 2);
            o1 += __shfl_xor_sync(0xffffffffu, o1, 1);
            o1 += __shfl_xor_sync(0xffffffffu, o1, 2);
            if (q == 0) {
              hw[(lane >> 2) * AM + a] = o0 + bhs[a];
              hw[((lane >> 2) + 8) * AM + a] = o1 + bhs[a];
            }
          }
        }
      __syncwarp();
      // the row's loss: lanes 0 and 1 of the quad take row_lo and row_lo +
      // 8, and write the gradient at the head's output over its output
      const int h = q & 1, r = row_lo + 8 * h;
      const bool live = r < nr, own = q < 2;
      float* hrow = hw + ((lane >> 2) + 8 * h) * AM;
      float* wsum = red + warp * NSUM;
      auto add = [&](int k, float v) { warp_add(wsum + k, v, lane); };
      if (actor) {
        // a dead row is zero-filled, so its loss is finite; it is masked
        actor_row_shared<AM, float>(
            hrow, hrow, own, live, rows + R * XD + r * A,
            rows[R * (XD + A) + r], rows + R * (XD + A + 1) + r * K, cst,
            cst + AM, cst[AM + MMAX], p, add);
      } else {
        float diff = 0.f, gv = 0.f;
        if (own) {
          diff = hrow[0] - rows[R * (XD + A + 1 + K) + r * K + (tower - 1)];
          gv = p.gv_scale * diff;
          hrow[0] = live ? round_bf16(gv) : 0.f;
        }
        add(0, own && live ? gv : 0.f);
        add(2 * AM + 2, own && live ? diff * diff : 0.f);
      }
      __syncwarp();
    } else {
      float hd[2][AM];
#pragma unroll
      for (int a = 0; a < AM; ++a) {
        hd[0][a] = hd[1][a] = 0.f;
        if (a < O) {
          load_cols(ld, whs + a * H, q);
#pragma unroll
          for (int jb = 0; jb < 16; ++jb) {
            hd[0][a] += acc[4 * jb] * ld[jb].x + acc[4 * jb + 1] * ld[jb].y;
            hd[1][a] += acc[4 * jb + 2] * ld[jb].x + acc[4 * jb + 3] * ld[jb].y;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            hd[h][a] += __shfl_xor_sync(0xffffffffu, hd[h][a], 1);
            hd[h][a] += __shfl_xor_sync(0xffffffffu, hd[h][a], 2);
            hd[h][a] += bhs[a];
          }
        }
      }

      // the row's loss and the gradient at the head's output. Every lane
      // of a quad holds both rows' head outputs; lanes 0 and 1 of the quad
      // take row_lo and row_lo + 8 (lanes 2 and 3 repeat them, unused).
      {
        const int h = q & 1, r = row_lo + 8 * h;
        const bool live = r < nr, mine = live && q < 2;
        float hr[AM], g_out[AM];
#pragma unroll
        for (int a = 0; a < AM; ++a) {
          hr[a] = h ? hd[1][a] : hd[0][a];
          g_out[a] = 0.f;
        }
        if (actor) {
          // a dead row is zero-filled, so its loss is finite; it is masked
          const float* adv_row = rows + R * (XD + A + 1) + r * K;
          const ActorRow<AM> o =
              actor_row(hr, rows + R * XD + r * A, rows[R * (XD + A) + r],
                        adv_row, sig, lsig_sum, lamv, resc, p);
#pragma unroll
          for (int a = 0; a < AM; ++a) g_out[a] = live ? o.g_mu[a] : 0.f;
          if (mine) {
#pragma unroll
            for (int a = 0; a < AM; ++a) {
              s_bh[a] += o.g_mu[a];
              s_ls[a] += o.g_ls[a];
            }
#pragma unroll
            for (int m = 0; m < MMAX; ++m)
              if (m < M) a_c[m] += o.ratio * adv_row[1 + m];
            a_kl += o.kl;
            a_mins += o.mins;
          }
        } else {
          const float diff =
              hr[0] - rows[R * (XD + A + 1 + K) + r * K + (tower - 1)];
          const float gv = p.gv_scale * diff;
          g_out[0] = live ? round_bf16(gv) : 0.f;
          if (mine) {
            a_vf += diff * diff;
            s_bh[0] += gv;
          }
        }
#pragma unroll
        for (int a = 0; a < AM; ++a) {
          gh[0][a] = gh[1][a] = 0.f;
          if (a < O) {
            gh[0][a] = __shfl_sync(0xffffffffu, g_out[a], lane & ~3);
            gh[1][a] = __shfl_sync(0xffffffffu, g_out[a], (lane & ~3) + 1);
          }
        }
      }
    }

    // head weight gradient: column sums of gh[row][a] * h2[row][col]
    float v[32];
    if constexpr (WIDE_A) {
      // each warp's column sums staged in the g_h2 tile (free until g_h2
      // is written below), folded over the warps in order into the block's
      // partial: each thread alone reads and writes its entries there, the
      // first chunk storing and later ones adding. The tile holds one
      // slice of AM_SLICE actions at a time.
      float* stg = reinterpret_cast<float*>(g2t);   // [NW][AM_SLICE][H]
      float* oWh = p.part + ((size_t)g * (K + 1) + tower) * L.tower_size(0) +
                   L.local_off(tower, 4);
#pragma unroll 1
      for (int a0 = 0; a0 < O; a0 += AM_SLICE) {
        if (a0 > 0) __syncthreads();   // the last slice has been folded
#pragma unroll
        for (int u = 0; u < AM_SLICE; ++u) {
          const int a = a0 + u;
          if (a < O) {
            const float ga = hw[(lane >> 2) * AM + a];
            const float gb = hw[((lane >> 2) + 8) * AM + a];
#pragma unroll
            for (int i = 0; i < 32; ++i)
              v[i] = ga * acc[4 * (i >> 1) + (i & 1)] +
                     gb * acc[4 * (i >> 1) + 2 + (i & 1)];
            column_sums(v, lane);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              stg[(warp * AM_SLICE + u) * H + column_of<32>(lane, i)] = v[i];
          }
        }
        __syncthreads();
        const int n = min(AM_SLICE, O - a0) * H;
        for (int i = tid; i < n; i += NT) {
          float s = 0.f;
          for (int w = 0; w < NW; ++w) s += stg[w * AM_SLICE * H + i];
          float* o = oWh + a0 * H + i;
          *o = it > 0 ? *o + s : s;
        }
      }
      __syncthreads();   // g_h2 takes the staging's place
    } else {
#pragma unroll
      for (int a = 0; a < AM; ++a)
        if (a < O) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            v[i] = gh[0][a] * acc[4 * (i >> 1) + (i & 1)] +
                   gh[1][a] * acc[4 * (i >> 1) + 2 + (i & 1)];
          add_column_sums(v, lane, pWh + (warp * AM + a) * H);
        }
    }

    // g_h2 = (gh Wh) * (h2 > 0) in place of h2; its column sums are db2,
    // and it goes to its tile in bf16
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 8) {   // 8 column groups at a time
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      // s += ga w_a (row row_lo) and gb w_a (row row_lo + 8) over the head
      // outputs a: WIDE_A AM_SLICE at a time from hw, else from registers
#pragma unroll 1
      for (int a0 = 0; a0 < (WIDE_A ? O : 1); a0 += AM_SLICE)
#pragma unroll
        for (int u = 0; u < (WIDE_A ? AM_SLICE : AM); ++u) {
          const int a = WIDE_A ? a0 + u : u;
          if (a < O) {
            float2 w[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              w[i] = *reinterpret_cast<const float2*>(whs + a * H +
                                                      8 * (j0 + i) + 2 * q);
            const float ga = WIDE_A ? hw[(lane >> 2) * AM + a] : gh[0][u];
            const float gb =
                WIDE_A ? hw[((lane >> 2) + 8) * AM + a] : gh[1][u];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              s[i][0] += ga * w[i].x;
              s[i][1] += ga * w[i].y;
              s[i][2] += gb * w[i].x;
              s[i][3] += gb * w[i].y;
            }
          }
        }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int jb = j0 + i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float g0 = acc[4 * jb + 2 * h] > 0.f ? s[i][2 * h] : 0.f;
          const float g1 =
              acc[4 * jb + 2 * h + 1] > 0.f ? s[i][2 * h + 1] : 0.f;
          acc[4 * jb + 2 * h] = g0;
          acc[4 * jb + 2 * h + 1] = g1;
          *reinterpret_cast<uint32_t*>(
              g2t + wg::tile_off(row_lo + 8 * h, 8 * jb + 2 * q, NCG)) =
              pack_bf16(g0, g1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      v[i] = acc[4 * (i >> 1) + (i & 1)] + acc[4 * (i >> 1) + 2 + (i & 1)];
    add_column_sums(v, lane, pb2 + warp * H);
    if constexpr (KD > 1) {
      // the next chunk's x into the other x tile, before P3's epilogue
      // writes g_h1 over it
      if (c + G < n_chunks) {
        cp::wait<0>();
        __syncthreads();
        convert_x(xt + ((it + 1) & 1) * KD * XTILE);
      }
    }
    wg::fence_async_smem();
    __syncthreads();   // P2 reads every row of g_h2 and h1

    // P3: g_h1 = g_h2 W2; P2: dW2 += g_h2^T h1 (stays in registers).
    // Every product is waited for where it is issued: left running under
    // an epilogue, ptxas serialises the whole pipeline (C7515).
    wg::arrive();
#pragma unroll
    for (int ks = 0; ks < H / 16; ++ks)
      wg::mma_m64n128k16<0, 1>(acc, wg::desc_kmajor(ag2, NCG, m0, 16 * ks),
                               wg::desc_mnmajor(aW2, NCG, 16 * ks, 0),
                               ks > 0);
#pragma unroll
    for (int ks = 0; ks < R / 16; ++ks)
      wg::mma_m64n128k16<1, 1>(dW2, wg::desc_mnmajor(ag2, NCG, 16 * ks, m0),
                               wg::desc_mnmajor(ah1, NCG, 16 * ks, 0), 1);
    wg::commit();
    wg::wait_all();
    wg::fence_regs(acc);
    wg::fence_regs(dW2);
    // the h1 > 0 mask is read back from the h1 tile (bf16 keeps the sign)
    uint32_t h1[32];   // loaded together, so that the latencies overlap
#pragma unroll
    for (int i = 0; i < 32; ++i)
      h1[i] = *reinterpret_cast<const uint32_t*>(
          h1t + wg::tile_off(row_lo + 8 * (i & 1), 8 * (i >> 1) + 2 * q, NCG));
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t m = h1[2 * jb + h];
        const float g0 = m & 0x00007fffu ? acc[4 * jb + 2 * h] : 0.f;
        const float g1 = m & 0x7fff0000u ? acc[4 * jb + 2 * h + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(
            g1t + wg::tile_off(row_lo + 8 * h, 8 * jb + 2 * q, NCG)) =
            pack_bf16(g0, g1);
        v[2 * jb] = h ? v[2 * jb] + g0 : g0;
        v[2 * jb + 1] = h ? v[2 * jb + 1] + g1 : g1;
      }
    }
    add_column_sums(v, lane, pb1 + warp * H);
    wg::fence_async_smem();
    __syncthreads();   // P4 reads every row of g_h1 and x

    if constexpr (KD == 1) {
      // P4: dW1 += g_h1^T x (stays in registers)
      wg::arrive();
#pragma unroll
      for (int ks = 0; ks < R / 16; ++ks)
        wg::mma_m64n16k16<1, 1>(dW1, wg::desc_mnmajor(ag1, NCG, 16 * ks, m0),
                                wg::desc_mnmajor(ax, XCG, 16 * ks, 0), 1);
      wg::commit();
      wg::wait_all();
      wg::fence_regs(dW1);
    } else if constexpr (SLICED) {
      // P4: x's columns [d0, d0 + 64) staged in the h1 tile (free: P3's
      // epilogue has read the mask), then as below, 16 columns at a time
#pragma unroll 1
      for (int d0 = 0; d0 < D; d0 += 16 * XS) {
        if (d0 > 0) __syncthreads();   // both warpgroups are done with the
                                       // last slice
        stage_slice(h1t, xg, nr, d0);
        wg::fence_async_smem();
        __syncthreads();
#pragma unroll
        for (int kd = 0; kd < XS; ++kd) {
          if (d0 + 16 * kd >= D) break;   // (block-uniform)
          float d1[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) d1[i] = 0.f;
          wg::arrive();
#pragma unroll
          for (int ks = 0; ks < R / 16; ++ks)
            wg::mma_m64n16k16<1, 1>(
                d1, wg::desc_mnmajor(ag1, NCG, 16 * ks, m0),
                wg::desc_mnmajor(ah1, XCG, 16 * ks, 16 * kd), ks > 0);
          wg::commit();
          wg::wait_all();
          wg::fence_regs(d1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = row_lo + 8 * h;
#pragma unroll
            for (int jb = 0; jb < 2; ++jb)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int d = d0 + 16 * kd + 8 * jb + 2 * q + e;
                const float v1 = d1[4 * jb + 2 * h + e];
                if (d < D)
                  pW1[j * D + d] = it > 0 ? pW1[j * D + d] + v1 : v1;
              }
          }
        }
      }
    } else {
      // P4: the chunk's g_h1^T x, one 16-wide slice of x at a time into a
      // fresh accumulator, added into the block's partial: element 4 jb +
      // 2 h + e is output row_lo + 8 h, input 16 kd + 8 jb + 2 q + e
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        float d1[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) d1[i] = 0.f;
        wg::arrive();
#pragma unroll
        for (int ks = 0; ks < R / 16; ++ks)
          wg::mma_m64n16k16<1, 1>(
              d1, wg::desc_mnmajor(ag1, NCG, 16 * ks, m0),
              wg::desc_mnmajor(axc, XCG, 16 * ks, 16 * kd), ks > 0);
        wg::commit();
        wg::wait_all();
        wg::fence_regs(d1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = row_lo + 8 * h;
#pragma unroll
          for (int jb = 0; jb < 2; ++jb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = 16 * kd + 8 * jb + 2 * q + e;
              const float v1 = d1[4 * jb + 2 * h + e];
              if (d < D) pW1[j * D + d] = it > 0 ? pW1[j * D + d] + v1 : v1;
            }
        }
      }
    }
  }
  __syncthreads();

  // one partial per block
  const int T = K + 1;
  const int Pmax = L.tower_size(0);
  float* out = p.part + ((size_t)g * T + tower) * Pmax;
  {
    float* oW2 = out + L.local_off(tower, 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = row_lo + 8 * h;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
        *reinterpret_cast<float2*>(oW2 + j * H + 8 * jb + 2 * q) =
            make_float2(dW2[4 * jb + 2 * h], dW2[4 * jb + 2 * h + 1]);
      if constexpr (KD == 1) {   // (KD > 1: summed there chunk by chunk)
        float* oW1 = out + L.local_off(tower, 0);
#pragma unroll
        for (int jb = 0; jb < 2; ++jb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = 8 * jb + 2 * q + e;
            if (d < D) oW1[j * D + d] = dW1[4 * jb + 2 * h + e];
          }
      }
    }
  }
  // per-warp partials, summed over the warps in order
  {
    const int j = tid & (H - 1);
    const float* src = tid < H ? pb1 : pb2;
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += src[w * H + j];
    out[L.local_off(tower, tid < H ? 1 : 3) + j] = s;
  }
  if constexpr (!WIDE_A) {   // (WIDE_A: summed there chunk by chunk)
    for (int i = tid; i < O * H; i += NT) {
      const int a = i / H, j = i % H;
      float s = 0.f;
      for (int w = 0; w < NW; ++w) s += pWh[(w * AM + a) * H + j];
      out[L.local_off(tower, 4) + i] = s;
    }
  }
  // the per-thread sums: over the warp by shuffles, over the warps in order
  // (WIDE_A: the warps' sums are in red already)
  {
    if constexpr (!WIDE_A) {
      float vals[NSUM];
#pragma unroll
      for (int a = 0; a < AM; ++a) {
        vals[a] = s_bh[a];
        vals[AM + a] = s_ls[a];
      }
      vals[2 * AM] = a_kl;
      vals[2 * AM + 1] = a_mins;
      vals[2 * AM + 2] = a_vf;
#pragma unroll
      for (int m = 0; m < MMAX; ++m) vals[2 * AM + 3 + m] = a_c[m];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) {
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          vals[k] += __shfl_xor_sync(0xffffffffu, vals[k], s);
        if (lane == 0) red[warp * NSUM + k] = vals[k];
      }
    }
    __syncthreads();
    if (tid < NSUM) {
      float s = 0.f;
      for (int w = 0; w < NW; ++w) s += red[w * NSUM + tid];
      float* oaux = p.part_aux + ((size_t)g * T + tower) * AUXW;
      const int k = tid;
      if (k < AM) {
        if (k < O) out[L.local_off(tower, 5) + k] = s;
      } else if (k < 2 * AM) {
        if (actor && k - AM < A) out[L.local_off(0, 6) + k - AM] = s;
      } else if (k < 2 * AM + 2) {
        if (actor) oaux[k - 2 * AM] = s;
      } else if (k == 2 * AM + 2) {
        if (!actor) oaux[0] = s;
      } else if (actor && k - (2 * AM + 3) < M) {
        oaux[2 + k - (2 * AM + 3)] = s;
      }
    }
  }
}

// Second launch: sums the G block partials in a fixed order into the flat
// gradient, and in its last block into the aux row [sum(logp_old - logp),
// sum(min surrogate), sum_k sum(diff^2), sum(ratio * cadv_m) for m < M].
__global__ void ppo_grad_reduce(const float* __restrict__ part,
                                const float* __restrict__ part_aux,
                                float* __restrict__ grad,
                                float* __restrict__ aux, int G, int D, int A,
                                int K) {
  const Layout L{D, A, K};
  const int T = K + 1;
  const int Pmax = L.tower_size(0);
  if (blockIdx.x == gridDim.x - 1) {
    // one warp per aux value: lane j sums the partials j, j + 32, ..., and
    // the lanes are summed by a fixed shuffle tree
    const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // value q sums column `col` of the towers t0 .. t1 - 1 of every block
    int col = 0, t0 = 0, t1 = 1;
    if (q < 2) {
      col = q;
    } else if (q == 2) {
      t0 = 1;
      t1 = T;
    } else if (q - 3 < K - 1) {
      col = 2 + (q - 3);
    } else {
      t1 = 0;
    }
    const int nt = t1 - t0, n = G * nt;
    float s = 0.f;
    for (int i = lane; i < n; i += 32)
      s += part_aux[((size_t)(i / nt) * T + t0 + i % nt) * AUXW + col];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) aux[q] = s;
    return;
  }
  // four neighbouring lanes per output: lane j sums the blocks j, j + 4,
  // ... in order, 16 loads in flight at a time, and the four sums are
  // added as (s0 + s1) + (s2 + s3)
  const int id = (blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const int j = threadIdx.x & 3;
  const bool live = id < T * Pmax;     // whole quads, so the shuffles are safe
  const int t = live ? id / Pmax : 0, l = live ? id % Pmax : 0;
  const float* src = part + (size_t)t * Pmax + l;
  const size_t stride = (size_t)T * Pmax;
  float s = 0.f;
  for (int b0 = j; b0 < G; b0 += 64) {
    float x[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      x[u] = b0 + 4 * u < G ? src[(b0 + 4 * u) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (b0 + 4 * u < G) s += x[u];
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (!live || j != 0 || l >= L.tower_size(t)) return;
  int seg = 0;
  while (l >= L.local_off(t, seg + 1)) ++seg;
  grad[L.global_off(t, seg) + (l - L.local_off(t, seg))] = s;
}

cudaError_t launch_reduce(const float* part, const float* part_aux,
                          float* grad, float* aux, int G, int D, int A, int K,
                          cudaStream_t s) {
  static_assert(32 * AUXW == NT, "the aux block has one warp per value");
  const Layout L{D, A, K};
  const int n = 4 * (K + 1) * L.tower_size(0);
  ppo_grad_reduce<<<(n + NT - 1) / NT + 1, NT, 0, s>>>(part, part_aux, grad,
                                                        aux, G, D, A, K);
  return cudaGetLastError();
}

__global__ void empty_kernel() {}

template <int KD, int AM>
cudaError_t launch_bf16_am(const Args& a, int G, cudaStream_t s) {
  const size_t smem = smem_bytes_am<AM>(a.D, a.A, a.K);
  cudaFuncSetAttribute(ppo_grad_bf16_kernel<KD, AM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ppo_grad_bf16_kernel<KD, AM><<<dim3(G, a.K + 1), NT, smem, s>>>(a);
  return cudaGetLastError();
}
// The sliced form has no AMAX_NARROW instance (its registers spill there):
// it takes every A <= AM_SLICE with the AM_SLICE one.
template <int KD>
cudaError_t launch_bf16(const Args& a, int G, cudaStream_t s) {
  if constexpr (KD == KD_SLICED) {
    return a.A > AM_SLICE ? launch_bf16_am<KD, AMAX>(a, G, s)
                          : launch_bf16_am<KD, AM_SLICE>(a, G, s);
  } else {
    return a.A > AMAX_NARROW ? launch_bf16_am<KD, AM_SLICE>(a, G, s)
                             : launch_bf16_am<KD, AMAX_NARROW>(a, G, s);
  }
}

// Blocks per tower: at most the SMs shared among the towers, and no more
// than keeps the longest walk at ceil(chunks / that).
int grid_g(int B, int K) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_chunks = (B + R - 1) / R;
  int G = sms / (K + 1);
  if (G < 1) G = 1;
  if (G > n_chunks) G = n_chunks;
  const int walk = (n_chunks + G - 1) / G;
  return (n_chunks + walk - 1) / walk;
}

}  // namespace
}  // namespace ppo

using namespace ppo;

extern "C" long fsrl_ppo_grad_scratch_floats(int B, int D, int Hd, int A,
                                             int K) {
  const Layout L{D, A, K};
  return (long)grid_g(B, K) * (K + 1) * (L.tower_size(0) + AUXW);
}

// Blocks per tower that a batch of B rows is spread over.
extern "C" int fsrl_ppo_grad_blocks(int B, int K) { return grid_g(B, K); }

// Dynamic shared memory of a block of the bf16 or f32 kernel at (D, A, K).
extern "C" long fsrl_ppo_grad_smem_bytes(int D, int A, int K, int bf16) {
  return (long)(bf16 ? smem_bytes(D, A, K) : smem_bytes_f32(D, A, K));
}

// Byte offset of element (r, c) of a bf16 operand tile with ncg column
// groups, as the kernel's threads compute it.
extern "C" int fsrl_ppo_grad_tile_offset(int r, int c, int ncg) {
  return (int)wg::tile_off(r, c, ncg);
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
  if (Hd != H || D < 1 || A < 1 || A > AMAX || K < 1 ||
      K - 1 > MMAX || B < 1 ||
      scratch_floats < fsrl_ppo_grad_scratch_floats(B, D, Hd, A, K))
    return (int)cudaErrorInvalidValue;
  const Layout L{D, A, K};
  const int G = grid_g(B, K);
  const int T = K + 1;
  Args a{params, obs, act, logp_old, adv, ret, lam, resc, scratch,
         scratch + (size_t)G * T * L.tower_size(0), B, D, A, K, clip_lo,
         clip_hi, (float)(2.0 * (double)vf_coef / (double)B),
         (float)(A * 0.91893853320467274178),
         ((reinterpret_cast<uintptr_t>(obs) | reinterpret_cast<uintptr_t>(act) |
           reinterpret_cast<uintptr_t>(logp_old) |
           reinterpret_cast<uintptr_t>(adv) | reinterpret_cast<uintptr_t>(ret)) &
          15u) == 0};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    switch (form_of(D, A)) {
      case 1: err = launch_bf16<1>(a, G, s); break;
      case 2: err = launch_bf16<2>(a, G, s); break;
      case 3: err = launch_bf16<3>(a, G, s); break;
      case 4: err = launch_bf16<4>(a, G, s); break;
      default: err = launch_bf16<KD_SLICED>(a, G, s); break;
    }
  } else {
    err = launch_f32(a, G, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(a.part, a.part_aux, grad, aux, G, D, A, K, s);
}

// The reduce launch alone, on partials already in scratch (for timing it).
extern "C" int fsrl_ppo_grad_reduce_only(const float* scratch, float* grad,
                                         float* aux, int B, int D, int A,
                                         int K, void* stream) {
  const Layout L{D, A, K};
  const int G = grid_g(B, K), T = K + 1;
  return (int)launch_reduce(scratch,
                            scratch + (size_t)G * T * L.tower_size(0), grad,
                            aux, G, D, A, K, (cudaStream_t)stream);
}

// A kernel that does nothing: what a launch costs on its own.
extern "C" int fsrl_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
