// Fused PPO-Lagrangian minibatch loss gradient in float32 on Hopper's
// tensor cores: the kernel behind `compute_dtype` None / float32. Same
// arguments, grid, per-block partials and reduce launch as the bf16 kernel
// in fused_ppo_grad.cu, which holds the entry point; see there for what the
// kernel computes.
//
// Replaces: fsrl_tpu/ops/fused_ppo_grad.py `_kernel` (line 68; its
// pallas_call at line 235 in `ppo_grad_minibatch`) run with
// compute_dtype=None.
//
// Accuracy: every product is three TF32 products summed in f32 (the split
// of mma_tf32.cuh): each is off by about 3 * 2^-22 of its size, against
// 2^-10 for one TF32 product, and each depth step's products are added to
// the running sum with round-to-nearest adds (the tensor core's own adds
// truncate). The gradient stays within ~1e-6 of each tensor's largest
// entry of the plain f32 version, like an f32 sum taken in another order.
//
// ReLU sides. That is not enough where a pre-activation lies within
// rounding of 0: there any two float32 computations may take different
// sides of the ReLU, and the row's whole gradient through the unit moves
// (at 32,768 rows up to ~4e-3 of a tensor's largest entry; the plain f32
// version is that far from a float64 evaluation in some draws). The split
// is ~4x coarser than float32, so this kernel would take the other side
// more often than the plain version. So a pre-activation within KINK times
// its operands' norms of 0 (several times the products' error; ~1e-5 at
// the port's init, a few elements a chunk) is taken again in float64 from
// the float32 inputs: z1 by its thread, z2 by the whole warp with the
// row's h1 also taken again in float64. The kernel's ReLU sides are then
// those of exact arithmetic, and it is nearer the float64 evaluation than
// the plain f32 version is.
//
// Bound on this card: operations. Per row and tower the five products take
// 6 H^2 + 4 D H FLOP, run three times on the TF32 tensor cores (495 TFLOP/s
// dense); the heads' 6 H O FLOP run on the FP32 pipes (67 TFLOP/s): about
// 0.063 ms at 32768 rows, D 9, A 2, K 2 (0.153 ms if all of it ran on the
// FP32 pipes, the bound of the FMA kernel this design replaced).
//
// Design (the bf16 kernel's, with mma.sync for wgmma):
// * A block of 8 warps walks the 128-row chunks blockIdx.x, + G, ... of one
//   tower (blockIdx.y). Every product runs on the tensor cores as
//   mma.sync.m16n8k8 with TF32 operands that the threads load from shared
//   memory and split in registers (tf32::mma3). A warp owns 16 rows of the
//   chunk (P0, P1, P3) or 16 outputs of a weight gradient (P2, P4):
//     P0  h1  = relu(x W1^T + b1)       depth D, padded to 8 or 16
//     P1  h2  = relu(h1 W2^T + b2)      depth: inputs
//     P2  dW2 += g_h2^T h1              depth: rows
//     P3  g_h1 = (g_h2 W2) * (h1 > 0)   depth: outputs
//     P4  dW1 += g_h1^T [x 1]           depth: rows; N = D + 1 padded to 8
//                                       or 16 (the column of ones gives db1)
//   P2 has a 17th tile whose B is ones (exact in TF32): it gives db2.
// * W2, h1 (later g_h1) and g_h2 are float32 128 x 128 tiles in shared
//   memory (200 KB), each stored once and read in both orientations: a
//   thread picks the elements it loads, so no operand needs a transposed
//   copy, and the split costs no shared memory. W2 and h1 rows are padded
//   to 136 floats and g_h2's columns XOR-swizzled by row (sw): no bank
//   conflicts but P3's A loads (2-way), and every address is a base plus
//   constants. P1 takes the depth slots as (2c, 2c + 1), so that a thread
//   loads two neighbouring floats at once.
// * Each depth step's three products go to a fresh accumulator, added to
//   the product's running sum with round-to-nearest adds; dW1, db1, db2
//   are summed in registers and dW2 in the block's partial (in L2), each
//   thread alone reading and writing its entries there, so 64 registers do
//   not sit idle through the other products.
// * Epilogues on the fragments: bias, ReLU and the h1 > 0 mask (64 bits in
//   registers); head dot products as per-lane partial sums and quad
//   shuffles; the per-row loss on two lanes of the quad; head-weight column
//   sums by a halving exchange over the warp's row lanes.
// * The chunk's rows (obs, act, logp_old, adv / ret) are fetched one chunk
//   ahead with cp.async into a two-slot ring; weights are loaded once, W1
//   read from global memory where it stays in L1 (shared memory is full at
//   the envelope's largest D, A, K).
// * Wide observations (D > DMAX_F32_NARROW = 12, the template's WIDE): the
//   tiles leave no room for x in the ring (1 KB a column and slot), so x is
//   read from global memory (L2) where P0, P4 and the float64 retakes use
//   it, as W1 is; and dW1 is taken per chunk in the registers of acc, free
//   in P4, in slices of 9 tiles of 8 columns (D + 1 <= 72 in one, as the
//   form was written), each slice added into the block's partial as dW2
//   is. Any D: P0 and the retakes loop over D at run time. D <= 12 keeps
//   the design above unchanged.
// * Wide actions (A > 8, AM = AMAX, 32): the AM 8 instance's design with
//   every per-action loop taken 8 actions at a time; its head values
//   ([NW][16][32]) go in the second half of the g_h2 tile, which is free
//   until g_h2 is written and whose first half stages the fold (one slice
//   of 8 actions at a time), and the rows' actions are read from L2, not
//   the ring: the 200 KB of tiles leave room for nothing more (232,028
//   bytes at K 6), which is what caps A at 32.
// * Per-block partials and the fixed-order reduce launch, no float atomics:
//   runs reproduce bit for bit. The ragged last chunk is zero-filled and
//   masked.
//
// What held the float32 FMA kernel this design replaced back, and what this
// design does about it:
// 1. Only the FP32 pipes: every product now runs on the tensor cores.
// 2. Bound by shared-memory loads (16 scalar loads for 64 FMA, padded rows
//    that ruled out vector loads): one fragment load feeds a 16 x 8 x 8
//    product, and P1's loads are 8 bytes.
// 3. Eight warps an SM and a dozen barriers a chunk: still one block of 8
//    warps an SM (the tiles fill shared memory, the registers 255 a
//    thread), but a warp keeps 16 independent tiles in flight per depth
//    step and a chunk has four block barriers (h1 goes from P0 to P1
//    inside the warp). What limits it now: ~4 integer and FP instructions
//    of split per operand value before each product and 4 adds after it,
//    issued by 2 warps a scheduler at about half an instruction a clock.
// 4. Serial sections: the first layer, dW1 and both bias gradients are
//    tensor-core products; the heads and the loss run on all lanes.
// 5. Synchronous row loads: cp.async one chunk ahead.

#include "ppo_grad_common.cuh"
#include "mma_tf32.cuh"

namespace ppo {
namespace {

constexpr int NW = NT / 32;                 // warps per block
constexpr int TILE = R * H;                 // floats of a 128 x 128 tile
constexpr int WS = H + 8;                   // row stride of the W2, h1 tiles
// the sums over the block's rows at AM actions
__host__ __device__ constexpr int nsum(int AM) { return 2 * AM + 3 + MMAX; }
// the loss's constants: sigma, lambda, sum log-sigma, rescale
__host__ __device__ constexpr int ncst(int AM) { return AM + MMAX + 2; }
// A pre-activation nearer 0 than KINK times the norms of its two operand
// rows (the row of x or h1, the largest row of W1 or W2) is taken again in
// float64 (z1_exact, z2_exact): the products' error is well inside that
// (see "ReLU sides" above).
constexpr float KINK = 0x1p-17f;

// Two tile layouts keep every fragment access free of bank conflicts.
// W2 and h1 have rows of WS = 136 floats (8 banks of padding): a warp's
// loads either take 4 rows of 8 lanes at one column each (rows apart by
// 8 banks) or 8 rows of 4 lanes at two neighbouring columns (a half-warp
// then covers 4 rows, 8 banks apart), and the column of a load never
// depends on the lane's row, so addresses are a base plus constants.
// g_h2 is unpadded with bits 3-4 of the column XORed with
// h(r) = (r ^ r >> 1) & 3, distinct on any four rows 4i..4i+3; its loads
// come from rows whose h is fixed for the thread.
__host__ __device__ constexpr int sw(int r, int c) {
  return r * H + (c ^ (((r ^ (r >> 1)) & 3) << 3));
}

// P4's columns in one slice (WIDE): 9 tiles of 8, the unrolled loop the
// wide form had for D <= 64 and its column of ones, so that such a D runs
// in one slice as it did (16 tiles, all of acc, spill at 255 registers)
constexpr int P4_TILES = (DMAX_RESIDENT + 8) / 8;

// Where the instance for AMAX actions keeps what the AM_SLICE one keeps in
// shared memory of its own, which the 200 KB of tiles leave no room for:
// the rows' head values ([NW][16][AM]) in the second half of the g_h2 tile
// (free until g_h2 is written; the first half stages the fold), and the
// rows' actions in global memory (L2) rather than the ring.
__host__ __device__ constexpr bool hw_in_tile(int AM) { return AM > AM_SLICE; }

// A ring slot: x (up to DMAX_F32_NARROW only), act (but for AMAX),
// logp_old, adv / ret.
__host__ __device__ int slot_floats(bool wide, bool act, int D, int A,
                                    int K) {
  return R * ((wide ? 0 : D) + (act ? A : 0) + 1 + K);
}
// The instances above AMAX_NARROW actions (always WIDE) add the rows' head
// values ([NW][16][AM], see the kernel): AM_SLICE in shared memory of their
// own, AMAX in the g_h2 tile.
template <bool WIDE, int AM>
__host__ __device__ size_t smem_bytes_am(int D, int A, int K) {
  return sizeof(float) *
         (2 * H * WS + TILE + 2 * H + AM * H + AM +
          2 * slot_floats(WIDE, !hw_in_tile(AM), D, A, K) + ncst(AM) +
          NW * nsum(AM) + 2 * NW + 2 +
          (AM > AMAX_NARROW && !hw_in_tile(AM) ? NW * 16 * AM : 0));
}
__host__ __device__ size_t smem_bytes(int D, int A, int K) {
  if (A > AM_SLICE) return smem_bytes_am<true, AMAX>(D, A, K);
  if (A > AMAX_NARROW) return smem_bytes_am<true, AM_SLICE>(D, A, K);
  return D > DMAX_F32_NARROW ? smem_bytes_am<true, AMAX_NARROW>(D, A, K)
                             : smem_bytes_am<false, AMAX_NARROW>(D, A, K);
}

// Pre-activations taken again in float64, [0] in the first layer and [1] in
// the second, summed over launches until fsrl_ppo_grad_f32_retakes reads
// and clears them (an integer count: atomics keep it exact). A block counts
// in shared memory and adds its counts here once, at its end.
__device__ unsigned long long retakes[2];

__device__ __forceinline__ void zero(float (&v)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] = 0.f;
}

// The first layer's pre-activation of a row x (D floats) and a row w of W1,
// in float64 from the float32 operands.
__device__ __forceinline__ double z1_exact(const float* x, const float* w,
                                           float b, int D) {
  double s = b;
  for (int d = 0; d < D; ++d) s = fma((double)x[d], (double)__ldg(w + d), s);
  return s;
}

// The second layer's pre-activation of a row x and a row w2 of W2, in
// float64, the row's h1 taken again in float64 from x: by the whole warp,
// lane l taking inputs l, l + 32, ... and a fixed shuffle tree the sum.
__device__ __forceinline__ float z2_exact(const float* x, const float* gW1,
                                          const float* b1, const float* w2,
                                          float b, int D, int lane) {
  double s = 0.0;
#pragma unroll
  for (int u = 0; u < H / 32; ++u) {
    const int k = lane + 32 * u;
    s = fma(fmax(z1_exact(x, gW1 + k * D, b1[k], D), 0.0), (double)w2[k], s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return (float)(s + b);
}

// KINK times the largest of the NW warps' squared row norms in m.
__device__ __forceinline__ float kink_scale(const float* m) {
  float v = m[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) v = fmaxf(v, m[w]);
  return KINK * sqrtf(v);
}

// AM: the actions the instance takes (A <= AM); AM = AMAX_NARROW is the
// kernel as it was written for A <= 4. Above it (WIDE_A, with WIDE) the
// heads' outputs and gradients go through shared memory ([NW][16 rows][AM])
// and the row sums straight to the warps' sums (actor_row_shared), and the
// head weight gradient's per-warp column sums are staged in the g_h2 tile
// (free until g_h2 is written) and folded over the warps, in order, into
// the block's partial chunk by chunk, so that no per-action array is held
// in registers. The actions are taken AM_SLICE at a time, and the fold
// goes through the tile one slice at a time (all loops unrolled over AM:
// a loop over the slices that is not unrolled costs the AM_SLICE instance,
// at 255 registers, a spill). AM = AMAX keeps the head
// values in the g_h2 tile beside the staging (hw_in_tile), so g_h2 is
// formed in registers first and written there after a barrier.
template <bool WIDE, int AM>
__global__ void __launch_bounds__(NT, 1)
ppo_grad_f32_kernel(const Args p) {
  constexpr bool WIDE_A = AM > AMAX_NARROW;
  constexpr bool HW_TILE = hw_in_tile(AM);
  static_assert(WIDE || !WIDE_A, "the wide action instance reads x from L2");
  constexpr int NSUM = nsum(AM), NCST = ncst(AM);
  extern __shared__ __align__(16) float sm[];
  const int B = p.B, D = p.D, A = p.A, K = p.K;
  const Layout L{D, A, K};
  const int tower = blockIdx.y;
  const int g = blockIdx.x, G = gridDim.x;
  const bool actor = tower == 0;
  const int O = actor ? A : 1;
  const int M = K - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = lane >> 2, q = lane & 3;    // fragment row, column pair
  const int m0 = 16 * warp;                  // the warp's rows / outputs
  const int row_lo = m0 + lr;                // and row_lo + 8
  const int nd = (D + 7) / 8;                // depth steps of P0
  const int n4 = D / 8 + 1;                  // P4's tiles: x, a 1s column
  const int XD = WIDE ? 0 : D;               // x's floats in a ring row
  const int AR = HW_TILE ? 0 : A;            // act's floats in a ring row

  float* W2s = sm;                  // [out][WS] (in)
  float* h1s = W2s + H * WS;        // [row][WS] (in)  h1, later g_h1
  float* g2s = h1s + R * WS;        // [row][out] swizzled, g_h2
  float* b1s = g2s + TILE;
  float* b2s = b1s + H;
  float* whs = b2s + H;             // [O][H] head weight
  float* bhs = whs + AM * H;
  float* ring = bhs + AM;           // [2][slot]: obs, act, logp_old, adv/ret
  const int slot = slot_floats(WIDE, !HW_TILE, D, A, K);
  float* cst = ring + 2 * slot;     // [NCST] the loss's constants
  float* wsum = cst + NCST;         // [NW][NSUM] the warps' row sums
  float* nrm = wsum + NW * NSUM;    // [2][NW] largest squared row norms of
                                    // W1 and W2 over each warp's rows
  // the block's float64 retakes, first and second layer
  unsigned* rtk = reinterpret_cast<unsigned*>(nrm + 2 * NW);
  float* hw = (HW_TILE ? g2s + TILE / 2 : nrm + 2 * NW + 2) + 16 * AM * warp;
                                    // WIDE_A: [16][AM] the warp's rows' head
                                    // outputs, then their gradients

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
    if constexpr (!WIDE) cp::rows(dst, p.obs + r0 * D, nr * D, R * D, vec);
    if (actor) {
      if constexpr (!HW_TILE)
        cp::rows(dst + R * XD, p.act + r0 * A, nr * A, R * A, vec);
      cp::rows(dst + R * (XD + AR), p.logp_old + r0, nr, R, vec);
    }
    cp::rows(dst + R * (XD + AR + 1), (actor ? p.adv : p.ret) + r0 * K,
             nr * K, R * K, vec);
    cp::commit();
  };
  fetch(g, 0);

  // Weights, once.
  for (int i = tid; i < H * H; i += NT)
    W2s[(i >> 7) * WS + (i & (H - 1))] = gW2[i];
  for (int i = tid; i < H; i += NT) {
    b1s[i] = gb1[i];
    b2s[i] = gb2[i];
  }
  for (int i = tid; i < O * H; i += NT) whs[i] = gWh[i];
  if (tid < O) bhs[tid] = gbh[tid];
  {
    float m1 = 0.f, m2 = 0.f;
    for (int j = warp; j < H; j += NW) {
      float s1 = lane < D ? gW1[j * D + lane] : 0.f, s2 = 0.f;
      s1 *= s1;
      if constexpr (WIDE)
        for (int k = lane + 32; k < D; k += 32)
          s1 = fmaf(gW1[j * D + k], gW1[j * D + k], s1);
      for (int k = lane; k < H; k += 32) s2 = fmaf(gW2[j * H + k],
                                                   gW2[j * H + k], s2);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      m1 = fmaxf(m1, s1);
      m2 = fmaxf(m2, s2);
    }
    if (lane == 0) {
      nrm[warp] = m1;
      nrm[NW + warp] = m2;
    }
  }

  // the loss's constants and the row sums live in shared memory, out of
  // the registers that the products need
  const float(&sig)[AM] = *reinterpret_cast<const float(*)[AM]>(cst);
  const float(&lamv)[MMAX] =
      *reinterpret_cast<const float(*)[MMAX]>(cst + AM);
  if (tid == 0) {
    float lsig_sum = 0.f;
    for (int a = 0; a < AM; ++a) {
      const float ls = (actor && a < A) ? gls[a] : 0.f;
      cst[a] = WIDE_A ? ls : expf(ls);   // (WIDE_A: log-sigma)
      lsig_sum += ls;
    }
    for (int m = 0; m < MMAX; ++m) cst[AM + m] = m < M ? p.lam[m] : 0.f;
    cst[AM + MMAX] = lsig_sum;
    cst[AM + MMAX + 1] = *p.resc;
  }
  for (int i = tid; i < NW * NSUM; i += NT) wsum[i] = 0.f;
  if (tid < 2) rtk[tid] = 0u;

  // the block's partial: [1+K][tower_size(0)] gradients in tower-local order
  const int T = K + 1;
  const int Pmax = L.tower_size(0);
  float* out = p.part + ((size_t)g * T + tower) * Pmax;
  float2* oW2 = reinterpret_cast<float2*>(out + L.local_off(tower, 2));

  // dW1 holds db1 in its column D (P4's column of ones), db2 the bias
  // gradient of the warp's outputs row_lo, row_lo + 8 (P2's tile of ones)
  float dW1[8], db2[2] = {0.f, 0.f}, acc[64];
#pragma unroll
  for (int i = 0; i < 8; ++i) dW1[i] = 0.f;
  // the lane's head-weight column sums (columns column_of<32>(lane, i);
  // WIDE_A: none, see the kernel's head)
  float cs_wh[AM][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int a = 0; a < AM; ++a) cs_wh[a][i] = 0.f;

  int it = 0;
  for (int c = g; c < n_chunks; c += G, ++it) {
    const int nr = min(R, B - c * R);
    const float* rows = ring + (it & 1) * slot;
    // [R][D]: the chunk's x in the ring, or (WIDE) in global memory, where
    // a dead row (r >= nr) must not be read
    const float* xs = WIDE ? p.obs + (size_t)c * R * D : rows;
    auto xv = [&](int r, int d) {
      return WIDE && r >= nr ? 0.f : (WIDE ? __ldg(xs + r * D + d)
                                           : xs[r * D + d]);
    };
    cp::wait<0>();
    // the chunk's rows have landed, and every warp has left the last chunk
    // (so the other slot and every tile are free)
    __syncthreads();
    if (c + G < n_chunks) fetch(c + G, (it + 1) & 1);

    // P0: h1 = relu(x W1^T + b1) on the warp's rows, into its tile; the
    // h1 > 0 mask stays in registers (bit 4 jb + 2 h + e)
    // (W1 is read from global memory, where it stays in L1)
    zero(acc);
    for (int kk = 0; kk < nd; ++kk) {
      const int d = 8 * kk + 2 * q;
      tf32::FragA a;
      if constexpr (WIDE) {
        a = tf32::frag_a(d < D ? xv(row_lo, d) : 0.f,
                         d < D ? xv(row_lo + 8, d) : 0.f,
                         d + 1 < D ? xv(row_lo, d + 1) : 0.f,
                         d + 1 < D ? xv(row_lo + 8, d + 1) : 0.f);
      } else {
        const float* x0 = xs + row_lo * D;
        const float* x1 = xs + (row_lo + 8) * D;
        a = tf32::frag_a(
            d < D ? x0[d] : 0.f, d < D ? x1[d] : 0.f,
            d + 1 < D ? x0[d + 1] : 0.f, d + 1 < D ? x1[d + 1] : 0.f);
      }
#pragma unroll
      for (int jb = 0; jb < 16; ++jb) {
        const float* w = gW1 + (8 * jb + lr) * D;
        tf32::mma3(acc + 4 * jb, a,
                   tf32::frag_b(d < D ? __ldg(w + d) : 0.f,
                                d + 1 < D ? __ldg(w + d + 1) : 0.f));
      }
    }
    // Fragment element i = 4 jb + 2 h + e is row row_lo + 8 h, unit
    // 8 jb + 2 q + e. Those within the bound of 0 (bit i of near) are taken
    // again in float64.
    uint32_t mask[2] = {0u, 0u};
    float tau2[2];   // the bound for the rows' second-layer pre-activations
    {
      float2 ld[16];
      load_cols(ld, b1s, q);
      const float s1 = kink_scale(nrm);
      float tau[2], hsq[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* x = xs + (row_lo + 8 * h) * D;
        float n = 0.f;
        if (!WIDE || row_lo + 8 * h < nr)   // (a dead row's tau is 0)
          for (int d = 0; d < D; ++d) n = fmaf(x[d], x[d], n);
        tau[h] = s1 * sqrtf(n);
      }
      uint64_t near = 0;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float z0 = acc[4 * jb + 2 * h] + ld[jb].x;
          const float z1 = acc[4 * jb + 2 * h + 1] + ld[jb].y;
          const int i = 4 * jb + 2 * h;
          near |= (uint64_t)(fabsf(z0) < tau[h]) << i;
          near |= (uint64_t)(fabsf(z1) < tau[h]) << (i + 1);
          const float v0 = fmaxf(z0, 0.f), v1 = fmaxf(z1, 0.f);
          mask[jb >> 3] |= (v0 > 0.f ? 1u : 0u) << (i & 31);
          mask[jb >> 3] |= (v1 > 0.f ? 1u : 0u) << ((i + 1) & 31);
          hsq[h] = fmaf(v0, v0, fmaf(v1, v1, hsq[h]));
          *reinterpret_cast<float2*>(h1s + (row_lo + 8 * h) * WS + 8 * jb +
                                     2 * q) = make_float2(v0, v1);
        }
      }
      if (near) atomicAdd(rtk, (unsigned)__popcll(near));
      while (near) {
        const int i = __ffsll((long long)near) - 1;
        near &= near - 1;
        const int r = row_lo + 8 * ((i >> 1) & 1);
        const int j = 8 * (i >> 2) + 2 * q + (i & 1);
        const float v =
            fmaxf((float)z1_exact(xs + r * D, gW1 + j * D, b1s[j], D), 0.f);
        h1s[r * WS + j] = v;
        const uint32_t bit = 1u << (i & 31), on = v > 0.f ? bit : 0u;
        if (i >> 5)
          mask[1] = (mask[1] & ~bit) | on;
        else
          mask[0] = (mask[0] & ~bit) | on;
      }
      const float s2 = kink_scale(nrm + NW);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hsq[h] += __shfl_xor_sync(0xffffffffu, hsq[h], 1);
        hsq[h] += __shfl_xor_sync(0xffffffffu, hsq[h], 2);
        tau2[h] = s2 * sqrtf(hsq[h]);
        // WIDE: a dead row's x is not read, so it is never taken again
        if (WIDE && row_lo + 8 * h >= nr) tau2[h] = 0.f;
      }
    }
    __syncwarp();   // P1 reads the warp's own rows of h1

    // P1: h2 = relu(h1 W2^T + b2), kept in registers
    zero(acc);
#pragma unroll 1
    for (int ks = 0; ks < H / 8; ++ks) {
      const int k = 8 * ks + 2 * q;
      const float2 u0 =
          *reinterpret_cast<const float2*>(h1s + row_lo * WS + k);
      const float2 u1 =
          *reinterpret_cast<const float2*>(h1s + (row_lo + 8) * WS + k);
      const tf32::FragA a = tf32::frag_a(u0.x, u1.x, u0.y, u1.y);
#pragma unroll
      for (int jb = 0; jb < 16; ++jb) {
        const float2 w =
            *reinterpret_cast<const float2*>(W2s + (8 * jb + lr) * WS + k);
        tf32::mma3(acc + 4 * jb, a, tf32::frag_b(w.x, w.y));
      }
    }
    {
      float2 ld[16];
      load_cols(ld, b2s, q);
      uint64_t near = 0;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float z0 = acc[4 * jb + 2 * h] + ld[jb].x;
          const float z1 = acc[4 * jb + 2 * h + 1] + ld[jb].y;
          const int i = 4 * jb + 2 * h;
          near |= (uint64_t)(fabsf(z0) < tau2[h]) << i;
          near |= (uint64_t)(fabsf(z1) < tau2[h]) << (i + 1);
          acc[i] = fmaxf(z0, 0.f);
          acc[i + 1] = fmaxf(z1, 0.f);
        }
      if (near) atomicAdd(rtk + 1, (unsigned)__popcll(near));
      // one at a time by the whole warp, the lowest lane's first
      for (;;) {
        const unsigned who = __ballot_sync(0xffffffffu, near != 0);
        if (!who) break;
        const int src = __ffs(who) - 1;
        int i = 0;
        if (lane == src) {
          i = __ffsll((long long)near) - 1;
          near &= near - 1;
        }
        i = __shfl_sync(0xffffffffu, i, src);
        const int r = m0 + (src >> 2) + 8 * ((i >> 1) & 1);
        const int j = 8 * (i >> 2) + 2 * (src & 3) + (i & 1);
        const float v = fmaxf(
            z2_exact(xs + r * D, gW1, b1s, W2s + j * WS, b2s[j], D, lane),
            0.f);
        if (lane == src) {
#pragma unroll
          for (int t = 0; t < 64; ++t)
            if (t == i) acc[t] = v;
        }
      }
    }

    // heads: a partial dot product per lane, summed over the quad
    float gh[2][AM];   // (WIDE_A: the gradients are in hw)
    if constexpr (WIDE_A) {
      // the rows' head outputs into hw, by lane 0 of the quad
#pragma unroll
      for (int a0 = 0; a0 < AM; a0 += AM_SLICE)
#pragma unroll
        for (int u = 0; u < AM_SLICE; ++u) {
          const int a = a0 + u;
          if (a < O) {
            float2 ld[16];
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
              hw[lr * AM + a] = o0 + bhs[a];
              hw[(lr + 8) * AM + a] = o1 + bhs[a];
            }
          }
        }
      __syncwarp();
      // the row's loss: lanes 0 and 1 of the quad take row_lo and row_lo +
      // 8, and write the gradient at the head's output over its output
      const int h = q & 1, r = row_lo + 8 * h;
      const bool live = r < nr, own = q < 2;
      float* hrow = hw + (lr + 8 * h) * AM;
      const float* tail = rows + R * (XD + AR + 1) + r * K;  // adv / ret
      auto add = [&](int k, float v) {
        warp_add(wsum + warp * NSUM + k, v, lane);
      };
      if (actor) {
        // a dead row is zero-filled, so its loss is finite; it is masked
        // (HW_TILE: its actions are those of the chunk's first row)
        const float* act_row =
            HW_TILE ? p.act + ((size_t)c * R + (live ? r : 0)) * A
                    : rows + R * XD + r * A;
        actor_row_shared<AM, double>(hrow, hrow, own, live, act_row,
                                     rows[R * (XD + AR) + r], tail, cst, lamv,
                                     cst[AM + MMAX + 1], p, add);
      } else {
        float diff = 0.f, gv = 0.f;
        if (own) {
          diff = hrow[0] - tail[tower - 1];
          gv = p.gv_scale * diff;
          hrow[0] = live ? gv : 0.f;
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
          float2 ld[16];
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

      // the row's loss and the gradient at the head's output. Every lane of
      // a quad holds both rows' head outputs; lanes 0 and 1 of the quad take
      // row_lo and row_lo + 8 (lanes 2 and 3 repeat them, unused).
      {
        const int h = q & 1, r = row_lo + 8 * h;
        const bool live = r < nr, mine = live && q < 2;
        float hr[AM], g_out[AM];
#pragma unroll
        for (int a = 0; a < AM; ++a) {
          hr[a] = h ? hd[1][a] : hd[0][a];
          g_out[a] = 0.f;
        }
        const float* tail = rows + R * (XD + AR + 1) + r * K;  // adv / ret
        // the row's terms of the block's sums: head bias and log-sigma
        // gradients, kl, min surrogate, diff^2, ratio * cadv
        float vals[NSUM];
#pragma unroll
        for (int k = 0; k < NSUM; ++k) vals[k] = 0.f;
        if (actor) {
          // a dead row is zero-filled, so its loss is finite; it is masked
          const ActorRow<AM> o = actor_row(
              hr, rows + R * XD + r * A, rows[R * (XD + AR) + r], tail, sig,
              cst[AM + MMAX], lamv, cst[AM + MMAX + 1], p);
#pragma unroll
          for (int a = 0; a < AM; ++a) g_out[a] = live ? o.g_mu[a] : 0.f;
          if (mine) {
#pragma unroll
            for (int a = 0; a < AM; ++a) {
              vals[a] = o.g_mu[a];
              vals[AM + a] = o.g_ls[a];
            }
            vals[2 * AM] = o.kl;
            vals[2 * AM + 1] = o.mins;
#pragma unroll
            for (int m = 0; m < MMAX; ++m)
              if (m < M) vals[2 * AM + 3 + m] = o.ratio * tail[1 + m];
          }
        } else {
          const float diff = hr[0] - tail[tower - 1];
          const float gv = p.gv_scale * diff;
          g_out[0] = live ? gv : 0.f;
          if (mine) {
            vals[0] = gv;
            vals[2 * AM + 2] = diff * diff;
          }
        }
        // summed over the warp's rows by a fixed shuffle tree and added to
        // the warp's sums (the sums this tower has, a warp-uniform choice)
#pragma unroll
        for (int k = 0; k < NSUM; ++k) {
          const bool used =
              actor ? (k < A || (k >= AM && k < AM + A) || k == 2 * AM ||
                       k == 2 * AM + 1 ||
                       (k >= 2 * AM + 3 && k < 2 * AM + 3 + M))
                    : (k == 0 || k == 2 * AM + 2);
          if (used) {
            float v = vals[k];
#pragma unroll
            for (int s = 16; s > 0; s >>= 1)
              v += __shfl_xor_sync(0xffffffffu, v, s);
            if (lane == 0) wsum[warp * NSUM + k] += v;
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
      // first chunk storing and later ones adding. The tile's first half
      // holds one slice of AM_SLICE actions at a time.
      float* stg = g2s;   // [NW][AM_SLICE][H]
      float* oWh = out + L.local_off(tower, 4);
#pragma unroll
      for (int a0 = 0; a0 < AM; a0 += AM_SLICE) {
        if (a0 >= O) break;            // (block-uniform)
        if (a0 > 0) __syncthreads();   // the last slice has been folded
#pragma unroll
        for (int u = 0; u < AM_SLICE; ++u) {
          const int a = a0 + u;
          if (a < O) {
            const float ga = hw[lr * AM + a], gb = hw[(lr + 8) * AM + a];
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
      // g_h2 takes the staging's place (HW_TILE: after the barrier below)
      if constexpr (!HW_TILE) __syncthreads();
    } else {
#pragma unroll
      for (int a = 0; a < AM; ++a)
        if (a < O) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            v[i] = gh[0][a] * acc[4 * (i >> 1) + (i & 1)] +
                   gh[1][a] * acc[4 * (i >> 1) + 2 + (i & 1)];
          column_sums(v, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) cs_wh[a][i] += v[i];
        }
    }

    // g_h2 = (gh Wh) * (h2 > 0) in place of h2, into its tile
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 8) {   // 8 column groups at a time
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      // s += ga w_a (row row_lo) and gb w_a (row row_lo + 8) over the head
      // outputs a: WIDE_A AM_SLICE at a time from hw, else from registers
#pragma unroll
      for (int a0 = 0; a0 < (WIDE_A ? AM : 1); a0 += AM_SLICE)
#pragma unroll
        for (int u = 0; u < (WIDE_A ? AM_SLICE : AM); ++u) {
          const int a = WIDE_A ? a0 + u : u;
          if (a < O) {
            float2 w[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              w[i] = *reinterpret_cast<const float2*>(whs + a * H +
                                                      8 * (j0 + i) + 2 * q);
            const float ga = WIDE_A ? hw[lr * AM + a] : gh[0][u];
            const float gb = WIDE_A ? hw[(lr + 8) * AM + a] : gh[1][u];
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
          if constexpr (!HW_TILE)
            *reinterpret_cast<float2*>(
                g2s + sw(row_lo + 8 * h, 8 * jb + 2 * q)) =
                make_float2(g0, g1);
        }
      }
    }
    if constexpr (HW_TILE) {
      // every warp has read its head values and the fold's staging
      __syncthreads();
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              g2s + sw(row_lo + 8 * h, 8 * jb + 2 * q)) =
              make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
    }
    __syncthreads();   // P2 reads every row of g_h2 and h1

    // P2: dW2 += g_h2^T h1 on the warp's 16 outputs, and db2 += g_h2^T 1
    // in a 17th tile whose B is ones (exact in TF32: its low part is 0).
    // The chunk's product is added to dW2 with round-to-nearest adds. dW2
    // is summed in the block's partial (L2-resident), not in 64 registers
    // that would sit idle through the other products: each thread alone
    // reads and writes its entries there, the first chunk storing and later
    // ones adding
    {
      zero(acc);
      float ones[4] = {0.f, 0.f, 0.f, 0.f};
      const uint32_t one = 0x3f800000u;   // 1.0f
#pragma unroll 1
      for (int ks = 0; ks < R / 8; ++ks) {
        const int r = 8 * ks + q;
        const tf32::FragA a = tf32::frag_a(
            g2s[sw(r, row_lo)], g2s[sw(r, row_lo + 8)],
            g2s[sw(r + 4, row_lo)], g2s[sw(r + 4, row_lo + 8)]);
        const float* b = h1s + r * WS + lr;
#pragma unroll
        for (int jb = 0; jb < 16; ++jb)
          tf32::mma3(acc + 4 * jb, a,
                     tf32::frag_b(b[8 * jb], b[4 * WS + 8 * jb]));
        float t[4];
        tf32::mma0(t, a.lo, one, one);
        tf32::mma(t, a.hi, one, one);
        tf32::add4(ones, t);
      }
      // fragment element 4 jb + 2 h (+ 1): output row_lo + 8 h, input
      // 8 jb + 2 q (+ 1)
      float2* dw = oW2 + ((row_lo * H) >> 1) + q;
      if (it > 0) {
        float2 old[32];
#pragma unroll
        for (int i = 0; i < 32; ++i)
          old[i] = dw[(i & 1) * 4 * H + 4 * (i >> 1)];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          acc[2 * i] += old[i].x;
          acc[2 * i + 1] += old[i].y;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dw[(i & 1) * 4 * H + 4 * (i >> 1)] =
            make_float2(acc[2 * i], acc[2 * i + 1]);
      db2[0] += ones[0];
      db2[1] += ones[2];
    }

    // P3: g_h1 = g_h2 W2 on the warp's rows (masked below)
    zero(acc);
#pragma unroll 1
    for (int ks = 0; ks < H / 8; ++ks) {
      const int k = 8 * ks + q;
      const tf32::FragA a = tf32::frag_a(
          g2s[sw(row_lo, k)], g2s[sw(row_lo + 8, k)], g2s[sw(row_lo, k + 4)],
          g2s[sw(row_lo + 8, k + 4)]);
      const float* b = W2s + k * WS + lr;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
        tf32::mma3(acc + 4 * jb, a,
                   tf32::frag_b(b[8 * jb], b[4 * WS + 8 * jb]));
    }

    __syncthreads();   // every warp has read h1: g_h1 takes its place

    // g_h1 = (g_h2 W2) * (h1 > 0) into the h1 tile
#pragma unroll
    for (int jb = 0; jb < 16; ++jb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int bit = (4 * jb + 2 * h) & 31;
        const uint32_t m = mask[jb >> 3] >> bit;
        const float g0 = (m & 1u) ? acc[4 * jb + 2 * h] : 0.f;
        const float g1 = (m & 2u) ? acc[4 * jb + 2 * h + 1] : 0.f;
        *reinterpret_cast<float2*>(h1s + (row_lo + 8 * h) * WS + 8 * jb +
                                   2 * q) = make_float2(g0, g1);
      }
    }
    __syncthreads();   // P4 reads every row of g_h1

    if constexpr (WIDE) {
      // P4: the chunk's g_h1^T [x 1] on the warp's 16 outputs, P4_TILES
      // tiles of 8 columns at a time into acc (tile nt at acc[4 nt]), each
      // slice added into the block's partial; column D (ones) gives db1
      float* pW1 = out + L.local_off(tower, 0);
      float* pb1 = out + L.local_off(tower, 1);
#pragma unroll 1
      for (int t0 = 0; t0 < n4; t0 += P4_TILES) {
        zero(acc);
#pragma unroll 1
        for (int ks = 0; ks < R / 8; ++ks) {
          const int r = 8 * ks + q;
          const float* g1 = h1s + r * WS + row_lo;
          const tf32::FragA a =
              tf32::frag_a(g1[0], g1[8], g1[4 * WS], g1[4 * WS + 8]);
#pragma unroll
          for (int nt = 0; nt < P4_TILES; ++nt)
            if (t0 + nt < n4) {
              const int d = 8 * (t0 + nt) + lr;
              const float one = d == D ? 1.f : 0.f;
              tf32::mma3(acc + 4 * nt, a,
                         tf32::frag_b(d < D ? xv(r, d) : one,
                                      d < D ? xv(r + 4, d) : one));
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = row_lo + 8 * h;
#pragma unroll
          for (int nt = 0; nt < P4_TILES; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = 8 * (t0 + nt) + 2 * q + e;
              if (t0 + nt < n4 && d <= D) {
                float* o = d < D ? pW1 + j * D + d : pb1 + j;
                const float v1 = acc[4 * nt + 2 * h + e];
                *o = it > 0 ? *o + v1 : v1;
              }
            }
        }
      }
    } else {
      // P4: dW1 += g_h1^T [x 1] on the warp's 16 outputs, as dW2; column D
      // (ones) gives db1
      float d1[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) d1[i] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < R / 8; ++ks) {
        const int r = 8 * ks + q;
        const float* g1 = h1s + r * WS + row_lo;
        const tf32::FragA a =
            tf32::frag_a(g1[0], g1[8], g1[4 * WS], g1[4 * WS + 8]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          if (nt < n4) {
            const int d = 8 * nt + lr;
            const float one = d == D ? 1.f : 0.f;
            tf32::mma3(d1 + 4 * nt, a,
                       tf32::frag_b(d < D ? xs[r * D + d] : one,
                                    d < D ? xs[(r + 4) * D + d] : one));
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) dW1[i] += d1[i];
    }
  }
  __syncthreads();   // the tiles are free from here on
  if (tid < 2 && rtk[tid])
    atomicAdd(&retakes[tid], (unsigned long long)rtk[tid]);

  // the rest of the block's partial
  {
    float* oW1 = out + L.local_off(tower, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = row_lo + 8 * h;
      if constexpr (!WIDE) {   // (WIDE: summed there chunk by chunk)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = 8 * nt + 2 * q + e;
            if (d < D) oW1[j * D + d] = dW1[4 * nt + 2 * h + e];
            if (d == D)
              out[L.local_off(tower, 1) + j] = dW1[4 * nt + 2 * h + e];
          }
      }
      if (q == 0) out[L.local_off(tower, 3) + j] = db2[h];
    }
  }
  // the lanes' head-weight column sums, per warp, summed over the warps in
  // order (WIDE_A: summed there chunk by chunk)
  if constexpr (!WIDE_A) {
    float* pcol = sm;                      // [NW][AM][H]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int a = 0; a < AM; ++a)
        pcol[(warp * AM + a) * H + column_of<32>(lane, i)] = cs_wh[a][i];
    __syncthreads();
    for (int i = tid; i < O * H; i += NT) {
      float s = 0.f;
      for (int w = 0; w < NW; ++w) s += pcol[w * AM * H + i];
      out[L.local_off(tower, 4) + i] = s;
    }
  }
  // the row sums, over the warps in order
  if (tid < NSUM) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += wsum[w * NSUM + tid];
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

template <bool WIDE, int AM>
cudaError_t launch(const Args& a, int G, cudaStream_t stream) {
  const size_t smem = smem_bytes_am<WIDE, AM>(a.D, a.A, a.K);
  cudaFuncSetAttribute(ppo_grad_f32_kernel<WIDE, AM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ppo_grad_f32_kernel<WIDE, AM><<<dim3(G, a.K + 1), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Above AMAX_NARROW actions the wide form (x read from L2) at any D: the
// narrow form's x in the ring and the wider head leave no room at D 12.
cudaError_t launch_f32(const Args& a, int G, cudaStream_t stream) {
  if (a.A > AM_SLICE) return launch<true, AMAX>(a, G, stream);
  if (a.A > AMAX_NARROW) return launch<true, AM_SLICE>(a, G, stream);
  return a.D > DMAX_F32_NARROW ? launch<true, AMAX_NARROW>(a, G, stream)
                               : launch<false, AMAX_NARROW>(a, G, stream);
}

size_t smem_bytes_f32(int D, int A, int K) { return smem_bytes(D, A, K); }

}  // namespace ppo

// The f32 kernel's float64 retakes since the last call ([0] first layer,
// [1] second), written to out[2]; clears them. Synchronises the device.
extern "C" int fsrl_ppo_grad_f32_retakes(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ppo::retakes, sizeof(ppo::retakes));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[2] = {0ull, 0ull};
  return (int)cudaMemcpyToSymbol(ppo::retakes, zero, sizeof(zero));
}
