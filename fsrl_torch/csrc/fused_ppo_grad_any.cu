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
// ms at the bf16 tensor-core peak (989 TFLOP/s); in f32 each product runs
// as three TF32 products (495 TFLOP/s), 0.24 ms. The bytes the design
// itself moves (h1, g_h2 and g_h1 written once and read back by the
// products over the rows) come to about 0.15 GB bf16 and 0.3 GB f32 there:
// 0.05 and 0.09 ms at 3.35 TB/s. What holds it back in practice is latency:
// each 64-row block walks its stages one after another.
//
// Design: three launches on the caller's stream.
//   1. row_kernel, grid (G, 1 + K): a block of one warpgroup (128 threads)
//      takes one tower and walks the 64-row blocks blockIdx.x, + G, ...
//      (G fills the card once, from the occupancy). For each row block:
//        A  h1 = relu(x W1^T + b1)                      depth D
//        B  h2 = relu(h1 W2^T + b2); at up to OSMALL (8) actions the heads
//           from the products' registers (the actor's mean in float32, a
//           critic's value on rounded operands where bf16)   depth H1
//        C  at more actions the heads as TF32 products of h2; the row loss
//           (a thread a row); the row values' sums over the rows; g_h2 =
//           (g_out W_head) * (h2 > 0) (from registers, or TF32 products),
//           its sums, and the head weight gradient g_out^T h2
//        D  g_h1 = (g_h2 W2) * (h1 > 0), its sums       depth H2
//      Each product is taken in chunks of 64 output columns (one
//      warpgroup's 64 x 64 accumulator), its operands staged through
//      shared memory 64 (bf16) or 32 (f32) deep, the next slice's loads
//      issued into registers before the current slice's products (f32: B
//      split into its TF32 parts once, as it is stored, for the four warps
//      that read it). In the f32 instance of up to OSMALL actions, which
//      the f32 training paths launch, stages B and D load and store their
//      slices 16 bytes at a time (TileF32V): a quarter of the load and
//      store instructions, whose issue, not the loads' latency, held each
//      slice (16% off the row kernel at hidden (256, 256) on the H100).
//      The weights stream from L2 slice by slice, so no width has to fit. The row block's h2 (64 x H2
//      float32) stays in shared memory (dynamic, up to H2 776; in device
//      memory above). h1, g_h2 and g_h1 go to device memory for the
//      products over the rows, as bf16 in the bf16 form (the plain version
//      rounds exactly those operands before its products, so storing them
//      rounded changes no bit of what the products consume) and float32 in
//      the f32 form. The block's sums over its rows (bias, head-weight and
//      log-sigma gradients, aux sums) go into its own float64 partial in
//      device memory, each entry owned by one thread across the row blocks.
//      The block's context lives in shared memory, so that it takes no
//      registers across the products; an instance of its own takes more
//      than OSMALL actions (MANY), so the main paths carry none of its
//      registers.
//   2. wgrad_kernel, grid (tiles x towers, S): dW2 = g_h2^T h1 and
//      dW1 = g_h1^T x, each a 64 x 128 (bf16) or 64 x 64 (f32) tile of the
//      weight over one slice of the rows (a multiple of 64 rows, S slices
//      chosen so that the tiles times the slices fill the card: the
//      256-row host minibatch runs 4 slices of 64 rows), into the slice's
//      own float partial.
//   3. reduce_kernel: each gradient entry the sum of its partials, over the
//      row blocks' grid (float64) or the slices, in index order, in float64;
//      the last block the aux row, a warp an entry.
//
// Products. bf16: wgmma (m64n128k16, m64n64k16) from tiles that the threads
// write in wgmma's canonical unswizzled layout (wgmma.cuh), converting the
// float32 weights and x as they load them; one stored tile serves as either
// operand major, so W2 is read K-major in stage B and MN-major in stage D,
// and the products over the rows take both operands MN-major, as the rows
// lie in memory. f32: mma.sync.m16n8k8 TF32, each product as three TF32
// products of split operands with each depth step in a fresh accumulator
// (mma_tf32.cuh), from float32 tiles with padded rows (no bank conflicts on
// the fragment loads). The warp's m16n8 tiles give the same (row, column)
// of each accumulator entry as wgmma's fragment, so every epilogue is
// written once for both forms. Widths that are not a multiple of the tile
// are zero-filled in shared memory: a zero term adds exactly 0.
//
// ReLU kinks (f32). The TF32 split is coarser than float32 FMAs, so near a
// kink this form would take the other side of a ReLU from a float32
// computation more often than another float32 computation does. As in the
// tuned f32 form, a pre-activation within KINK times its operands' norms of
// 0 (the row of x or h1, the largest row of W1 or W2; several times the
// products' error) is taken again in float64 from the float32 inputs: z1
// and z2 by the warp, with the row's h1 also taken again in float64 for z2.
// The form's ReLU sides are then those of exact arithmetic. Kept on the
// tensor cores rather than on float32 FMAs for z1 and z2: those are a
// third of the FLOPs, and the FP32 pipes run them at an eighth of the TF32
// split's rate; the retakes (thousands a launch at hidden (256, 256) and
// the port's init) are counted (fsrl_ppo_grad_any_retakes).
//
// Determinism. No float atomics: every sum has one owner and a fixed order
// (the products' depth order, the rows of a block in order, the row blocks
// of a partial in order, the partials in index order), so two launches
// agree bit for bit. The f32 form takes the row loss in float64, as the
// tuned f32 form does; the sums over the rows of the row values and of
// g_h2 are taken in float64.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "wgmma.cuh"

namespace ppo_any {
namespace {

constexpr int MMAX = 5;         // constraints
constexpr int AUXW = 8;         // aux sums a tower
constexpr int BR = 64;          // rows of a row block: wgmma's M
constexpr int NT = 128;         // threads of the row and product kernels
constexpr int NW = NT / 32;     // their warps
constexpr int NT_RED = 256;     // threads of the reduce: a warp an aux sum
constexpr int NCMAX = 128;      // output columns of a bf16 product chunk
constexpr int NCF = 64;         // of a float32 (TF32) product chunk
constexpr int NCR = 64;         // of the row kernel's stage products
constexpr int NCM = 32;         // of its products at many actions
constexpr int KSB = 64;         // depth of a staged slice, bf16
constexpr int KSF = 32;         // depth of a staged slice, f32
constexpr int FK = KSF + 4;     // f32 tile rows along the depth
constexpr int FA = BR + 8;      // f32 tile rows of 64 outputs (MN-major A)
constexpr int FB = NCF + 8;     // f32 tile rows of a chunk (MN-major B)
constexpr int RPS = 64;         // the product kernel's slices: multiples
constexpr int SMAX = 64;        // row slices, at most
constexpr float KINK = 0x1p-17f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(NT_RED / 32 == AUXW, "the reduce's last block: a warp an aux");

__host__ __device__ constexpr int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr long cdiv(long a, long b) {
  return (a + b - 1) / b;
}

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
  // scratch rows of h1 / g_h1 and h2 / g_h2, padded with zeros to whole
  // 16-byte units of bf16
  __host__ __device__ int ld1() const { return pad8(H1); }
  __host__ __device__ int ld2() const { return pad8(H2); }
  // A row of the row values: actor [g_mu (A) | d loss / d log-sigma (A) |
  // kl | min surrogate | 0 | ratio * cadv (M)], critic [g_v | 0 | 0 |
  // diff^2]; on entry to the loss the first O columns hold the heads.
  __host__ __device__ int rv_width() const { return 2 * A + 2 + K; }
  __host__ __device__ int rv_heads(int t) const { return t == 0 ? 2 * A : 1; }
  __host__ __device__ int rv_cols(int t) const {
    return t == 0 ? rv_width() : 4;
  }
  // A row kernel block's float64 partial of one tower: b1 (H1), b2 (H2),
  // head weight (O x H2), head bias and log-sigma (2 A), aux (AUXW).
  __host__ __device__ long pd_b2() const { return H1; }
  __host__ __device__ long pd_hw() const { return (long)H1 + H2; }
  __host__ __device__ long pd_hb() const { return pd_hw() + (long)A * H2; }
  __host__ __device__ long pd_aux() const { return pd_hb() + 2L * A; }
  __host__ __device__ long pd_width() const { return pd_aux() + AUXW; }
  // A product slice's float partial of one tower: dW1 (H1 x D), dW2
  // (H2 x H1).
  __host__ __device__ long pw_w2() const { return (long)H1 * D; }
  __host__ __device__ long pw_width() const {
    return pw_w2() + (long)H2 * H1;
  }
  // the product kernel's tiles of one tower at chunks of nc columns: dW2,
  // then dW1
  __host__ __device__ int tiles_w2(int nc) const {
    return (int)(cdiv(H2, BR) * cdiv(H1, nc));
  }
  __host__ __device__ int tiles(int nc) const {
    return tiles_w2(nc) + (int)(cdiv(H1, BR) * cdiv(D, nc));
  }
};

// The element type of the scratch rows and the staged tiles' sizes.
template <bool BF>
struct Mode;
template <>
struct Mode<true> {
  using T = __nv_bfloat16;
  static constexpr int A_BYTES = BR * KSB * 2;
  static constexpr int B_BYTES = NCMAX * KSB * 2;
};
// f32: the B tile holds each operand split once, as it is stored: the
// TF32 high parts, then the low parts (tf32::split), so that the four warps
// that read a B fragment do not each split it again.
template <>
struct Mode<false> {
  using T = float;
  static constexpr int A_FLOATS = BR * FK > KSF * FA ? BR * FK : KSF * FA;
  static constexpr int B_HALF = NCF * FK > KSF * FB ? NCF * FK : KSF * FB;
  static constexpr int A_BYTES = 4 * A_FLOATS;
  static constexpr int B_BYTES = 8 * B_HALF;
};
// The row kernel's tiles: the f32 form's, which its bf16 form also uses for
// the actor's float32 products at many actions (heads, g_h2, head weight
// gradient).
constexpr int ROW_TILE_BYTES = Mode<false>::A_BYTES + Mode<false>::B_BYTES;
static_assert(ROW_TILE_BYTES >= Mode<true>::A_BYTES + NCF * KSB * 2,
              "the bf16 row kernel's tiles in the f32 form's");
// Up to this many actions the heads and g_h2 are taken from registers;
// above it on the tensor cores as float32 products.
constexpr int OSMALL = 8;
static_assert(4 * (NW * NCMAX + BR * OSMALL) <= ROW_TILE_BYTES,
              "the staging that shares the tiles");


// Pre-activations the f32 form took again in float64, [0] in the first
// layer and [1] in the second, summed over launches until
// fsrl_ppo_grad_any_retakes reads and clears them.
__device__ unsigned long long any_retakes[2];

// ------------------------------------------------------------ small helpers

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// two neighbouring entries of a scratch row (the column even)
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}
__device__ __forceinline__ void st1(float* p, float a) { *p = a; }

// Accumulator entry i of a 64 x NC chunk (wgmma's fragment, and the four
// warps' m16n8 tiles alike): row 16 w + l / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (l % 4) + (i & 1).
__device__ __forceinline__ int frag_row(int i) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// ------------------------------------------------------------ tile loaders

// 8 entries of a source row from p, the first n (n >= 1) of them there,
// rounded to bf16: two 16-byte loads where all 8 are there and p is on 16
// bytes, else one load each.
__device__ __forceinline__ uint4 unit8(const float* p, long n) {
  float f[8];
  if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = i < n ? p[i] : 0.f;
  }
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}
// bf16 scratch rows are padded to whole units: one 16-byte load
__device__ __forceinline__ uint4 unit8(const __nv_bfloat16* p, long) {
  return *reinterpret_cast<const uint4*>(p);
}

// A bf16 tile of ROWS x COLS in wgmma's canonical layout (COLS / 8 column
// groups): entry (r, c) is src[(row0 + r) ld + col0 + c], 0 where
// row0 + r >= nrows or col0 + c >= ncols. The tile's columns are the
// source's contiguous index. fetch() issues the loads into registers,
// put() stores them, so that a slice's loads are in flight under the
// previous slice's products. Eight neighbouring threads take the eight
// rows of one core matrix (16-byte stores to 128 contiguous bytes), four
// such groups a unit of columns each.
template <int ROWS, int COLS, class Src>
struct TileBf16 {
  static constexpr int CG = COLS / 8, N = ROWS * CG / NT;
  static_assert(ROWS % 8 == 0 && (ROWS * CG) % NT == 0, "tile shape");
  uint4 v[N];
  __device__ __forceinline__ static int row(int i) {
    const int u = threadIdx.x + i * NT;
    return ((u >> 3) / CG) * 8 + (u & 7);
  }
  __device__ __forceinline__ static int col(int i) {
    return (((threadIdx.x + i * NT) >> 3) % CG) * 8;
  }
  __device__ __forceinline__ void fetch(const Src* src, long ld, long row0,
                                        long nrows, long col0, long ncols) {
    const Src* base = src + row0 * ld + col0;
    const long mr = nrows - row0, mc = ncols - col0;
    const int nr = (int)(mr < ROWS ? mr : ROWS);
    const int nc = (int)(mc < COLS ? mc : COLS);
    const int ldi = (int)ld;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = row(i), c = col(i);
      v[i] = r < nr && c < nc ? unit8(base + r * ldi + c, nc - c)
                              : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void put(uint8_t* tile) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      *reinterpret_cast<uint4*>(tile + wg::tile_off(row(i), col(i), CG)) =
          v[i];
  }
};

// A float32 tile of ROWS x COLS with rows of STRIDE floats, entries as in
// TileBf16 (fetch() and put() alike). SPLIT: each entry stored as its TF32
// high part at tile[] and its low part HALF floats on (tf32::split's bits).
template <int ROWS, int COLS, int STRIDE, bool SPLIT = false, int HALF = 0>
struct TileF32 {
  static constexpr int N = ROWS * COLS / NT;
  static_assert((ROWS * COLS) % NT == 0, "tile shape");
  float v[N];
  __device__ __forceinline__ void fetch(const float* src, long ld, long row0,
                                        long nrows, long col0, long ncols) {
    const float* base = src + row0 * ld + col0;
    const long mr = nrows - row0, mc = ncols - col0;
    const int nr = (int)(mr < ROWS ? mr : ROWS);
    const int nc = (int)(mc < COLS ? mc : COLS);
    const int ldi = (int)ld;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * NT, r = e / COLS, c = e % COLS;
      v[i] = r < nr && c < nc ? base[r * ldi + c] : 0.f;
    }
  }
  __device__ __forceinline__ void put(float* tile) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * NT, r = e / COLS, c = e % COLS;
      if constexpr (SPLIT) {
        uint32_t hi, lo;
        tf32::split(v[i], hi, lo);
        reinterpret_cast<uint32_t*>(tile)[r * STRIDE + c] = hi;
        reinterpret_cast<uint32_t*>(tile)[HALF + r * STRIDE + c] = lo;
      } else {
        tile[r * STRIDE + c] = v[i];
      }
    }
  }
};

// TileF32 (COLS and STRIDE multiples of 4) loaded and stored 16 bytes at a
// time: four neighbouring entries of a row a unit, from the source where
// all four are there and the source's rows lie on 16 bytes, else one by
// one as TileF32 takes them (the same entries, zeros where TileF32 has
// zeros).
template <int ROWS, int COLS, int STRIDE, bool SPLIT = false, int HALF = 0>
struct TileF32V {
  static constexpr int CU = COLS / 4, N = ROWS * CU / NT;
  static_assert(COLS % 4 == 0 && STRIDE % 4 == 0 && HALF % 4 == 0 &&
                    (ROWS * CU) % NT == 0,
                "tile shape");
  float4 v[N];
  __device__ __forceinline__ void fetch(const float* src, long ld, long row0,
                                        long nrows, long col0, long ncols) {
    const float* base = src + row0 * ld + col0;
    const long mr = nrows - row0, mc = ncols - col0;
    const int nr = (int)(mr < ROWS ? mr : ROWS);
    const int nc = (int)(mc < COLS ? mc : COLS);
    const int ldi = (int)ld;
    const bool vec =
        (ldi & 3) == 0 && (reinterpret_cast<uintptr_t>(base) & 15) == 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * NT, r = e / CU, c = 4 * (e % CU);
      const float* p = base + r * ldi + c;
      if (vec && r < nr && c + 4 <= nc) {
        v[i] = *reinterpret_cast<const float4*>(p);
      } else {
        const bool in = r < nr;
        v[i] = make_float4(in && c < nc ? p[0] : 0.f,
                           in && c + 1 < nc ? p[1] : 0.f,
                           in && c + 2 < nc ? p[2] : 0.f,
                           in && c + 3 < nc ? p[3] : 0.f);
      }
    }
  }
  __device__ __forceinline__ void put(float* tile) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * NT, r = e / CU, c = 4 * (e % CU);
      float4* at = reinterpret_cast<float4*>(tile + r * STRIDE + c);
      if constexpr (SPLIT) {
        uint32_t h[4], l[4];
        tf32::split(v[i].x, h[0], l[0]);
        tf32::split(v[i].y, h[1], l[1]);
        tf32::split(v[i].z, h[2], l[2]);
        tf32::split(v[i].w, h[3], l[3]);
        *reinterpret_cast<uint4*>(at) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(tile + HALF + r * STRIDE + c) =
            make_uint4(l[0], l[1], l[2], l[3]);
      } else {
        *at = v[i];
      }
    }
  }
};

// ------------------------------------------------------------ the products

template <int NC, int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[NC / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (NC == 128)
    wg::mma_m64n128k16<TA, TB>(d, da, db, scale_d);
  else
    wg::mma_m64n64k16<TA, TB>(d, da, db, scale_d);
}

// acc (+)= A B over one staged bf16 slice of KSB: A 64 x KSB (K-major
// tile [64][KSB], or MN-major [KSB][64] if AMN), B KSB x NC (K-major
// [NC][KSB], or MN-major [KSB][NC] if BMN). `first`: acc is overwritten.
template <int NC, bool AMN, bool BMN>
__device__ __forceinline__ void slice_bf16(float (&acc)[NC / 2], uint32_t aT,
                                           uint32_t bT, bool first) {
  wg::arrive();
#pragma unroll
  for (int ks = 0; ks < KSB / 16; ++ks) {
    const uint64_t da = AMN ? wg::desc_mnmajor(aT, BR / 8, 16 * ks, 0)
                            : wg::desc_kmajor(aT, KSB / 8, 0, 16 * ks);
    const uint64_t db = BMN ? wg::desc_mnmajor(bT, NC / 8, 16 * ks, 0)
                            : wg::desc_kmajor(bT, KSB / 8, 0, 16 * ks);
    wgmma_k16<NC, AMN ? 1 : 0, BMN ? 1 : 0>(acc, da, db,
                                            first && ks == 0 ? 0 : 1);
  }
  wg::commit();
  wg::wait_all();
  wg::fence_regs(acc);
}

// acc += A B over one staged f32 slice of KSF, three TF32 products a depth
// step: A K-major [64][FK] or MN-major [KSF][FA], split here; B K-major
// [NC][FK] or MN-major [KSF][FB], split as it was stored (high parts, then
// the low parts B_HALF floats on). Warp w takes rows 16 w .. 16 w + 15.
template <int NC, bool AMN, bool BMN>
__device__ __forceinline__ void slice_f32(float (&acc)[NC / 2],
                                          const float* As,
                                          const uint32_t* Bs) {
  constexpr int LO = Mode<false>::B_HALF;
  const int lane = threadIdx.x & 31, lr = lane >> 2, q = lane & 3;
  const int m = 16 * (threadIdx.x >> 5) + lr;
  auto a_at = [&](int mm, int k) {
    return AMN ? As[k * FA + mm] : As[mm * FK + k];
  };
  auto b_off = [&](int k, int n) { return BMN ? k * FB + n : n * FK + k; };
#pragma unroll 1
  for (int k8 = 0; k8 < KSF; k8 += 8) {
    const tf32::FragA fa =
        tf32::frag_a(a_at(m, k8 + q), a_at(m + 8, k8 + q),
                     a_at(m, k8 + q + 4), a_at(m + 8, k8 + q + 4));
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int o0 = b_off(k8 + q, 8 * j + lr);
      const int o1 = b_off(k8 + q + 4, 8 * j + lr);
      tf32::FragB fb;
      fb.hi[0] = Bs[o0];
      fb.hi[1] = Bs[o1];
      fb.lo[0] = Bs[LO + o0];
      fb.lo[1] = Bs[LO + o1];
      tf32::mma3(&acc[4 * j], fa, fb);
    }
  }
}

// The row kernel's products: acc = A B for one chunk of NC output columns
// n0 .. of N. A: rows row0 .. row0 + 63 (< nrows) of a row-major source of
// a_cols columns (stride lda), depth Kd. B from a float32 weight w of row
// stride ldw: K-major (B[k][n] = w[(n0 + n) ldw + k], a weight whose rows
// are the outputs) or MN-major if BMN (B[k][n] = w[k ldw + n0 + n]). VEC
// (f32): the slices loaded and stored 16 bytes at a time (TileF32V).
//
// Each slice: its tiles stored, a barrier, the next slice's loads issued,
// the products, a barrier.
template <bool BF, int NC, bool BMN, class SrcA, bool VEC = false>
__device__ void chunk_product(float (&acc)[NC / 2], uint8_t* tiles,
                              const SrcA* a, long lda, long row0, long nrows,
                              long a_cols, const float* w, long ldw, int n0,
                              int N, int Kd) {
  if constexpr (BF) {
    TileBf16<BR, KSB, SrcA> ta;
    TileBf16<BMN ? KSB : NC, BMN ? NC : KSB, float> tb;
    auto fetch = [&](int k0) {
      ta.fetch(a, lda, row0, nrows, k0, a_cols);
      if constexpr (BMN)
        tb.fetch(w, ldw, k0, Kd, n0, N);
      else
        tb.fetch(w, ldw, n0, N, k0, Kd);
    };
    fetch(0);
    for (int k0 = 0; k0 < Kd; k0 += KSB) {
      ta.put(tiles);
      tb.put(tiles + Mode<true>::A_BYTES);
      wg::fence_async_smem();
      __syncthreads();
      if (k0 + KSB < Kd) fetch(k0 + KSB);
      slice_bf16<NC, false, BMN>(acc, wg::smem_addr(tiles),
                                 wg::smem_addr(tiles + Mode<true>::A_BYTES),
                                 k0 == 0);
      __syncthreads();
    }
  } else {
    constexpr int LO = Mode<false>::B_HALF;
    float* As = reinterpret_cast<float*>(tiles);
    float* Bs = reinterpret_cast<float*>(tiles + Mode<false>::A_BYTES);
    using TA = std::conditional_t<VEC, TileF32V<BR, KSF, FK>,
                                  TileF32<BR, KSF, FK>>;
    using TB = std::conditional_t<
        VEC,
        TileF32V<BMN ? KSF : NC, BMN ? NC : KSF, BMN ? FB : FK, true, LO>,
        TileF32<BMN ? KSF : NC, BMN ? NC : KSF, BMN ? FB : FK, true, LO>>;
    TA ta;
    TB tb;
    auto fetch = [&](int k0) {
      ta.fetch(a, lda, row0, nrows, k0, a_cols);
      if constexpr (BMN)
        tb.fetch(w, ldw, k0, Kd, n0, N);
      else
        tb.fetch(w, ldw, n0, N, k0, Kd);
    };
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    fetch(0);
    for (int k0 = 0; k0 < Kd; k0 += KSF) {
      ta.put(As);
      tb.put(Bs);
      __syncthreads();
      if (k0 + KSF < Kd) fetch(k0 + KSF);
      slice_f32<NC, false, BMN>(acc, As,
                                reinterpret_cast<const uint32_t*>(Bs));
      __syncthreads();
    }
  }
}

// The product kernel's products: acc[m][n] = sum over rows r in [r_lo,
// r_hi) of a[r lda + m0 + m] b[r ldb + n0 + n] (columns below a_cols and
// b_cols), both operands MN-major as the rows lie in memory; pipelined as
// chunk_product.
template <bool BF, int NC, class SrcA, class SrcB>
__device__ void rows_product(float (&acc)[NC / 2], uint8_t* tiles,
                             const SrcA* a, long lda, long a_cols, int m0,
                             const SrcB* b, long ldb, long b_cols, int n0,
                             long r_lo, long r_hi) {
  if constexpr (BF) {
    TileBf16<KSB, BR, SrcA> ta;
    TileBf16<KSB, NC, SrcB> tb;
    auto fetch = [&](long k0) {
      ta.fetch(a, lda, k0, r_hi, m0, a_cols);
      tb.fetch(b, ldb, k0, r_hi, n0, b_cols);
    };
    fetch(r_lo);
    for (long k0 = r_lo; k0 < r_hi; k0 += KSB) {
      ta.put(tiles);
      tb.put(tiles + Mode<true>::A_BYTES);
      wg::fence_async_smem();
      __syncthreads();
      if (k0 + KSB < r_hi) fetch(k0 + KSB);
      slice_bf16<NC, true, true>(acc, wg::smem_addr(tiles),
                                 wg::smem_addr(tiles + Mode<true>::A_BYTES),
                                 k0 == r_lo);
      __syncthreads();
    }
  } else {
    constexpr int LO = Mode<false>::B_HALF;
    float* As = reinterpret_cast<float*>(tiles);
    float* Bs = reinterpret_cast<float*>(tiles + Mode<false>::A_BYTES);
    TileF32<KSF, BR, FA> ta;
    TileF32<KSF, NC, FB, true, LO> tb;
    auto fetch = [&](long k0) {
      ta.fetch(a, lda, k0, r_hi, m0, a_cols);
      tb.fetch(b, ldb, k0, r_hi, n0, b_cols);
    };
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    fetch(r_lo);
    for (long k0 = r_lo; k0 < r_hi; k0 += KSF) {
      ta.put(As);
      tb.put(Bs);
      __syncthreads();
      if (k0 + KSF < r_hi) fetch(k0 + KSF);
      slice_f32<NC, true, true>(acc, As,
                                reinterpret_cast<const uint32_t*>(Bs));
      __syncthreads();
    }
  }
}

// ------------------------------------------------------- float64 retakes

// The warp's float64 sum of its lanes' terms, by a fixed shuffle tree.
__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// The first layer's pre-activation of a row x (D floats) and a row w of W1,
// in float64 from the float32 operands: by one thread, or (lane, step 32)
// by the warp, each lane a part of the sum.
__device__ __forceinline__ double z1_part(const float* x, const float* w,
                                          int D, int d0, int step) {
  double s = 0.0;
  for (int d = d0; d < D; d += step) s = fma((double)x[d], (double)w[d], s);
  return s;
}

// f32: a warp's pre-activations within a kink's reach, taken again in
// float64 (`exact(row, col)`, by the whole warp). Each lane marks its own
// entries near a kink (`near(row, col, z)`) in a mask. Only a warp that
// holds one goes on: its lanes write their entries to the scratch rows `z`
// (row stride ld), so that no accumulator is live across the float64 work;
// the warp takes the marked entries one at a time, the owner writing the
// value over its entry, and the lanes read their entries back.
template <int NC, class Near, class Exact>
__device__ __forceinline__ void retake(float (&acc)[NC / 2], float* z,
                                       long ld, int n0, int nr, int N,
                                       Near near, Exact exact,
                                       unsigned long long* count) {
  static_assert(NC / 2 <= 32, "a lane's entries in one mask");
  unsigned mine = 0u;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int row = frag_row(i), col = n0 + frag_col(i);
    if (row < nr && col < N && near(row, col, acc[i])) mine |= 1u << i;
  }
  if (!__any_sync(FULL, mine != 0u)) return;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int row = frag_row(i), col = n0 + frag_col(i);
    if (row < nr && col < N) z[(long)row * ld + col] = acc[i];
  }
  unsigned left = mine;
  int n = 0;
  for (unsigned lanes = __ballot_sync(FULL, left != 0u); lanes;
       lanes = __ballot_sync(FULL, left != 0u)) {
    while (lanes) {
      const int src = __ffs(lanes) - 1;
      lanes &= lanes - 1;
      const int i = __shfl_sync(FULL, __ffs(left) - 1, src);
      const int rr = __shfl_sync(FULL, frag_row(i), src);
      const int cc = n0 + __shfl_sync(FULL, frag_col(i), src);
      const float v = exact(rr, cc);
      if (lane == src) {
        z[(long)rr * ld + cc] = v;
        left &= left - 1;
      }
      ++n;
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int row = frag_row(i), col = n0 + frag_col(i);
    acc[i] = row < nr && col < N ? z[(long)row * ld + col] : 0.f;
  }
  if (lane == 0) atomicAdd(count, (unsigned long long)n);
}

// ---------------------------------------------------------------- row loss

struct RowArgs {
  const float *params, *obs, *act, *logp_old, *adv, *ret, *lam, *resc;
  void *h1, *g2, *g1;   // T x B x ld1, ld2, ld1 of the form's type
  float *h2, *rv;       // T x B x ld2, T x B x rv_width
  double* pd;           // [G][T][pd_width]
  Layout L;
  int B;
  float clip_lo, clip_hi, gv_scale, a_log_sqrt_2pi;
  int h2_smem;   // the row block's h2 in dynamic shared memory
};

__device__ __forceinline__ float r_exp(float x) { return expf(x); }
__device__ __forceinline__ double r_exp(double x) { return exp(x); }
__device__ __forceinline__ float r_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double r_tanh(double x) { return tanh(x); }

// The loss of row r of tower t from its heads `head` into its row values
// `row`. The actor's arithmetic in Real: float (the bf16 form) or double
// (the f32 form).
template <class Real>
__device__ void row_loss(const RowArgs& a, int t, long r, const float* head,
                         float* row) {
  const int A = a.L.A, K = a.L.K;
  if (t > 0) {
    const float diff = head[0] - a.ret[r * K + (t - 1)];
    row[0] = a.gv_scale * diff;
    row[1] = 0.f;
    row[2] = 0.f;
    row[3] = diff * diff;
    return;
  }
  const float* lsig = a.params + a.L.global_off(0, 6);
  const float* act = a.act + r * A;
  const float* adv = a.adv + r * K;
  Real lsig_sum = 0, sq = 0;
  for (int i = 0; i < A; ++i) {
    lsig_sum += (Real)lsig[i];
    const Real mu = r_tanh((Real)head[i]);
    const Real z = ((Real)act[i] - mu) / r_exp((Real)lsig[i]);
    sq += (Real)-0.5 * z * z;
  }
  const Real c = sizeof(Real) == sizeof(float)
                     ? (Real)a.a_log_sqrt_2pi
                     : (Real)A * (Real)0.91893853320467274178;
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
  for (int m = 0; m < K - 1; ++m) lsum += (Real)adv[1 + m] * (Real)a.lam[m];
  const Real g_ratio = (Real)a.resc[0] * (-dmin + lsum) / (Real)a.B;
  const Real g_logp = g_ratio * ratio;
  for (int i = 0; i < A; ++i) {
    const Real sig = r_exp((Real)lsig[i]);
    const Real mu = r_tanh((Real)head[i]);
    const Real z = ((Real)act[i] - mu) / sig;
    row[i] = (float)(g_logp * (z / sig) * ((Real)1 - mu * mu));
    row[A + i] = (float)(g_logp * (z * z - (Real)1));
  }
  float* aux = row + 2 * A;
  aux[0] = (float)(logp_old - logp);
  aux[1] = (float)(s1 < s2 ? s1 : s2);
  aux[2] = 0.f;
  for (int m = 0; m < K - 1; ++m)
    aux[3 + m] = (float)(ratio * (Real)adv[1 + m]);
}

// ------------------------------------------------------------- row kernel

// What a row kernel block works on: its tower, its row block, its
// partial.
template <bool BF>
struct Ctx {
  using T = typename Mode<BF>::T;
  const RowArgs* p;
  uint8_t* tiles;
  float (*red)[NCMAX];   // [NW][NCMAX] column sums of the warps
  float *xn, *hn;        // the rows' norm of x, sum of h1^2 (f32)
  float* gs;             // [BR][OSMALL] the rows' head gradients (C)
  float* hs;             // [BR][OSMALL] the rows' heads (B, up to OSMALL)
  const float* wmax;     // the largest row norm of W1, of W2 (f32)
  const float *W1, *b1, *W2, *b2, *Wh, *bh;
  T *h1, *g2, *g1;
  float *h2, *rv;
  float* h2b;            // the row block's h2, row 0 (shared or device memory)
  double* pd;
  int t, O, D, H1, H2, ld1, ld2, W, B, nr;
  long r0;
};

// A: h1 = relu(x W1^T + b1) for columns n0 .. n0 + NC - 1 (zero from H1 to
// ld1), stored for stages B and D and the product kernel. f32: a
// pre-activation near a kink taken again in float64, the rows' sums of h1^2
// for stage B's test.
template <bool BF, int NC>
__device__ void stage_a(const Ctx<BF>& c, int n0) {
  float acc[NC / 2];
  chunk_product<BF, NC, false>(acc, c.tiles, c.p->obs, c.D, c.r0, c.B, c.D,
                               c.W1, c.D, n0, c.H1, c.D);
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int col = n0 + frag_col(i);
    acc[i] += col < c.H1 ? c.b1[col] : 0.f;
  }
  if constexpr (!BF) {
    const float* x = c.p->obs + c.r0 * c.D;
    retake<NC>(
        acc, reinterpret_cast<float*>(c.h1) + c.r0 * c.ld1, c.ld1, n0, c.nr,
        c.H1,
        [&](int row, int, float z) {
          return fabsf(z) < KINK * c.xn[row] * c.wmax[0];
        },
        [&](int row, int col) {
          const int lane = threadIdx.x & 31;
          return (float)(warp_sum(z1_part(x + (long)row * c.D,
                                          c.W1 + (long)col * c.D, c.D, lane,
                                          32)) +
                         (double)c.b1[col]);
        },
        &any_retakes[0]);
  }
  float hsq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h, row = frag_row(i), col = n0 + frag_col(i);
      const float v0 = col < c.H1 ? fmaxf(acc[i], 0.f) : 0.f;
      const float v1 = col + 1 < c.H1 ? fmaxf(acc[i + 1], 0.f) : 0.f;
      if (row < c.nr && col < c.ld1)
        st2(c.h1 + (c.r0 + row) * c.ld1 + col, v0, v1);
      hsq[h] += v0 * v0 + v1 * v1;
    }
  }
  if constexpr (!BF) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hsq[h] += __shfl_xor_sync(FULL, hsq[h], 1);
      hsq[h] += __shfl_xor_sync(FULL, hsq[h], 2);
      if ((threadIdx.x & 3) == 0) c.hn[frag_row(2 * h)] += hsq[h];
    }
  }
}

// B: h2 = relu(h1 W2^T + b2) for columns n0 .., stored in float32 for stage
// C; the chunk's terms of the heads added to the rows' head values (the
// head bias with the first chunk), by lane 0 of the quad that holds the row.
// VEC: chunk_product's.
template <bool BF, int NC, bool HEADS, bool VEC = false>
__device__ void stage_b(const Ctx<BF>& c, int n0) {
  float acc[NC / 2];
  chunk_product<BF, NC, false, typename Ctx<BF>::T, VEC>(
      acc, c.tiles, c.h1, c.ld1, c.r0, c.B, c.ld1, c.W2, c.H1, n0, c.H2,
      c.H1);
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int col = n0 + frag_col(i);
    acc[i] += col < c.H2 ? c.b2[col] : 0.f;
  }
  if constexpr (!BF) {
    // the row's h1 taken again in float64 too: lane l takes inputs l,
    // l + 32, ...
    const float* x = c.p->obs + c.r0 * c.D;
    retake<NC>(
        acc, c.h2b, c.ld2, n0, c.nr, c.H2,
        [&](int row, int, float z) {
          return fabsf(z) < KINK * sqrtf(c.hn[row]) * c.wmax[1];
        },
        [&](int row, int col) {
          const int lane = threadIdx.x & 31;
          const float* xr = x + (long)row * c.D;
          const float* w2 = c.W2 + (long)col * c.H1;
          double s = 0.0;
          for (int k = lane; k < c.H1; k += 32) {
            const double h = z1_part(xr, c.W1 + (long)k * c.D, c.D, 0, 1) +
                             (double)c.b1[k];
            s = fma(fmax(h, 0.0), (double)w2[k], s);
          }
          return (float)(warp_sum(s) + (double)c.b2[col]);
        },
        &any_retakes[1]);
  }
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int col = n0 + frag_col(i);
    acc[i] = col < c.H2 ? fmaxf(acc[i], 0.f) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h, row = frag_row(i), col = n0 + frag_col(i);
      if (row < c.nr && col < c.ld2)
        st2(c.h2b + row * c.ld2 + col, acc[i], acc[i + 1]);
    }
  }
  // the heads at up to OSMALL actions: the actor's mean in float32, a
  // critic's value on rounded operands in the bf16 form (more actions:
  // heads_mma)
  if (!HEADS) return;   // heads_mma
  const bool round = BF && c.t > 0;
  for (int a = 0; a < c.O; ++a) {
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + frag_col(4 * j + e);
        if (col < c.H2) {
          float w = c.Wh[(long)a * c.H2 + col];
          if (round) w = rbf(w);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[4 * j + 2 * h + e];
            s[h] = fmaf(round ? rbf(v) : v, w, s[h]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(FULL, s[h], 1);
      s[h] += __shfl_xor_sync(FULL, s[h], 2);
      const int row = frag_row(2 * h);
      if ((threadIdx.x & 3) == 0) {
        float* dst = c.hs + row * OSMALL + a;
        *dst = (n0 == 0 ? c.bh[a] : *dst) + s[h];
      }
    }
  }
}

// The heads at more than OSMALL actions (the actor): s = h2 Wmu^T + bmu for
// actions a0 .., three TF32 products on the block's h2 rows (float32).
template <bool BF, int NC>
__device__ void heads_mma(const Ctx<BF>& c, int a0) {
  float acc[NC / 2];
  chunk_product<false, NC, false>(acc, c.tiles, c.h2b, c.ld2, 0, c.nr,
                                  c.ld2, c.Wh, c.H2, a0, c.O, c.H2);
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int row = frag_row(i), a = a0 + frag_col(i);
    if (row < c.nr && a < c.O) c.rv[(c.r0 + row) * c.W + a] = acc[i] + c.bh[a];
  }
}

// A product's masked columns: out = acc where mask > 0 (0 from N to ld),
// on the block's rows, and the sums over the rows of each column n0 + k < N
// into sums[n0 + k] (the warps' sums in shared memory, added in warp order).
template <int NC, class MT, class OT>
__device__ void store_masked(const float (&acc)[NC / 2], const MT* mask,
                             OT* out, long ld, int n0, int nr, int N,
                             float (*red)[NCMAX], double* sums) {
  float cs[NC / 4];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    cs[2 * j] = 0.f;
    cs[2 * j + 1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h, row = frag_row(i), col = n0 + frag_col(i);
      if (row < nr && col < ld) {
        const float2 m = ld2(mask + row * ld + col);
        const float g0 = col < N && m.x > 0.f ? acc[i] : 0.f;
        const float g1 = col + 1 < N && m.y > 0.f ? acc[i + 1] : 0.f;
        st2(out + row * ld + col, g0, g1);
        cs[2 * j] += g0;
        cs[2 * j + 1] += g1;
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NC / 4; ++k) {
    cs[k] += __shfl_xor_sync(FULL, cs[k], 4);
    cs[k] += __shfl_xor_sync(FULL, cs[k], 8);
    cs[k] += __shfl_xor_sync(FULL, cs[k], 16);
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      red[warp][8 * j + 2 * lane] = cs[2 * j];
      red[warp][8 * j + 2 * lane + 1] = cs[2 * j + 1];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NC; k += NT) {
    if (n0 + k < N) {
      float v = red[0][k];
#pragma unroll
      for (int w = 1; w < NW; ++w) v += red[w][k];
      sums[n0 + k] += (double)v;
    }
  }
  __syncthreads();
}

// C at more than OSMALL actions (the actor), on the tensor cores as three
// TF32 products: g_h2 = (g_out Wmu) * (h2 > 0) for columns n0 .., stored
// with its sums over the rows. The product goes through a staging tile in
// shared memory; thread (col, part) then masks and stores column n0 + col
// over one of NT / NC parts of the rows, and the parts' sums are added in
// order.
template <bool BF, int NC>
__device__ void g2_mma(const Ctx<BF>& c, int n0) {
  float acc[NC / 2];
  chunk_product<false, NC, true>(acc, c.tiles, c.rv, c.W, c.r0, c.B, c.O,
                                 c.Wh, c.H2, n0, c.H2, c.O);
  constexpr int SS = NC + 1, P = NT / NC, PR = BR / P;
  static_assert(NT % NC == 0 && 4 * (BR * SS + NT) <= ROW_TILE_BYTES,
                "parts of the rows, the staging tile");
  float* st = reinterpret_cast<float*>(c.tiles);
  float* part_sums = st + BR * SS;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) st[frag_row(i) * SS + frag_col(i)] = acc[i];
  __syncthreads();
  const int k = threadIdx.x % NC, part = threadIdx.x / NC, col = n0 + k;
  const int rhi = (part + 1) * PR < c.nr ? (part + 1) * PR : c.nr;
  float sum = 0.f;
  if (col < c.ld2) {
    for (int r = part * PR; r < rhi; ++r) {
      const float g =
          col < c.H2 && c.h2b[r * c.ld2 + col] > 0.f ? st[r * SS + k] : 0.f;
      st1(c.g2 + (c.r0 + r) * c.ld2 + col, g);
      sum += g;
    }
  }
  part_sums[part * NC + k] = sum;
  __syncthreads();
  if (threadIdx.x < NC && col < c.H2) {
    float v = part_sums[k];
#pragma unroll
    for (int q = 1; q < P; ++q) v += part_sums[q * NC + k];
    c.pd[c.H1 + col] += (double)v;
  }
  __syncthreads();
}

// The head weight gradient at more than OSMALL actions: g_out^T h2 over the
// block's rows for actions m0 .. and columns n0 .., added to the partial
// through a staging tile in shared memory (a rolled, coalesced loop of
// float64 read-modify-writes, each entry by one thread).
template <bool BF, int NC>
__device__ void head_grad_mma(const Ctx<BF>& c, int m0, int n0) {
  float acc[NC / 2];
  rows_product<false, NC>(acc, c.tiles, c.rv + c.r0 * c.W, (long)c.W,
                          (long)c.O, m0, c.h2b, (long)c.ld2, (long)c.ld2, n0,
                          0, c.nr);
  constexpr int SS = NC + 1;
  float* st = reinterpret_cast<float*>(c.tiles);
  static_assert(4 * BR * SS <= ROW_TILE_BYTES, "the staging tile");
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) st[frag_row(i) * SS + frag_col(i)] = acc[i];
  __syncthreads();
  double* hw = c.pd + c.p->L.pd_hw();
  for (int e = threadIdx.x; e < BR * NC; e += NT) {
    const int a = m0 + e / NC, col = n0 + e % NC;
    if (a < c.O && col < c.H2)
      hw[(long)a * c.H2 + col] += (double)st[(e / NC) * SS + e % NC];
  }
  __syncthreads();
}

// C at up to OSMALL actions, for the 64 columns n0 ..: g_h2 = (g_out
// W_head) * (h2 > 0) over the block's rows (0 from H2 to ld2), its sums
// (float64) and the head weight gradient's columns, sums over the rows of
// g_out h2, into the partial. Thread (col, half) takes column n0 + col over
// half of the rows, the rows' g_out from gs and OS (>= the tower's O) head
// weights in registers; the halves' sums are added in order.
template <bool BF, int OS>
__device__ void stage_c_cols(const Ctx<BF>& c, int n0, double* pc,
                             float* pw) {
  const int k = threadIdx.x & 63, half = threadIdx.x >> 6;
  const int col = n0 + k, rlo = half * (BR / 2);
  const int H2 = c.H2, ld2 = c.ld2, O = c.O;
  const int rhi = rlo + BR / 2 < c.nr ? rlo + BR / 2 : c.nr;
  const bool round = BF && c.t > 0;
  const float* h2 = c.h2b + col;
  const float* gs = c.gs;
  typename Mode<BF>::T* g2 = c.g2 + c.r0 * ld2 + col;
  float w[OS], dw[OS];
#pragma unroll
  for (int a = 0; a < OS; ++a) {
    const float v = a < O && col < H2 ? c.Wh[(long)a * H2 + col] : 0.f;
    w[a] = round ? rbf(v) : v;
    dw[a] = 0.f;
  }
  double colsum = 0.0;
  if (col < ld2) {
    for (int r = rlo; r < rhi; ++r) {
      const float h = h2[r * ld2];
      const float hh = round ? rbf(h) : h;
      const float* go = gs + r * OSMALL;
      float g = 0.f;
#pragma unroll
      for (int a = 0; a < OS; ++a) {
        const float ga = round ? rbf(go[a]) : go[a];
        g = fmaf(ga, w[a], g);
        dw[a] = fmaf(ga, hh, dw[a]);
      }
      g = h > 0.f ? g : 0.f;
      st1(g2 + (long)r * ld2, g);
      colsum += (double)g;
    }
  }
  pc[half * 64 + k] = colsum;
#pragma unroll
  for (int a = 0; a < OS; ++a) pw[(half * OSMALL + a) * 64 + k] = dw[a];
  __syncthreads();
  if (threadIdx.x < 64 && col < H2) {
    double* pd = c.pd;
    pd[c.H1 + col] += pc[k] + pc[64 + k];
    double* hw = pd + c.p->L.pd_hw();
    for (int a = 0; a < O; ++a)
      hw[(long)a * H2 + col] +=
          (double)pw[a * 64 + k] + (double)pw[(OSMALL + a) * 64 + k];
  }
  __syncthreads();
}

// D: g_h1 = (g_h2 W2) * (h1 > 0) for columns n0 .. (0 from H1 to ld1),
// stored for the product kernel; its sums over the block's rows into the
// partial (the warps' sums in shared memory, added in warp order).
template <bool BF, int NC, bool VEC = false>
__device__ void stage_d(const Ctx<BF>& c, int n0) {
  float acc[NC / 2];
  chunk_product<BF, NC, true, typename Ctx<BF>::T, VEC>(
      acc, c.tiles, c.g2, c.ld2, c.r0, c.B, c.ld2, c.W2, c.H1, n0, c.H1,
      c.H2);
  store_masked<NC>(acc, c.h1 + c.r0 * c.ld1, c.g1 + c.r0 * c.ld1, c.ld1, n0,
                   c.nr, c.H1, c.red, c.pd);
}

// The sums of squares of the rows r + u NW (u < RN, those below n) of a
// row-major source of rows of len floats, in every lane of the warp: its
// lanes along the rows, RN x KB loads of a lane issued before their sums,
// so that a row's length takes len / (32 KB) trips to L2, not len / 32.
template <int RN>
__device__ __forceinline__ void rows_sumsq(const float* src, int r, int n,
                                           int len, float (&s)[RN]) {
  constexpr int KB = 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < RN; ++u) s[u] = 0.f;
  for (int k0 = lane; k0 < len; k0 += 32 * KB) {
    float v[RN][KB];
#pragma unroll
    for (int u = 0; u < RN; ++u) {
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int k = k0 + 32 * j;
        v[u][j] = r + u * NW < n && k < len
                      ? src[(long)(r + u * NW) * len + k]
                      : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < RN; ++u) {
#pragma unroll
      for (int j = 0; j < KB; ++j) s[u] = fmaf(v[u][j], v[u][j], s[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < RN; ++u) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[u] += __shfl_xor_sync(FULL, s[u], o);
  }
}

// Rows a warp takes at once in rows_sumsq: the weights' rows at the start of
// the kernel, x's rows in each row block (where more of them spill).
constexpr int WRN = 16, XRN = 4;

// The largest row norm of a row-major (n x len) weight, over the block.
__device__ float max_row_norm(const float* w, int n, int len, float* stage) {
  constexpr int RN = WRN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float most = 0.f;
  for (int r = warp; r < n; r += RN * NW) {
    float s[RN];
    rows_sumsq<RN>(w, r, n, len, s);
#pragma unroll
    for (int u = 0; u < RN; ++u) most = fmaxf(most, s[u]);
  }
  if (lane == 0) stage[warp] = most;
  __syncthreads();
  float m = stage[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) m = fmaxf(m, stage[i]);
  __syncthreads();
  return sqrtf(m);
}

// MANY: the actor has more than OSMALL actions, and its heads, g_h2 and head
// weight gradient run as TF32 products (heads_mma, g2_mma, head_grad_mma);
// an instance of its own, so that the main paths' instance carries none
// of their registers.
template <bool BF, bool MANY>
__global__ void __launch_bounds__(NT)
    row_kernel(const __grid_constant__ RowArgs p) {
  using T = typename Mode<BF>::T;
  // f32 at up to OSMALL actions: the slices of stages B and D loaded and
  // stored 16 bytes at a time (TileF32V)
  constexpr bool VEC = !BF && !MANY;
  // the column sums' staging (red) and stage C's (gs, pc, pw) lie in
  // the tiles: each is used only where no product's tiles are live
  __shared__ __align__(128) uint8_t tiles[ROW_TILE_BYTES];
  float* const tf = reinterpret_cast<float*>(tiles);
  float* const gs = tf;                        // [BR][OSMALL]
  double* const pc = reinterpret_cast<double*>(gs + BR * OSMALL);  // [2][64]
  float* const pw = reinterpret_cast<float*>(pc + 2 * 64);  // [2][OSMALL][64]
  static_assert((4 * BR * OSMALL) % 8 == 0 &&
                    4 * BR * OSMALL + 8 * 128 + 4 * 2 * OSMALL * 64 <=
                        ROW_TILE_BYTES,
                "stage C's staging in the tiles");
  // the row block's h2 where it fits (h2_smem), [BR][ld2] float32
  extern __shared__ __align__(16) float h2s[];
  __shared__ float xn[BR], hn[BR], hs[BR * OSMALL], wmax[2];
  // the block's context, read from shared memory where it is used, so that
  // it takes no registers across the products
  __shared__ Ctx<BF> c;
  const Layout& L = p.L;
  const int t = blockIdx.y, NTW = L.K + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    c.p = &p;
    c.tiles = tiles;
    c.red = reinterpret_cast<float(*)[NCMAX]>(tiles);
    c.xn = xn;
    c.hn = hn;
    c.gs = gs;
    c.hs = hs;
    c.wmax = wmax;
    const float* prm = p.params;
    c.W1 = prm + L.global_off(t, 0);
    c.b1 = prm + L.global_off(t, 1);
    c.W2 = prm + L.global_off(t, 2);
    c.b2 = prm + L.global_off(t, 3);
    c.Wh = prm + L.global_off(t, 4);
    c.bh = prm + L.global_off(t, 5);
    c.t = t;
    c.O = t == 0 ? L.A : 1;
    c.D = L.D;
    c.H1 = L.H1;
    c.H2 = L.H2;
    c.ld1 = L.ld1();
    c.ld2 = L.ld2();
    c.W = L.rv_width();
    c.B = p.B;
    c.h1 = static_cast<T*>(p.h1) + (long)t * p.B * c.ld1;
    c.g2 = static_cast<T*>(p.g2) + (long)t * p.B * c.ld2;
    c.g1 = static_cast<T*>(p.g1) + (long)t * p.B * c.ld1;
    c.h2 = p.h2 + (long)t * p.B * c.ld2;
    c.rv = p.rv + (long)t * p.B * c.W;
    c.pd = p.pd + ((long)blockIdx.x * NTW + t) * L.pd_width();
  }
  __syncthreads();
  for (long i = threadIdx.x; i < L.pd_width(); i += NT) c.pd[i] = 0.0;
  if constexpr (!BF) {
    const float m1 = max_row_norm(c.W1, c.H1, c.D, tf);
    const float m2 = max_row_norm(c.W2, c.H2, c.H1, tf);
    if (threadIdx.x == 0) {
      wmax[0] = m1;
      wmax[1] = m2;
    }
  }
  // the tower's heads, g_h2 and head weight gradient as TF32 products: the
  // actor at many actions, in chunks of NCM (g_h2) and NCH columns (the
  // widths at which no instance spills)
  const bool many = MANY && c.O > OSMALL;
  constexpr int NCH = BF ? NCM : NCF;
  for (long rb = blockIdx.x; rb * BR < p.B; rb += gridDim.x) {
    __syncthreads();
    if (threadIdx.x == 0) {
      c.r0 = rb * BR;
      c.nr = (int)(p.B - rb * BR < BR ? p.B - rb * BR : BR);
      c.h2b = p.h2_smem ? h2s : c.h2 + rb * BR * c.ld2;
    }
    __syncthreads();
    if constexpr (!BF) {
      // the rows' norms of x
      for (int r = warp; r < BR; r += XRN * NW) {
        float s[XRN];
        rows_sumsq<XRN>(p.obs + c.r0 * c.D, r, c.nr, c.D, s);
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < XRN; ++u) {
            if (r + u * NW < BR) {
              xn[r + u * NW] = sqrtf(s[u]);
              hn[r + u * NW] = 0.f;
            }
          }
        }
      }
      __syncthreads();
    }
    for (int n0 = 0; n0 < c.H1; n0 += NCR) stage_a<BF, NCR>(c, n0);
    __syncthreads();
    for (int n0 = 0; n0 < c.H2; n0 += NCR) {
      if (many)
        stage_b<BF, NCR, false>(c, n0);
      else
        stage_b<BF, NCR, true, VEC>(c, n0);
    }
    __syncthreads();
    if (many) {
      for (int a0 = 0; a0 < c.O; a0 += NCH) heads_mma<BF, NCH>(c, a0);
      __syncthreads();
    }
    // C: the row loss (heads from hs, or from rv at many actions), the row
    // values' sums (a warp a column, its lanes along the rows), g_h2
    if ((int)threadIdx.x < c.nr) {
      const long r = c.r0 + threadIdx.x;
      float* row = c.rv + r * c.W;
      const float* head = many ? row : hs + threadIdx.x * OSMALL;
      if constexpr (BF)
        row_loss<float>(p, t, r, head, row);
      else
        row_loss<double>(p, t, r, head, row);
    }
    __syncthreads();
    const int heads = L.rv_heads(t);
    for (int k0 = warp; k0 < L.rv_cols(t); k0 += 4 * NW) {
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      for (int r = lane; r < c.nr; r += 32) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k0 + u * NW < L.rv_cols(t))
            s[u] += (double)c.rv[(c.r0 + r) * c.W + k0 + u * NW];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u * NW;
        s[u] = warp_sum(s[u]);
        if (lane == 0 && k < L.rv_cols(t))
          c.pd[k < heads ? L.pd_hb() + k : L.pd_aux() + (k - heads)] += s[u];
      }
    }
    if (!many) {
      for (int e = threadIdx.x; e < BR * OSMALL; e += NT) {
        const int r = e / OSMALL, a = e % OSMALL;
        gs[e] = r < c.nr && a < c.O ? c.rv[(c.r0 + r) * c.W + a] : 0.f;
      }
      __syncthreads();
      for (int n0 = 0; n0 < c.ld2; n0 += 64)
        stage_c_cols<BF, MANY ? 1 : OSMALL>(c, n0, pc, pw);
    } else {
      for (int n0 = 0; n0 < c.H2; n0 += NCM) g2_mma<BF, NCM>(c, n0);
      for (int m0 = 0; m0 < c.O; m0 += BR)
        for (int n0 = 0; n0 < c.H2; n0 += NCH)
          head_grad_mma<BF, NCH>(c, m0, n0);
    }
    __syncthreads();
    for (int n0 = 0; n0 < c.H1; n0 += NCR) stage_d<BF, NCR, VEC>(c, n0);
  }
}

// ---------------------------------------------------------- product kernel

// The product kernel's tiles: bf16 at 128 columns, f32 at 64.
template <bool BF>
constexpr int WGRAD_TILE_BYTES = Mode<BF>::A_BYTES + Mode<BF>::B_BYTES;

struct WArgs {
  const void *h1, *g2, *g1;   // T x B x ld1, ld2, ld1 of the form's type
  const float* obs;
  float* pw;                  // [S][T][pw_width]
  Layout L;
  int B, rps;
};

// One tile of dW2 = g_h2^T h1 or dW1 = g_h1^T x over one slice of rows.
template <bool BF, int NC, class SrcB>
__device__ void wgrad_tile(uint8_t* tiles, const typename Mode<BF>::T* a,
                           long lda, int m0, int M, const SrcB* b, long ldb,
                           long b_cols, int n0, int N, long r_lo, long r_hi,
                           float* out) {
  float acc[NC / 2];
  rows_product<BF, NC>(acc, tiles, a, lda, lda, m0, b, ldb, b_cols, n0, r_lo,
                       r_hi);
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) {
    const int m = m0 + frag_row(i), n = n0 + frag_col(i);
    if (m < M && n < N) out[(long)m * N + n] = acc[i];
  }
}

template <bool BF>
__global__ void __launch_bounds__(NT)
    wgrad_kernel(const __grid_constant__ WArgs p) {
  using T = typename Mode<BF>::T;
  constexpr int NC = BF ? NCMAX : NCF;
  __shared__ __align__(128) uint8_t tiles[WGRAD_TILE_BYTES<BF>];
  const Layout& L = p.L;
  const int NTW = L.K + 1, per = L.tiles(NC);
  const int t = blockIdx.x / per, j = blockIdx.x % per;
  const long r_lo = (long)blockIdx.y * p.rps;
  const long r_hi = r_lo + p.rps < p.B ? r_lo + p.rps : p.B;
  float* out = p.pw + ((long)blockIdx.y * NTW + t) * L.pw_width();
  const int ld1 = L.ld1(), ld2 = L.ld2();
  const T* h1 = static_cast<const T*>(p.h1) + (long)t * p.B * ld1;
  if (j < L.tiles_w2(NC)) {
    const int nt = (int)cdiv(L.H1, NC);
    const int m0 = (j / nt) * BR, n0 = (j % nt) * NC;
    const T* g2 = static_cast<const T*>(p.g2) + (long)t * p.B * ld2;
    if (BF && L.H1 - n0 > 64)
      wgrad_tile<BF, NC>(tiles, g2, ld2, m0, L.H2, h1, ld1, ld1, n0, L.H1,
                         r_lo, r_hi, out + L.pw_w2());
    else
      wgrad_tile<BF, 64>(tiles, g2, ld2, m0, L.H2, h1, ld1, ld1, n0, L.H1,
                         r_lo, r_hi, out + L.pw_w2());
  } else {
    const int k = j - L.tiles_w2(NC), nt = (int)cdiv(L.D, NC);
    const int m0 = (k / nt) * BR, n0 = (k % nt) * NC;
    const T* g1 = static_cast<const T*>(p.g1) + (long)t * p.B * ld1;
    if (BF && L.D - n0 > 64)
      wgrad_tile<BF, NC>(tiles, g1, ld1, m0, L.H1, p.obs, L.D, L.D, n0, L.D,
                         r_lo, r_hi, out);
    else
      wgrad_tile<BF, 64>(tiles, g1, ld1, m0, L.H1, p.obs, L.D, L.D, n0, L.D,
                         r_lo, r_hi, out);
  }
}

// ------------------------------------------------------------------ reduce

struct RedArgs {
  const double* pd;   // [G][T][pd_width]
  const float* pw;    // [S][T][pw_width]
  float *grad, *aux;
  Layout L;
  int G, S;
};

// grad[global] = the sum of its partials in index order, in float64; the
// last block: aux[q] by thread q.
__global__ void __launch_bounds__(NT_RED)
    reduce_kernel(const __grid_constant__ RedArgs a) {
  const Layout& L = a.L;
  const int T = L.K + 1;
  const long PD = L.pd_width(), PW = L.pw_width();
  if (blockIdx.x == gridDim.x - 1) {
    // aux[q] by warp q: lane l sums the partials l, l + 32, ... in order,
    // a fixed shuffle tree the lanes
    const int q = threadIdx.x >> 5, lane = threadIdx.x & 31;
    double s = 0.0;
    if (q == 2) {
      for (int g = lane; g < a.G; g += 32)
        for (int t = 1; t < T; ++t)
          s += a.pd[((long)g * T + t) * PD + L.pd_aux() + q];
    } else if (q < 3 + L.K - 1) {
      for (int g = lane; g < a.G; g += 32)
        s += a.pd[(long)g * T * PD + L.pd_aux() + q];
    }
    s = warp_sum(s);
    if (lane == 0) a.aux[q] = (float)s;
    return;
  }
  const long P = L.tower_size(0);
  const long id = (long)blockIdx.x * NT_RED + threadIdx.x;
  if (id >= T * P) return;
  const int t = (int)(id / P);
  const long l = id % P;
  if (l >= L.tower_size(t)) return;
  int seg = 0;
  while (l >= L.local_off(t, seg + 1)) ++seg;
  const long idx = l - L.local_off(t, seg);
  double s = 0.0;
  if (seg == 0 || seg == 2) {
    const long off = (seg == 0 ? 0 : L.pw_w2()) + idx;
    const float* src = a.pw + (long)t * PW + off;
    const long step = (long)T * PW;
#pragma unroll 8
    for (int z = 0; z < a.S; ++z) s += (double)src[z * step];
  } else {
    const long off = seg == 1   ? idx
                     : seg == 3 ? L.pd_b2() + idx
                     : seg == 4 ? L.pd_hw() + idx
                     : seg == 5 ? L.pd_hb() + idx
                                : L.pd_hb() + L.A + idx;
    const double* src = a.pd + (long)t * PD + off;
    const long step = (long)T * PD;
#pragma unroll 8
    for (int g = 0; g < a.G; ++g) s += src[g * step];
  }
  a.grad[L.global_off(t, seg) + idx] = (float)s;
}

// ------------------------------------------------------------------- host

bool valid(int B, int D, int H1, int H2, int A, int K) {
  return B >= 1 && D >= 1 && H1 >= 1 && H2 >= 1 && A >= 1 && K >= 1 &&
         K - 1 <= MMAX;
}

// The card's SMs, and how many blocks of each kernel an SM holds at once
// (at least 1), asked once in the process.
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    n = n > 0 ? n : 1;
  }
  return n;
}

template <class Kernel>
int per_sm(Kernel kernel, int* cache) {
  if (*cache == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(cache, kernel, NT, 0);
    *cache = *cache > 0 ? *cache : 1;
  }
  return *cache;
}
// The row kernel's dynamic shared memory at most: what the card lets a
// block opt into, less the kernel's static shared memory (set once).
template <bool BF, bool MANY>
long row_dyn_max() {
  static long most = -1;
  if (most < 0) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncAttributes at;
    cudaFuncGetAttributes(&at, row_kernel<BF, MANY>);
    most = (long)optin - (long)at.sharedSizeBytes;
    most = most > 0 ? most : 0;
    cudaFuncSetAttribute(row_kernel<BF, MANY>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)most);
  }
  return most;
}

// The dynamic shared memory of the row kernel at L: the row block's h2
// (64 x H2 float32) where it fits, else none (h2 in device memory).
long h2_smem_bytes(const Layout& L, bool bf16) {
  const long b = 4L * BR * L.ld2();
  const bool many = L.A > OSMALL;
  const long most = bf16 ? (many ? row_dyn_max<true, true>()
                                 : row_dyn_max<true, false>())
                         : (many ? row_dyn_max<false, true>()
                                 : row_dyn_max<false, false>());
  return b <= most ? b : 0;
}

// Asked once for each dynamic size (a few in a process), so that a launch
// costs the host no query.
template <bool BF, bool MANY>
int row_per_sm_of(long dyn) {
  constexpr int SLOTS = 16;
  static long seen[SLOTS];
  static int blocks[SLOTS], used = 0;
  for (int i = 0; i < used; ++i)
    if (seen[i] == dyn) return blocks[i];
  row_dyn_max<BF, MANY>();
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, row_kernel<BF, MANY>,
                                                NT, (size_t)dyn);
  n = n > 0 ? n : 1;
  if (used < SLOTS) {
    seen[used] = dyn;
    blocks[used++] = n;
  }
  return n;
}
int row_per_sm(bool bf16, bool many, long dyn) {
  if (bf16)
    return many ? row_per_sm_of<true, true>(dyn)
                : row_per_sm_of<true, false>(dyn);
  return many ? row_per_sm_of<false, true>(dyn)
              : row_per_sm_of<false, false>(dyn);
}
int wgrad_per_sm(bool bf16) {
  static int n[2] = {0, 0};
  return bf16 ? per_sm(wgrad_kernel<true>, &n[1])
              : per_sm(wgrad_kernel<false>, &n[0]);
}

// The row kernel's blocks a tower: as many as fill the card once, at most
// one a row block.
int row_grid(int B, const Layout& L, bool bf16) {
  const long fill = cdiv((long)sm_count() * row_per_sm(bf16, L.A > OSMALL,
                                                       h2_smem_bytes(L, bf16)),
                         L.K + 1);
  const long rb = cdiv(B, BR);
  return (int)(rb < fill ? rb : fill);
}
int row_grid_most(int B, const Layout& L) {
  const int a = row_grid(B, L, true), b = row_grid(B, L, false);
  return a > b ? a : b;
}

// The product kernel's rows a slice, a multiple of RPS: enough slices that
// the tiles of every tower, times the slices, fill the card once (at most
// SMAX, at least RPS rows a slice).
int slice_rows(int B, const Layout& L, bool bf16) {
  const long tiles = (long)L.tiles(bf16 ? NCMAX : NCF) * (L.K + 1);
  const long fill = (long)sm_count() * wgrad_per_sm(bf16);
  long s = cdiv(fill, tiles);
  const long most = cdiv(B, RPS);
  s = s < 1 ? 1 : (s > SMAX ? SMAX : s);
  s = s > most ? most : s;
  return (int)(cdiv(cdiv(B, s), RPS) * RPS);
}
int splits(int B, const Layout& L, bool bf16) {
  return (int)cdiv(B, slice_rows(B, L, bf16));
}
int splits_most(int B, const Layout& L) {
  const int a = splits(B, L, true), b = splits(B, L, false);
  return a > b ? a : b;
}

// Scratch, each part on 256 bytes: the row blocks' float64 partials, the
// slices' partials, the row values, h2 (float32), h1, g_h2, g_h1 (the
// form's type; sized for float32).
struct Scratch {
  double* pd;
  float *pw, *rv, *h2;
  void *h1, *g2, *g1;
};

long align256(long bytes) { return (bytes + 255) & ~255L; }

long carve(char* base, int B, const Layout& L, Scratch* s) {
  const long T = L.K + 1;
  const long sizes[7] = {
      8L * row_grid_most(B, L) * T * L.pd_width(),
      4L * splits_most(B, L) * T * L.pw_width(),
      4L * T * B * L.rv_width(),
      4L * T * B * L.ld2(),
      4L * T * B * L.ld1(),
      4L * T * B * L.ld2(),
      4L * T * B * L.ld1()};
  long off = 0;
  void* at[7];
  for (int i = 0; i < 7; ++i) {
    at[i] = base ? base + off : nullptr;
    off += align256(sizes[i]);
  }
  if (s) {
    s->pd = static_cast<double*>(at[0]);
    s->pw = static_cast<float*>(at[1]);
    s->rv = static_cast<float*>(at[2]);
    s->h2 = static_cast<float*>(at[3]);
    s->h1 = at[4];
    s->g2 = at[5];
    s->g1 = at[6];
  }
  return off;
}

long scratch_floats(int B, const Layout& L) {
  return carve(nullptr, B, L, nullptr) / 4;
}

#define FSRL_TRY(x)                          \
  do {                                       \
    const cudaError_t err_ = (x);            \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

// which: -1 every launch; 0, 1, 2 only the row kernel, the product kernel
// or the reduce, on scratch that an earlier launch filled (for timing them
// apart).
cudaError_t run(const float* params, const float* obs, const float* act,
                const float* logp_old, const float* adv, const float* ret,
                const float* lam, const float* resc, float* grad, float* aux,
                float* scratch, int B, const Layout& L, bool bf16,
                float clip_lo, float clip_hi, float vf_coef, cudaStream_t s,
                int which) {
  const int T = L.K + 1;
  Scratch sc;
  carve(reinterpret_cast<char*>(scratch), B, L, &sc);
  const int G = row_grid(B, L, bf16);
  const int rps = slice_rows(B, L, bf16), S = (int)cdiv(B, rps);
  if (which < 0 || which == 0) {
    const RowArgs ra{params, obs, act, logp_old, adv, ret, lam, resc,
                     sc.h1, sc.g2, sc.g1, sc.h2, sc.rv, sc.pd, L, B,
                     clip_lo, clip_hi,
                     (float)(2.0 * (double)vf_coef / (double)B),
                     (float)(L.A * 0.91893853320467274178),
                     (int)(h2_smem_bytes(L, bf16) > 0)};
    const dim3 grid(G, T);
    const size_t dyn = (size_t)h2_smem_bytes(L, bf16);
    if (L.A > OSMALL) {
      if (bf16)
        row_kernel<true, true><<<grid, NT, dyn, s>>>(ra);
      else
        row_kernel<false, true><<<grid, NT, dyn, s>>>(ra);
    } else {
      if (bf16)
        row_kernel<true, false><<<grid, NT, dyn, s>>>(ra);
      else
        row_kernel<false, false><<<grid, NT, dyn, s>>>(ra);
    }
    FSRL_TRY(cudaGetLastError());
  }
  if (which < 0 || which == 1) {
    const WArgs wa{sc.h1, sc.g2, sc.g1, obs, sc.pw, L, B, rps};
    const dim3 grid(L.tiles(bf16 ? NCMAX : NCF) * T, S);
    if (bf16)
      wgrad_kernel<true><<<grid, NT, 0, s>>>(wa);
    else
      wgrad_kernel<false><<<grid, NT, 0, s>>>(wa);
    FSRL_TRY(cudaGetLastError());
  }
  if (which < 0 || which == 2) {
    const RedArgs rd{sc.pd, sc.pw, grad, aux, L, G, S};
    const long n = (long)T * L.tower_size(0);
    reduce_kernel<<<(unsigned)(cdiv(n, NT_RED) + 1), NT_RED, 0, s>>>(rd);
    FSRL_TRY(cudaGetLastError());
  }
  return cudaSuccess;
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

// Row slices of the product kernel at (B, D, H1, H2, A, K) in either
// dtype.
extern "C" int fsrl_ppo_grad_any_splits(int B, int D, int H1, int H2, int A,
                                        int K, int bf16) {
  if (!valid(B, D, H1, H2, A, K)) return -1;
  return splits(B, Layout{D, H1, H2, A, K}, bf16 != 0);
}

// The row kernel's blocks a tower at (B, D, H1, H2, A, K) in either dtype.
extern "C" int fsrl_ppo_grad_any_row_blocks(int B, int D, int H1, int H2,
                                            int A, int K, int bf16) {
  if (!valid(B, D, H1, H2, A, K)) return -1;
  return row_grid(B, Layout{D, H1, H2, A, K}, bf16 != 0);
}

// The largest shared memory of the form's kernels at hidden width H2: their
// static shared memory and the row kernel's dynamic (the row block's h2
// where it fits), in bytes.
extern "C" long fsrl_ppo_grad_any_smem_bytes(int H2) {
  cudaFuncAttributes at[7];
  cudaFuncGetAttributes(&at[0], row_kernel<true, false>);
  cudaFuncGetAttributes(&at[1], row_kernel<false, false>);
  cudaFuncGetAttributes(&at[2], row_kernel<true, true>);
  cudaFuncGetAttributes(&at[3], row_kernel<false, true>);
  cudaFuncGetAttributes(&at[4], wgrad_kernel<true>);
  cudaFuncGetAttributes(&at[5], wgrad_kernel<false>);
  cudaFuncGetAttributes(&at[6], reduce_kernel);
  long most = 0;
  for (int i = 0; i < 7; ++i) {
    const long b =
        (long)at[i].sharedSizeBytes +
        (i < 4 ? h2_smem_bytes(Layout{1, 1, H2, i < 2 ? 1 : OSMALL + 1, 1},
                               i % 2 == 0)
               : 0);
    most = b > most ? b : most;
  }
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
                  (cudaStream_t)stream, -1);
}

// One launch of the form alone (which: 0 the row kernel, 1 the product
// kernel, 2 the reduce) with the arguments of fsrl_ppo_grad_any, on scratch
// that a whole launch at the same shape filled: for timing the launches
// apart.
extern "C" int fsrl_ppo_grad_any_one(const float* params, const float* obs,
                                     const float* act, const float* logp_old,
                                     const float* adv, const float* ret,
                                     const float* lam, const float* resc,
                                     float* grad, float* aux, float* scratch,
                                     int B, int D, int H1, int H2, int A,
                                     int K, int bf16, long scratch_n,
                                     float clip_lo, float clip_hi,
                                     float vf_coef, void* stream,
                                     int which) {
  if (!valid(B, D, H1, H2, A, K) || which < 0 || which > 2)
    return (int)cudaErrorInvalidValue;
  const Layout L{D, H1, H2, A, K};
  if (scratch_n < scratch_floats(B, L)) return (int)cudaErrorInvalidValue;
  return (int)run(params, obs, act, logp_old, adv, ret, lam, resc, grad, aux,
                  scratch, B, L, bf16 != 0, clip_lo, clip_hi, vf_coef,
                  (cudaStream_t)stream, which);
}

// The f32 form's float64 retakes since the last call ([0] first layer,
// [1] second), which clears them.
extern "C" int fsrl_ppo_grad_any_retakes(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, any_retakes, sizeof(any_retakes));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[2] = {0ull, 0ull};
  return (int)cudaMemcpyToSymbol(any_retakes, zero, sizeof(zero));
}
