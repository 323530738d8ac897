// Float32 products on Hopper's TF32 tensor cores at float32-class accuracy
// (mma.sync), for the float32 PPO-Lagrangian gradient kernel
// (fused_ppo_grad_f32.cu).
//
// The split ("3xTF32"). Each operand x becomes hi = rna_tf32(x) and
// lo = rna_tf32(x - hi): x - hi is exact in f32 and |x - hi| <= 2^-11 |x|,
// so x = hi + lo + e with |e| <= 2^-22 |x|. A product a b is taken as
// hi_a hi_b + hi_a lo_b + lo_a hi_b, each exact in the tensor core and
// summed in f32. What is dropped (lo_a lo_b and the e terms) is at most
// about 3 * 2^-22 |a b|; one TF32 product alone is off by up to 2^-10 |a b|.
//
// The sum. The tensor core adds into its accumulator with truncation (round
// toward zero, after aligning to the largest addend), so a chain of
// mma.sync into one running sum loses up to an ulp of the sum at every
// step, all the same way: 48 steps of a depth-128 product drift by ~1e-6 of
// a pre-activation of size ~0.5, and a ReLU then takes the other side on
// far more rows than in a float32 computation. mma3 therefore takes each
// depth step's three products into a fresh accumulator, where the loss is
// an ulp of that step's partial sum, and adds it to the running sum with a
// round-to-nearest f32 add, as a float32 loop would.
//
// mma.sync.m16n8k8 fragments, lane l, r = l / 4, c = l % 4:
//   A (16 x 8): a[0] = (r, k0), a[1] = (r + 8, k0), a[2] = (r, k1),
//               a[3] = (r + 8, k1)
//   B (8 x 8):  b[0] = (k0, r), b[1] = (k1, r)
//   C (16 x 8): c[0..3] = (r, 2c), (r, 2c + 1), (r + 8, 2c), (r + 8, 2c + 1)
// PTX numbers the depth slots k0 = c, k1 = c + 4. A product sums over the
// depth, so any assignment of the eight depth indices to the slots that A
// and B share gives the same sum: a kernel may take k0 = 2c, k1 = 2c + 1 to
// load two neighbouring floats at once.

#pragma once

#include <cstdint>

namespace tf32 {

// The split with integer operations (cvt.rna.tf32.f32 runs on the
// conversion unit, a quarter of their rate): adding half a TF32 ulp to the
// bits and clearing the low 13 rounds to nearest, ties away from zero, as
// cvt.rna does. The tensor core reads only a .tf32 operand's top 19 bits, so
// lo is handed over with its half ulp added and the low bits left.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// An A fragment, split once and used for a row of n tiles.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// A B fragment's two values, split.
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// d (4 floats of a C fragment) += a b, one TF32 product.
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b, one TF32 product into a fresh accumulator.
__device__ __forceinline__ void mma0(float* d, const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += t with round-to-nearest adds.
__device__ __forceinline__ void add4(float* d, const float (&t)[4]) {
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

// d += a b at float32-class accuracy: the small terms first, all three in a
// fresh accumulator, which is added to d with round-to-nearest adds.
__device__ __forceinline__ void mma3(float* d, const FragA& a,
                                     const FragB& b) {
  float t[4];
  mma0(t, a.hi, b.lo[0], b.lo[1]);
  mma(t, a.lo, b.hi[0], b.hi[1]);
  mma(t, a.hi, b.hi[0], b.hi[1]);
  add4(d, t);
}

}  // namespace tf32
