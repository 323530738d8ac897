// Warpgroup matrix multiply (wgmma) building blocks for Hopper (sm_90a):
// the shared-memory tile layout the kernels write by hand, the matrix
// descriptors that read it, and the instruction wrappers.
//
// Tile layout. A bf16 tile X[r][c] is stored as 8x8 "core matrices" of 128
// contiguous bytes: eight 16-byte units, unit i holding X[8R + i][8C .. 8C+7].
// Core matrix (R, C) lies at byte ((R * ncg) + C) * 128, ncg = columns / 8.
// This is wgmma's canonical layout without swizzle, and one stored copy
// serves as either operand major:
//   * depth (K) along the tile's columns ("K-major", transpose bit 0):
//     the unit is 8 K-values of one M/N row;
//   * depth (K) along the tile's rows ("MN-major", transpose bit 1): the same
//     unit is 8 M/N-values of one K row.
// In both cases the descriptor's stride byte offset is the distance between
// core matrices along M/N and its leading byte offset the distance between
// core matrices along K. A warp that writes accumulator fragments (lane l:
// row l/4, columns 2(l%4), 2(l%4)+1 of a core matrix) fills one core matrix
// with 32 four-byte stores to 128 contiguous bytes: no bank conflicts.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace wg {

// Byte offset of element (r, c) in a tile of ncg column groups.
__host__ __device__ constexpr uint32_t tile_off(int r, int c, int ncg) {
  return (uint32_t)(((((r >> 3) * ncg) + (c >> 3)) << 7) + ((r & 7) << 4) +
                    ((c & 7) << 1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 64-bit matrix descriptor, no swizzle: start address, leading and stride
// byte offsets, each in units of 16 bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Operand whose depth runs along the tile's columns: M/N rows from r0,
// one k16 step from column k0.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int ncg, int r0,
                                                int k0) {
  return desc(tile + tile_off(r0, k0, ncg), 128u, 128u * ncg);
}

// Operand whose depth runs along the tile's rows: one k16 step from row k0,
// M/N columns from c0.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int ncg,
                                                 int k0, int c0) {
  return desc(tile + tile_off(k0, c0, ncg), 128u * ncg, 128u);
}

// Generic-proxy stores to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses to accumulator registers across
// the point where the asynchronous products were waited for.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Barrier among the 128 threads of one warpgroup (id 1 + warpgroup).
__device__ __forceinline__ void warpgroup_sync(int wgid) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgid) : "memory");
}

// D (+)= A * B on one 64-row slab per warpgroup; A and B from shared memory.
// TA / TB: 0 = K-major, 1 = MN-major. scale_d = 0 overwrites D.
// Accumulator fragment of thread t (warp w = t / 32 % 4, lane l): d[4j + 2h + e]
// is row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n16k16(float (&d)[8], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

}  // namespace wg
