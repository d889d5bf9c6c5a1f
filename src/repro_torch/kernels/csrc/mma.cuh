// Inline-PTX building blocks shared by the kernels in this directory:
// cp.async copies into shared memory (with zero fill), the TF32 split,
// and the tensor-core products the kernels use (wgmma for the crossbar
// kernel, mma.sync for the int8 one).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k*"), with
// g = lane / 4 and t = lane % 4:
//   m16n8k8  tf32: a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
//                  b = B[t][g], B[t+4][g]
//   m16n8k16 bf16: a = A[g][2t..], A[g+8][2t..], A[g][2t+8..],
//                  A[g+8][2t+8..]; b = B[2t..][g], B[2t+8..][g]
//                  (each register two k-neighbours, the lower k low)
//   m16n8k32 8-bit: a = A[g][4t..], A[g+8][4t..], A[g][4t+16..],
//                  A[g+8][4t+16..]; b = B[4t..][g], B[4t+16..][g]
//                  (each register four k-neighbours)
//   every shape:   c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]
#pragma once

#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy kBytes (4, 8 or 16) from global to shared memory asynchronously;
// only the first src_bytes are read, the rest of the kBytes is zeroed
// (src_bytes = 0 reads nothing, src must still be a valid address).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16,
                "cp.async copies 4, 8 or 16 bytes");
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes),
                    "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Round to TF32 (10-bit mantissa), to nearest with ties away from zero:
// for finite v the result of cvt.rna.tf32.f32, in two integer ops on
// the bits, which issue faster than the conversion.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split of v: big = tf32(v), small = tf32(v - big), so that
// big + small keeps about 22 significant bits of v.
__device__ __forceinline__ void tf32_split(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(__fsub_rn(v, __uint_as_float(big)));
}

// ---- warpgroup products (wgmma): A from registers, B from shared ----
//
// B is K-major in shared memory without swizzle: "core matrices" of 8
// rows (n) × 16 bytes (k), 128 contiguous bytes each; the descriptor
// gives the byte stride between the core matrices next to each other
// along k (lbo) and along n (sbo). A's registers follow the mma.sync
// layouts above, one warp of the warpgroup for each 16 rows. The
// accumulator of m64n64 holds, for each n8 slice i of the warp's 16
// rows, d[4i..4i+3] = C[g][8i+2t], C[g][8i+2t+1], C[g+8][8i+2t],
// C[g+8][8i+2t+1].

__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, int lbo,
                                               int sbo) {
  return static_cast<uint64_t>((smem_addr(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Make this thread's shared-memory stores visible to wgmma (the async
// proxy); a block barrier must follow before wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Order register writes (A fragments, accumulators) before the wgmma
// that reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// d += a·b, m64n64k8, tf32, f32 accumulator.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// d += a·b, m64n64k16, bf16, f32 accumulator (B not transposed).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// d += a·b, m16n8k32, uint8 (kSigned false) or int8 a, int8 b, exact
// int32 accumulator.
template <bool kSigned>
__device__ __forceinline__ void mma_i8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  if constexpr (kSigned) {
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  } else {
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
}

}  // namespace repro_torch
