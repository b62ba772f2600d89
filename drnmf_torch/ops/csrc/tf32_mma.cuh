// PTX primitives of the error-compensated TF32 tensor-core mainloop shared
// by kernels B2 (drnmf_scan_factored_interleaved.cu), B3
// (drnmf_scan_dense.cu) and B4/B5 (snmf_mu.cu): asynchronous
// copies, the TF32 head of a float, the wgmma fences, the m64nNk8 .tf32
// instructions with A from registers at the widths the kernels use, and the
// shared-memory layout and descriptor of a K-major B operand in the 64-byte
// swizzle.  sm_90a only (wgmma).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies; an invalid one fills with zeros.
// The 4-byte copy goes through L1 (.ca): only for data no kernel writes
// while it runs.  The 16-byte copy bypasses L1 (.cg), so it reads what
// another block wrote before a grid synchronisation.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits, to nearest), as f32 bits.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed wgmma groups are
// still running (N = 0 is wgmma_wait).
template <int N>
__device__ __forceinline__ void wgmma_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps a register operand of an asynchronous wgmma alive and unmoved up
// to this point (after the wait).
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64 x N, f32) += a (64 x 8, TF32, registers) b (8 x N, TF32, shared
// memory through its descriptor), asynchronously; N = 2 x the length of d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[44], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43}, "
      "{%44, %45, %46, %47}, %48, p, 1, 1;\n"
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
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(1));
}

// A K-major B operand in the 64-byte swizzle layout: a row of 16 floats
// (64 bytes) a column, 512 bytes from one group of 8 columns to the next,
// and the four 16-byte groups of a row exchanged by bits 1-2 of the column
// (the hardware applies the same exchange to the address, so tiles start
// on 512 bytes).  The byte offset of B(col, k) inside a tile:
__device__ __forceinline__ int swizzle64_offset(int col, int k) {
  return col * 64 + (((k / 4) ^ ((col >> 1) & 3)) * 16) + (k % 4) * 4;
}

// The tile's shared-memory descriptor.  The leading offset is not used by
// a swizzled K-major operand.
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

}  // namespace
