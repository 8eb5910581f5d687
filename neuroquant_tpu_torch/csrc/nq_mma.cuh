// Tensor-core products and asynchronous copies, shared by tail_conv_cf.cu
// and tail_conv_dw_cf.cu: the fp32 kernels' product at fp32 accuracy
// (3xTF32), and the bf16 kernels' product (bf16 operands, fp32 sums).
//
// A TF32 operand keeps 10 mantissa bits, so one TF32 product alone is ~1e-3
// accurate. Each fp32 operand v is split into big = v with its low 13
// mantissa bits cleared and small = v - big (exact in fp32; the tensor core
// reads its upper 19 bits); the product is a_small*b_big + a_big*b_small +
// a_big*b_big (the dropped a_small*b_small is ~2^-20 of the product), three
// mma.sync.m16n8k8 instructions with fp32 accumulation. The tensor core adds
// into its accumulator with truncation, which over the thousands of K steps
// of these convs drifts past the tests' tolerance (measured: PERF.md); so
// the three products of one K step are chained into a zeroed fragment (tiny
// values, tiny truncation) and that fragment is added to the running sum by
// the fp32 adders, round to nearest.
//
// The library is built with none of these defined. They select variants
// that scripts/torch_conv_variants.py builds and times beside it, to keep
// the reasons for the choices above measurable:
//   NQ_SPLIT_RNA  split by two cvt.rna.tf32.f32 (round to nearest) instead
//                 of the mask: the same error, slower
//   NQ_ACC_IN_TC  accumulate all three products in the tensor core's
//                 accumulator: faster, drifts
//   NQ_ONE_TF32   one TF32 product alone: the speed of the kernel's frame,
//                 not its accuracy
//
// Fragment layout of mma.m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16x8, row): a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8x8, col):  b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C (16x8):      c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//
// The bf16 kernels multiply with mma.m16n8k16.bf16 (fp32 accumulator): one
// product per product, bf16 operands rounded to nearest even by whoever
// made them (tensor.to(torch.bfloat16) or the kernels' own epilogues).
// The products of a stage are chained in the tensor core from a zeroed
// fragment and each stage's fragment is added to the running sum by the
// fp32 adders, as above. Fragments (registers of two bf16, the lower k in
// the low half):
//   A (16x16, row): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                   a3 (g+8, 2t+8..)
//   B (16x8, col):  b0 (k=2t..2t+1, n=g)  b1 (k=2t+8..2t+9, n=g)
//   C (16x8):       as m16n8k8's
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// v = big + small; big is exactly a TF32 value, small is read as one
__device__ __forceinline__ void nq_split_tf32(float v, uint32_t& big,
                                              uint32_t& small) {
#ifdef NQ_SPLIT_RNA
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(v));
  const float rest = v - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
#else
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
#endif
}

// d = a * b (the accumulator operand is zero)
__device__ __forceinline__ void nq_mma_tf32_zero(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += a * b
__device__ __forceinline__ void nq_mma_tf32(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A * B at fp32 accuracy, A and B given as their TF32 splits
__device__ __forceinline__ void nq_mma_3xtf32(float (&acc)[4],
                                              const uint32_t (&a_big)[4],
                                              const uint32_t (&a_small)[4],
                                              const uint32_t (&b_big)[2],
                                              const uint32_t (&b_small)[2]) {
#if defined(NQ_ONE_TF32)
  nq_mma_tf32(acc, a_big, b_big);
#elif defined(NQ_ACC_IN_TC)
  nq_mma_tf32(acc, a_small, b_big);
  nq_mma_tf32(acc, a_big, b_small);
  nq_mma_tf32(acc, a_big, b_big);
#else
  float step[4];
  nq_mma_tf32_zero(step, a_small, b_big);
  nq_mma_tf32(step, a_big, b_small);
  nq_mma_tf32(step, a_big, b_big);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += step[i];
#endif
}

// d = a * b, bf16 operands (the accumulator operand is zero)
__device__ __forceinline__ void nq_mma_bf16_zero(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d += a * b, bf16 operands
__device__ __forceinline__ void nq_mma_bf16(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[q]
// is matrix q's fragment, the thread holding (row 2t, col g) and (row
// 2t+1, col g) of it.
__device__ __forceinline__ void nq_ldmatrix_x4_trans(uint32_t (&r)[4],
                                                     uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t nq_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies of 4 and 16 bytes; an invalid source
// writes zeros (source size 0) and is not read.
__device__ __forceinline__ void nq_cp_async4(uint32_t dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void nq_cp_async16(uint32_t dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void nq_cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `kPending` of this thread's committed groups are open
template <int kPending>
__device__ __forceinline__ void nq_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}
