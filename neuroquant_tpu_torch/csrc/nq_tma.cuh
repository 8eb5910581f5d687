// Hopper building blocks of the conv kernels on TMA (tail_conv_cf.cu in
// bf16 and fp32, tail_conv_dw_cf.cu in bf16): TMA tensor copies into
// shared memory, mbarriers, warpgroup products (wgmma; bf16 from shared
// memory, TF32 with A from registers), and the host-side encoding of the
// tensor maps. sm_90a only.
//
// TF32 (the fp32 conv's 3xTF32): wgmma reads a TF32 operand from shared
// memory only K-major (no transpose flag): a 128-byte line holds 32 K
// values of one row, a k8 slice starts 32 bytes further along it, as a
// bf16 k16 slice does (the fp32 conv's weight rows, TMA-copied K-major).
// A from registers has mma.m16n8k8's A fragment in each warp of the
// warpgroup (rows 16 w..16 w + 15 for warp w; the fp32 conv's x).
//
// wgmma's shared-memory operands use the 128-byte swizzle: a line of 64
// bf16 (128 bytes) per row, 8 rows to a 1024-byte atom, the 16-byte chunk
// c of row r stored at chunk c ^ (r % 8), every atom on a 1024-byte
// boundary. TMA writes that pattern itself for the operands it can copy
// whole (the weight rows, dW's g rows: CU_TENSOR_MAP_SWIZZLE_128B); the
// shifted x rows are realigned and swizzled by the consumer threads.
// Measured on an NVIDIA H100 (700 W): a TMA tiled box needs its start
// along the innermost dimension on a 16-byte boundary and its shared
// destination on a 128-byte one; a swizzled box of 4 rows copied to row 4
// of an atom lands where a descriptor of the whole atom reads it.
//
// Descriptors (PTX "matrix descriptor"; CuTe's make_gmma_desc):
//   bits 0-13 start address >> 4, 16-29 leading byte offset >> 4, 32-45
//   stride byte offset >> 4, 62-63 layout (1 = 128-byte swizzle).
//   K-major (rows along M or N, 64 K values a row): the stride byte offset
//   steps 8 rows (1024 bytes); the leading one is unused. A k16 slice
//   starts 32 bytes further along the row.
//   M- or N-major (64 M or N values a row, one row per K): the stride byte
//   offset steps 8 K rows (1024 bytes), the leading byte offset the next
//   64 M or N values; a k16 slice is two atoms further down.
//
// wgmma.m64nNk16 with fp32 accumulators: thread t of the warpgroup holds,
// for each 8-column chunk j of the N columns, d[4j], d[4j+1] at row
// 16 (t / 32) + (t % 32) / 4 and columns 8j + 2 (t % 4), + 1, and d[4j+2],
// d[4j+3] 8 rows below.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "nq_common.cuh"

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void nq_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void nq_fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the calling thread's arrival, and `bytes` more for the phase to await
__device__ __forceinline__ void nq_mbar_expect_tx(uint32_t bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void nq_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed. A wait that
// polls 2^25 times (far beyond any copy's or product's latency) traps: a
// fault in the pipeline's bookkeeping ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void nq_mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 25)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// generic-proxy writes to shared memory made visible to TMA and wgmma
__device__ __forceinline__ void nq_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void nq_named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// a warpgroup's registers a thread, raised or lowered (all its threads)
template <int kRegs>
__device__ __forceinline__ void nq_setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void nq_setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void nq_tma_load_2d(uint32_t dst,
                                               const CUtensorMap* map,
                                               int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void nq_tma_load_3d(uint32_t dst,
                                               const CUtensorMap* map,
                                               int c0, int c1, int c2,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// TMA's 1-D bulk copy of `bytes` contiguous bytes from global `src` to
// shared `dst`, completing on `bar`: src, dst and bytes multiples of 16
// (the layout kernels' rings, pack_cf.cu and unpack_frames.cu)
__device__ __forceinline__ void nq_bulk_load(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// a 128-byte-swizzle descriptor at shared address `addr`
__device__ __forceinline__ uint64_t nq_desc_sw128(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void nq_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void nq_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void nq_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// d (+)= A * B over one k16 slice: A 64 x 16 and B 16 x N bf16 from
// shared memory, d fp32; scale_d 0 overwrites d. kTA / kTB: 0 K-major, 1
// M- / N-major.
template <int kTA, int kTB>
__device__ __forceinline__ void nq_wgmma_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void nq_wgmma_n96(float (&d)[48], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47 "
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTA, int kTB>
__device__ __forceinline__ void nq_wgmma_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// v = hi + lo + (~2^-22 v): hi and lo each a TF32 value rounded to nearest
// (cvt.rna), held as fp32 bits whose low 13 bits are zero
__device__ __forceinline__ void nq_split_rna(float v, uint32_t& hi,
                                             uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// d (+)= A * B over one k8 slice at TF32: A 64 x 8 from registers (the
// fragment of mma.m16n8k8's A in each warp: a[0] (g, t), a[1] (g + 8, t),
// a[2] (g, t + 4), a[3] (g + 8, t + 4)), B 8 x N (64, 96, 128) K-major
// from shared memory, d fp32; scale_d 0 overwrites d
__device__ __forceinline__ void nq_wgmma_tf32_n64(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void nq_wgmma_tf32_n96(float (&d)[48],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47 "
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void nq_wgmma_tf32_n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void nq_wgmma_tf32(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (N == 128)
    nq_wgmma_tf32_n128(d, a, db, scale_d);
  else if constexpr (N == 96)
    nq_wgmma_tf32_n96(d, a, db, scale_d);
  else
    nq_wgmma_tf32_n64(d, a, db, scale_d);
}

// ---- tensor maps (host) -------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no -lcuda
using NqEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline NqEncodeTiled nq_encode_tiled() {
  static NqEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<NqEncodeTiled>(p);
  }
  return fn;
}

// A tensor map of `type` (bf16 or fp32) and `rank` dimensions (innermost
// first; `strides` in bytes for dimensions 1..rank-1), boxes of `box`
// elements, the 128-byte swizzle or none, zeros outside the tensor. False
// when the CUDA driver refuses it.
inline bool nq_tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, int rank, const uint64_t* dims,
                          const uint64_t* strides, const uint32_t* box,
                          bool swizzle = true) {
  const NqEncodeTiled encode = nq_encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t d[3], s[2];
  cuuint32_t bx[3], es[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    if (i + 1 < rank) s[i] = strides[i];
  }
  return encode(map, type, (cuuint32_t)rank,
                const_cast<void*>(base), d, s, bx, es,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool nq_bf16_map(CUtensorMap* map, const void* base, int rank,
                        const uint64_t* dims, const uint64_t* strides,
                        const uint32_t* box, bool swizzle = true) {
  return nq_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank,
                       dims, strides, box, swizzle);
}

// x (B, C, Mp) as the 3-D map (Mp, C, B) the shifted boxes read, boxes
// of `width` positions x 4, 8, 16, 32 rows (one map per height: map i
// holds 4 << i rows), without swizzle: a box lands as rows of `width`
// values. TMA takes a box's start along the positions only on a 16-byte
// boundary (an H100 refuses any other with an illegal instruction), so a
// box starts at the shifted position rounded down to a multiple of 8 (4
// in fp32) and holds 8 to 16 (4 to 8) positions more than it serves; the
// consumers realign the rows (nq_realign16 in bf16). A start before 0 or
// a box past Mp reads zeros, and no box reads into the neighbouring frame
// or past C.
constexpr int NQ_BOX_HEIGHTS = 4;

inline bool nq_x_maps(CUtensorMap* maps, const void* x, int batch, int c,
                      int mp, int width,
                      CUtensorMapDataType type =
                          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const uint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const uint64_t dims[3] = {(uint64_t)mp, (uint64_t)c, (uint64_t)batch};
  const uint64_t strides[2] = {(uint64_t)mp * size,
                               (uint64_t)c * mp * size};
  for (int i = 0; i < NQ_BOX_HEIGHTS; ++i) {
    const uint32_t box[3] = {(uint32_t)width, 4u << i, 1};
    if (!nq_tensor_map(&maps[i], type, x, 3, dims, strides, box, false))
      return false;
  }
  return true;
}

// the map of a box height (4, 8, 16 or 32 rows)
__device__ __forceinline__ int nq_box_map(int rows) {
  return __ffs(rows) - 3;
}

// 16 bytes of a staged bf16 row starting r values (0..7) into the aligned
// chunk `lo`, `hi` the chunk after it: 8 values realigned to a chunk
__device__ __forceinline__ uint4 nq_realign16(const uint4& lo, const uint4& hi,
                                              int r) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int h = r >> 1;
  const uint32_t sh = (r & 1) * 16;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    v[i] = h == 0 ? w[i] : h == 1 ? w[i + 1] : h == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(v[0], v[1], sh),
                    __funnelshift_r(v[1], v[2], sh),
                    __funnelshift_r(v[2], v[3], sh),
                    __funnelshift_r(v[3], v[4], sh));
}

// the chunk's four words through GELU, each value rounded back to bf16
__device__ __forceinline__ void nq_gelu_chunk(uint4& q) {
  q.x = nq_gelu_bf16x2(q.x);
  q.y = nq_gelu_bf16x2(q.y);
  q.z = nq_gelu_bf16x2(q.z);
  q.w = nq_gelu_bf16x2(q.w);
}
