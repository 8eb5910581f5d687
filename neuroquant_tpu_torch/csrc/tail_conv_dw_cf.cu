// tail_conv_dw_cf: weight and bias gradient of one conv layer of the
// channels-first decoder tail.
//
// Replaces the TPU kernel neuroquant_tpu/ops/tail_fused.py:1172
// `_dw_kernel` (launched by `_conv_cf_dw_one`):
//
//   dW[k, co] = sum_{b, m} g[b, co, m] * a(x[b, chan(k), m + shift(k)])
//
// with a = GELU when act_in (GELU by the Abramowitz & Stegun erf of the JAX
// tail), over every position m of the (B, C, Mp) channels-first flat
// layout; positions outside [0, Mp) read zero. g is the cotangent of the
// layer's output and is already border-masked, so no mask is applied here.
// The K axis is the forward's host-built list of steps of 4 rows, (flat
// shift, first channel, valid rows): dW comes out in the forward's operand
// layout, the rows past a step's valid rows as zeros, and the wrapper
// scatters it back to the canonical kernel. A step whose first channel is
// -2 reads 1 everywhere in its first row: that dW row is db = sum g.
//
// Bound on the H100: operations. The reduction runs over B*Mp = 106,496
// positions of the tail at batch 2 (8,192 at the prefix), the output is
// small (K rows x cout), and the FLOPs equal the forward conv's:
// 2 x positions x K x cout.
//
// Design for that bound: a GEMM dW[K, cout] = X[K, P] * g[cout, P]^T whose
// X operand is gathered by shifts, reduced over positions on the tensor
// cores at fp32 accuracy (nq_mma.cuh: 3xTF32, mma.sync.m16n8k8). Both
// operands are contiguous along the reduction.
//  * A block of 8 warps (4 x 2) owns 128 K rows x 128, 96 or 64 output
//    channels; a warp 32 rows x 64, 48 or 32. An 8-channel fragment column
//    wholly past cout is skipped; the warp grid puts the two channel halves
//    on the same SM sub-partitions, so the skipped work is saved on each.
//  * The block's share of the positions is walked in stages of 32 through a
//    ring of 3 or 4 stages in dynamic shared memory (97-111 KB, two blocks
//    per SM), filled by cp.async: the X rows as 4-byte copies (m + shift
//    has no alignment; copying aligned 16-byte vectors and reading at an
//    offset, as the forward does, measured slower on an NVIDIA H100), each
//    warp one row of 32 consecutive positions, zero-filled outside [0, Mp)
//    and past a step's valid rows; g as 16-byte copies. The loads of stage
//    k+2 (k+3) are in flight while stage k is multiplied; one __syncthreads
//    per stage. A stage never crosses a batch boundary (Mp is a multiple of
//    32).
//  * A row stride of 36 floats (= 4 mod 32) makes every fragment load hit
//    32 distinct banks.
//  * act_in: each thread applies GELU to the values it copied itself, once,
//    after its copies land and before the stage's barrier.
//  * One block per output tile over all positions would leave most of the
//    132 SMs idle, so the positions are split across the grid's third axis;
//    each split writes its partial tile to a scratch buffer, and a second
//    pass adds the partials in a fixed order: the same bits every run (no
//    atomics).
//
// The bf16 instantiation (nq_tail_conv_dw_cf_bf16; the TPU kernel's
// operands): x and g bf16, the products on the tensor cores (exact in
// fp32), the sums and dW, db fp32; act_in rounds GELU(x) to bf16, as the
// JAX tail's `_gelu` does. The same position splits and reduction pass.
//
// Bound on the H100: operations at 989 TFLOP/s (bf16 dense), bytes at the
// head. Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 115-168
// TFLOP/s at HNeRV Bunny-3M's prefix, L0 and L1, moving x and g from L2
// being most of the time, as in the forward.
//
// Design (nq_tma.cuh; a wgmma GEMM dW[K, cout] = X[K, P] * g[cout, P]^T,
// X gathered by shifts, both operands K-major: 64 positions to a 128-byte
// row):
//  * A block is one producer warp and two consumer warpgroups, 128 K rows
//    (64 a warpgroup, wgmma M) x 64, 96 or 128 output channels (wgmma N,
//    the one that pads cout least); one block an SM.
//  * The block's share of the positions is walked in stages of 64 through
//    a ring of 5-6 stages filled by TMA under mbarriers: g's rows whole in
//    the 128-byte swizzle; x's as the forward's boxes (a run of steps,
//    from the shift rounded down to 8 positions, 80 positions per 64,
//    unswizzled), realigned and swizzled by each warpgroup into one of its
//    two operand buffers (GELU when act_in) while its previous stage's
//    products run. A stage never crosses a frame (Mp and the chunks are
//    multiples of 64).
//  * The db step (channel -2) has no copy: its operand rows, a row of ones
//    and three of zeros, are written once in both buffers, as are zero rows
//    for steps past the list; the rows past a step's valid ones read the
//    next channels and their dW rows go to the dropped weight row.
//  * Promotion: a stage's four k16 products chain from zero (scale-d 0)
//    and the stage's sum is added to the running fp32 sum by the fp32
//    adders: the tensor core truncates as it accumulates, and a dW sums
//    ~10^5 positions at a 1e-5 gate.
//  * The partial tile goes to the split's scratch with 8-byte stores that
//    fill 32-byte sectors; dw_reduce_kernel adds the splits in order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdint>

#include "nq_common.cuh"
#include "nq_mma.cuh"
#include "nq_tma.cuh"

namespace {

constexpr int BM = 128;      // K rows per block: 32 steps of 4
constexpr int BP = 32;       // positions per stage
constexpr int LDP = BP + 4;  // stage row stride, floats
constexpr int THREADS = 256;
constexpr int WM = 2;        // 16-row fragments per warp (warp: 32 rows)

template <int WN>            // 8-channel fragments per warp
struct Tile {
  static constexpr int BN = 16 * WN;        // output channels per block
  static constexpr int STAGE = (BM + BN) * LDP;       // floats per stage
  static constexpr int STAGES = WN == 4 ? 4 : 3;
  static constexpr int SMEM_BYTES = STAGES * STAGE * 4;
};

template <int WN>
__global__ void __launch_bounds__(THREADS, 2)
tail_conv_dw_cf_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const int4* __restrict__ ksteps,
                       float* __restrict__ part, int cin, int cout, int mp,
                       int nsteps, int positions, int chunk, int act_in) {
  using T = Tile<WN>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int4 steps[BM / 4];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int k0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * T::BN;
  const int nrows = nsteps * 4;
  const int p_begin = blockIdx.z * chunk;
  const int nst = (min(p_begin + chunk, positions) - p_begin) / BP;

  if (tid < BM / 4) {
    const int s = blockIdx.x * (BM / 4) + tid;
    steps[tid] = s < nsteps ? ksteps[s] : make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  // X staging: this warp copies row (warp & 3) of steps 2i + (warp >> 2),
  // its lane one position
  const int xrr = warp & 3, xs0 = warp >> 2;

  auto load_stage = [&](int stage, int st_i) {
    float* xs = smem + stage * T::STAGE;
    float* gs = xs + BM * LDP;
    const int p0 = p_begin + st_i * BP;
    const int b = p0 / mp;
    const int m = p0 - b * mp;
    const float* xb = x + (size_t)b * cin * mp;
    const float* gb = g + (size_t)b * cout * mp;
#pragma unroll 4
    for (int i = 0; i < BM / 8; ++i) {
      const int4 st = steps[2 * i + xs0];          // shift, chan, rows
      float* dst = xs + ((2 * i + xs0) * 4 + xrr) * LDP + lane;
      if (st.y == -2) {                            // the row of ones: db
        *dst = xrr == 0 ? 1.f : 0.f;
        continue;
      }
      const int pos = m + lane + st.x;
      const bool valid = xrr < st.z && pos >= 0 && pos < mp;
      const float* src = valid ? xb + (size_t)(st.y + xrr) * mp + pos : xb;
      nq_cp_async4(nq_smem_addr(dst), src, valid);
    }
#pragma unroll
    for (int i = 0; i < T::BN * (BP / 4) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx >> 3, v = idx & 7;
      const bool valid = c0 + row < cout;
      const float* src = valid ? gb + (size_t)(c0 + row) * mp + m + v * 4 : gb;
      nq_cp_async16(nq_smem_addr(gs + row * LDP + v * 4), src, valid);
    }
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  bool nt_ok[WN];   // fragment column has a channel below cout (uniform)
#pragma unroll
  for (int j = 0; j < WN; ++j)
    nt_ok[j] = c0 + (warp_n * WN + j) * 8 < cout;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nst) load_stage(s, s);
    nq_cp_async_commit();
  }

  for (int it = 0; it < nst; ++it) {
    const int stage = it % T::STAGES;
    nq_cp_async_wait<T::STAGES - 2>();
    float* xs = smem + stage * T::STAGE;
    const float* gs = xs + BM * LDP;
    if (act_in) {
      // this thread's own copies have landed: GELU them once, in place
      // (not the row of ones)
#pragma unroll 4
      for (int i = 0; i < BM / 8; ++i) {
        if (steps[2 * i + xs0].y == -2) continue;
        float* p = xs + ((2 * i + xs0) * 4 + xrr) * LDP + lane;
        *p = nq_gelu(*p);
      }
    }
    __syncthreads();
    // the stage multiplied in the previous turn is free: refill it
    if (it + T::STAGES - 1 < nst)
      load_stage((it + T::STAGES - 1) % T::STAGES, it + T::STAGES - 1);
    nq_cp_async_commit();

#pragma unroll
    for (int pk = 0; pk < BP; pk += 8) {
      uint32_t ab[WM][4], as[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const float* p = xs + ((warp_m * WM + i) * 16 + gq) * LDP + pk + t;
        nq_split_tf32(p[0], ab[i][0], as[i][0]);
        nq_split_tf32(p[8 * LDP], ab[i][1], as[i][1]);
        nq_split_tf32(p[4], ab[i][2], as[i][2]);
        nq_split_tf32(p[8 * LDP + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        if (!nt_ok[j]) continue;
        const float* p = gs + ((warp_n * WN + j) * 8 + gq) * LDP + pk + t;
        uint32_t bb[2], bs[2];
        nq_split_tf32(p[0], bb[0], bs[0]);
        nq_split_tf32(p[4], bb[1], bs[1]);
#pragma unroll
        for (int i = 0; i < WM; ++i)
          nq_mma_3xtf32(acc[i][j], ab[i], as[i], bb, bs);
      }
    }
  }

  // thread owns rows gq, gq + 8 of each fragment row and columns 2t, 2t + 1
  // of each fragment column
  float* pout = part + (size_t)blockIdx.z * nrows * cout;
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = k0 + (warp_m * WM + i) * 16 + gq + 8 * hh;
      if (k >= nrows) continue;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int c = c0 + (warp_n * WN + j) * 8 + 2 * t;
        if (c < cout)
          *reinterpret_cast<float2*>(pout + (size_t)k * cout + c) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
    }
}

// out[i] = sum over splits s, in order, of part[s, i]
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

template <int WN>
cudaError_t launch(const float* x, const float* g, const int4* ksteps,
                   float* part, int cin, int cout, int mp, int nsteps,
                   int positions, int splits, int chunk, int act_in,
                   cudaStream_t stream) {
  using T = Tile<WN>;
  auto kernel = tail_conv_dw_cf_kernel<WN>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((nsteps * 4 + BM - 1) / BM, (cout + T::BN - 1) / T::BN,
                  splits);
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      x, g, ksteps, part, cin, cout, mp, nsteps, positions, chunk, act_in);
  return cudaGetLastError();
}

// ---- bf16 instantiation: a TMA ring and wgmma ----------------------------

constexpr int DW16_K = 128;       // K rows per block: 32 steps, two
                                  // warpgroups of 64
constexpr int DW16_STEPS = DW16_K / 4;
constexpr int DW16_P = 64;        // positions per stage: one 128-byte row
constexpr int DW16_SEG = 80;      // staged positions per row (64 served)
constexpr int DW16_SROW = DW16_SEG * 2;
constexpr int DW16_XSTG = DW16_K * DW16_SROW;       // 20 KB
constexpr int DW16_OPBUF = 64 * 128;                // a warpgroup's rows
constexpr int DW16_OPS = 2 * 2 * DW16_OPBUF;        // two per warpgroup
constexpr int DW16_CONSUMERS = 256;
constexpr int DW16_THREADS = DW16_CONSUMERS + 32;   // and a producer warp
constexpr int DW16_RING = 184320;                   // bytes for the stages

template <int BN>                 // output channels per block: 64, 96, 128
struct DwTile16 {
  static constexpr int GBYTES = BN * 128;
  static constexpr int STAGE = DW16_XSTG + GBYTES;
  static constexpr int STAGES = DW16_RING / STAGE < 8 ? DW16_RING / STAGE : 8;
  static constexpr int SMEM_BYTES =
      1024 + STAGES * STAGE + DW16_OPS + 16 * STAGES;
};

struct alignas(64) DwMaps16 {
  CUtensorMap x[NQ_BOX_HEIGHTS];   // x (Mp, cin, B), boxes 80 x 4..32 rows
  CUtensorMap g;                   // g (Mp, cout, B), boxes 64 x BN
};

template <int BN>
__global__ void __launch_bounds__(DW16_THREADS, 1)
tail_conv_dw_cf_bf16_kernel(const __grid_constant__ DwMaps16 maps,
                            const int4* __restrict__ ksteps,
                            float* __restrict__ part, int cout, int mp,
                            int nsteps, int positions, int chunk,
                            int act_in) {
  using T = DwTile16<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int4 steps[DW16_STEPS];
  const uint32_t raw = nq_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t ops = base + T::STAGES * T::STAGE;
  const uint32_t full = ops + DW16_OPS;
  const uint32_t empty = full + 8 * T::STAGES;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * DW16_K;
  const int c0 = blockIdx.y * BN;
  const int nrows = nsteps * 4;
  const int p_begin = blockIdx.z * chunk;
  const int nst = max(0, (min(p_begin + chunk, positions) - p_begin) / DW16_P);

  // the block's 32 steps; -1 marks a step past the list
  if (tid < DW16_STEPS) {
    const int s = blockIdx.x * DW16_STEPS + tid;
    steps[tid] = s < nsteps ? ksteps[s] : make_int4(0, -1, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      nq_mbar_init(full + 8 * s, 1);
      nq_mbar_init(empty + 8 * s, DW16_CONSUMERS / 32);
    }
    nq_fence_mbar_init();
  }
  __syncthreads();
  // operand rows no copy fills, written once in both buffers: the db
  // step's (a row of ones, then zeros; the swizzle moves nothing in rows
  // of equal chunks) and those past the list (zeros)
  if (tid < DW16_CONSUMERS) {
    for (int i = tid; i < 2 * DW16_K * 8; i += DW16_CONSUMERS) {
      const int row = (i / 8) % DW16_K, buf = i / (DW16_K * 8);
      const int4 st = steps[row >> 2];
      if (st.y >= 0) continue;
      const uint32_t v = st.y == -2 && (row & 3) == 0 ? 0x3f803f80u : 0u;
      *reinterpret_cast<uint4*>(
          smem + T::STAGES * T::STAGE + (row >> 6) * 2 * DW16_OPBUF +
          buf * DW16_OPBUF + (row & 63) * 128 + (i % 8) * 16) =
          make_uint4(v, v, v, v);
    }
    nq_fence_proxy_async();
  }
  __syncthreads();

  if (warp == DW16_CONSUMERS / 32) {
    // producer: lane j copies the box the plan starts at step j (rows
    // 4j.., 80 positions from the stage's first + shift rounded down to
    // 8); lane 0 also the g rows
    const int4 st = steps[lane];
    const bool copy = st.y >= 0 && st.w > 0;
    const CUtensorMap* xm = &maps.x[copy ? nq_box_map(st.w) : 0];
    int bytes = copy ? st.w * DW16_SROW : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
    bytes += T::GBYTES;
    for (int it = 0; it < nst; ++it) {
      const int s = it % T::STAGES;
      const int p0 = p_begin + it * DW16_P;
      const int b = p0 / mp, m = p0 - b * mp;
      nq_mbar_wait(empty + 8 * s, ((it / T::STAGES) & 1) ^ 1);
      if (lane == 0) nq_mbar_expect_tx(full + 8 * s, bytes);
      __syncwarp();
      const uint32_t xs = base + s * T::STAGE;
      if (copy)
        nq_tma_load_3d(xs + lane * 4 * DW16_SROW, xm, (m + st.x) & ~7, st.y,
                       b, full + 8 * s);
      if (lane == 0)
        nq_tma_load_3d(xs + DW16_XSTG, &maps.g, m, c0, b, full + 8 * s);
    }
    return;
  }

  // consumers: warpgroup wg owns K rows 64 wg .. 64 wg + 63. Each stage's
  // four k16 products chain in the tensor core from zero (scale-d 0), and
  // the stage's sum is added to the running fp32 sum by the fp32 adders:
  // the tensor core truncates as it accumulates, and a dW sums ~10^5
  // positions
  const int wg = warp >> 2, wt = tid & 127;
  const uint32_t opw = ops + wg * 2 * DW16_OPBUF;
  unsigned char* opw_p = smem + T::STAGES * T::STAGE + wg * 2 * DW16_OPBUF;
  // the rows this thread realigns (4 chunks a stage) and their residues
  int rr[4];
  bool mine[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int4 st = steps[(64 * wg + (wt + 128 * j) / 8) >> 2];
    rr[j] = st.x & 7;
    mine[j] = st.y >= 0;
  }
  // frag is defined by wgmma alone (the first product of each stage
  // overwrites it, scale-d 0): ptxas serializes the products otherwise
  float acc[BN / 2], frag[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < nst; ++it) {
    const int s = it % T::STAGES;
    const int buf = it & 1;
    nq_mbar_wait(full + 8 * s, (it / T::STAGES) & 1);
    // realign this warpgroup's staged rows into its operand buffer while
    // the previous stage's products run: row k, chunk c reads 8 values
    // from column 8c + r, written in the 128-byte swizzle, K-major (64
    // positions a row, atoms of 8 rows)
    const unsigned char* stg = smem + s * T::STAGE;
    unsigned char* opb = opw_p + buf * DW16_OPBUF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!mine[j]) continue;
      const int kl = (wt + 128 * j) / 8, c = (wt + 128 * j) % 8;
      const unsigned char* src = stg + (64 * wg + kl) * DW16_SROW + c * 16;
      uint4 q = nq_realign16(*reinterpret_cast<const uint4*>(src),
                             *reinterpret_cast<const uint4*>(src + 16), rr[j]);
      if (act_in) nq_gelu_chunk(q);
      *reinterpret_cast<uint4*>(opb + kl * 128 + ((c ^ (kl & 7)) << 4)) = q;
    }
    nq_fence_proxy_async();
    // the previous stage's products are done: once every warp of the
    // warpgroup knows (and has written its rows), the buffer they read may
    // be rewritten next turn, their ring stage is released and their sum
    // joins the running one
    nq_wgmma_wait<0>();
    nq_named_bar_sync(1 + wg, 128);
    if (it > 0) {
      if (lane == 0) nq_mbar_arrive(empty + 8 * ((it - 1) % T::STAGES));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += frag[i];
    }
    nq_wgmma_fence();
#pragma unroll
    for (int q = 0; q < DW16_P / 16; ++q) {
      // both operands K-major: 64 positions a row, a k16 slice 32 bytes on
      const uint64_t da = nq_desc_sw128(opw + buf * DW16_OPBUF + q * 32, 16,
                                        1024);
      const uint64_t db = nq_desc_sw128(base + s * T::STAGE + DW16_XSTG +
                                        q * 32, 16, 1024);
      if constexpr (BN == 64)
        nq_wgmma_n64<0, 0>(frag, da, db, q);
      else if constexpr (BN == 96)
        nq_wgmma_n96<0, 0>(frag, da, db, q);
      else
        nq_wgmma_n128<0, 0>(frag, da, db, q);
    }
    nq_wgmma_commit();
  }
  nq_wgmma_wait<0>();
  if (nst > 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += frag[i];
  }

  // the block's partial tile, rows of the K-row layout, 8-byte stores that
  // fill 32-byte sectors
  float* pout = part + (size_t)blockIdx.z * nrows * cout;
  const int wl = warp & 3, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int k = k0 + 64 * wg + 16 * wl + g + 8 * hh;
    if (k >= nrows) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c0 + 8 * j + 2 * tq;
      if (c < cout)
        *reinterpret_cast<float2*>(pout + (size_t)k * cout + c) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

template <int BN>
cudaError_t launch_bf16(const DwMaps16& maps, const int4* ksteps, float* part,
                        int cout, int mp, int nsteps, int positions,
                        int splits, int chunk, int act_in,
                        cudaStream_t stream) {
  using T = DwTile16<BN>;
  auto kernel = tail_conv_dw_cf_bf16_kernel<BN>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((nsteps * 4 + DW16_K - 1) / DW16_K, (cout + BN - 1) / BN,
                  splits);
  kernel<<<grid, DW16_THREADS, T::SMEM_BYTES, stream>>>(
      maps, ksteps, part, cout, mp, nsteps, positions, chunk, act_in);
  return cudaGetLastError();
}

// output channels per block of the bf16 kernel (dw_bf16_tile of
// ops/tail_fused.py): of 128, 96 and 64 the one that pads cout least, the
// widest on a tie
int dw16_bn(int cout) {
  int best = 128;
  for (int bn : {96, 64})
    if ((cout + bn - 1) / bn * bn < (cout + best - 1) / best * best) best = bn;
  return best;
}

// output channels per block of the fp32 kernel
int dw_wn(int cout) {
  return cout <= 64                                    ? 4
         : (cout <= 96 || (cout > 128 && cout <= 192)) ? 6
                                                       : 8;
}

bool dw_args_bad(int batch, int cout, int mp, int nsteps, int splits,
                 int chunk) {
  const long positions = (long)batch * mp;
  return batch < 1 || cout < 1 || cout % 8 != 0 || nsteps < 1 ||
         splits < 1 || splits > 65535 || chunk < 1 || chunk % BP != 0 ||
         mp % BP != 0 || (long)splits * chunk < positions ||
         positions > 0x7fffffffL;
}

}  // namespace

// ksteps: (nsteps, 4) int32 rows (shift, first channel or -2, valid rows,
// 0); part: (splits, 4 * nsteps, cout) scratch; out: (4 * nsteps, cout).
extern "C" int nq_tail_conv_dw_cf(const float* x, const float* g,
                                  const int* ksteps, float* part, float* out,
                                  int batch, int cin, int cout, int mp,
                                  int nsteps, int splits, int chunk,
                                  int act_in, void* stream) {
  const long positions = (long)batch * mp;
  if (dw_args_bad(batch, cout, mp, nsteps, splits, chunk))
    return (int)cudaErrorInvalidValue;
  const int4* ks = reinterpret_cast<const int4*>(ksteps);
  const cudaStream_t st = (cudaStream_t)stream;
  // output channels per block: 64, 96 or 128 (_tile_m of
  // ops/tail_fused.py): the tile that leaves the fewest fragment columns of
  // the last tile empty
  const int wn = dw_wn(cout);
#define NQ_LAUNCH(WN)                                                      \
  launch<WN>(x, g, ks, part, cin, cout, mp, nsteps, (int)positions, splits, \
             chunk, act_in, st)
  const cudaError_t err =
      wn == 4 ? NQ_LAUNCH(4) : wn == 6 ? NQ_LAUNCH(6) : NQ_LAUNCH(8);
#undef NQ_LAUNCH
  if (err != cudaSuccess) return (int)err;
  const int n = nsteps * 4 * cout;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n, splits);
  return (int)cudaGetLastError();
}

// The bf16 instantiation: x and g bf16 (16-byte aligned), part and out
// fp32, as above, with Mp and the chunk multiples of 64 and cout of 8.
// Column 3 of each step is its box (nq_tail_conv_cf_bf16); the db step
// has none. Returns cudaErrorNotSupported when the driver refuses a
// tensor map.
extern "C" int nq_tail_conv_dw_cf_bf16(const void* x, const void* g,
                                       const int* ksteps, float* part,
                                       float* out, int batch, int cin,
                                       int cout, int mp, int nsteps,
                                       int splits, int chunk, int act_in,
                                       void* stream) {
  if (dw_args_bad(batch, cout, mp, nsteps, splits, chunk) || cin < 1 ||
      chunk % DW16_P != 0 || mp % DW16_P != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(g) & 15))
    return (int)cudaErrorInvalidValue;
  const int bn = dw16_bn(cout);
  DwMaps16 maps;
  const uint64_t gdims[3] = {(uint64_t)mp, (uint64_t)cout, (uint64_t)batch};
  const uint64_t gstrides[2] = {(uint64_t)mp * 2, (uint64_t)cout * mp * 2};
  const uint32_t gbox[3] = {64, (uint32_t)bn, 1};
  if (!nq_x_maps(maps.x, x, batch, cin, mp, DW16_SEG) ||
      !nq_bf16_map(&maps.g, g, 3, gdims, gstrides, gbox))
    return (int)cudaErrorNotSupported;
  const long positions = (long)batch * mp;
  const int4* ks = reinterpret_cast<const int4*>(ksteps);
  const cudaStream_t st = (cudaStream_t)stream;
#define NQ_LAUNCH(BN)                                                  \
  launch_bf16<BN>(maps, ks, part, cout, mp, nsteps, (int)positions,    \
                  splits, chunk, act_in, st)
  const cudaError_t err =
      bn == 64 ? NQ_LAUNCH(64) : bn == 96 ? NQ_LAUNCH(96) : NQ_LAUNCH(128);
#undef NQ_LAUNCH
  if (err != cudaSuccess) return (int)err;
  const int n = nsteps * 4 * cout;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n, splits);
  return (int)cudaGetLastError();
}

// The launch geometry the bf16 entry uses for `cout`: out[0..2] = output
// channels per block, ring stages, dynamic shared memory bytes (what
// ops/tail_fused.py's dw_bf16_geometry computes).
extern "C" int nq_tail_conv_dw_cf_bf16_tile(int cout, int* out) {
  const int bn = dw16_bn(cout);
  out[0] = bn;
  out[1] = bn == 64 ? DwTile16<64>::STAGES
                    : bn == 96 ? DwTile16<96>::STAGES : DwTile16<128>::STAGES;
  out[2] = bn == 64 ? DwTile16<64>::SMEM_BYTES
                    : bn == 96 ? DwTile16<96>::SMEM_BYTES
                               : DwTile16<128>::SMEM_BYTES;
  return 0;
}
