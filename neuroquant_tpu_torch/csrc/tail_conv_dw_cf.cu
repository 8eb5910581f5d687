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
// operands): x and g bf16, the products on mma.sync.m16n8k16.bf16 (exact
// in fp32), the sums and dW, db fp32; act_in rounds GELU(x) to bf16, as
// the JAX tail's `_gelu` does. The same block and warp shapes, the same
// position splits and the same reduction pass, with these differences:
//  * Both operands are contiguous along the reduction, so every fragment
//    register is a pair of consecutive positions. For g that pair is an
//    aligned 32-bit word. For x at an odd shift it is not: an X row is
//    copied as the 17 aligned words that cover its 32 positions (4-byte
//    cp.async, m + shift rounded down to even), and a register is taken
//    from two neighbouring words by a funnel shift of 16 bits when the
//    row's shift is odd (of 0 bits when even).
//  * Row strides of 20 words (= 20 mod 32) make those loads hit 32
//    distinct banks; a stage is (128 + cout tile) x 80 bytes.
//  * A stage's two k16 products of each fragment are chained in the tensor
//    core from zero and added to the fp32 sum by the fp32 adders: the
//    tensor core's truncating accumulation would drift over the ~10^5
//    positions a dW sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdint>

#include "nq_common.cuh"
#include "nq_mma.cuh"

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

// ---- bf16 instantiation ------------------------------------------------

constexpr int LDW16 = 20;      // stage row stride, 32-bit words (2 bf16)
constexpr int XW = BP / 2 + 1;  // words covering an X row's 32 positions

template <int WN>
struct Tile16 {
  static constexpr int BN = 16 * WN;
  static constexpr int STAGE = (BM + BN) * LDW16;      // words per stage
  static constexpr int STAGES = 4;
  static constexpr int SMEM_BYTES = STAGES * STAGE * 4;
};

template <int WN>
__global__ void __launch_bounds__(THREADS, 2)
tail_conv_dw_cf_bf16_kernel(const nq_bf16* __restrict__ x,
                            const nq_bf16* __restrict__ g,
                            const int4* __restrict__ ksteps,
                            float* __restrict__ part, int cin, int cout,
                            int mp, int nsteps, int positions, int chunk,
                            int act_in) {
  using T = Tile16<WN>;
  extern __shared__ __align__(16) uint32_t smem_w[];
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

  constexpr int XCOPIES = BM * XW;
  constexpr int XROUNDS = (XCOPIES + THREADS - 1) / THREADS;
  constexpr int GCOPIES = T::BN * (BP / 8);         // 16-byte vectors of g
  constexpr int GROUNDS = (GCOPIES + THREADS - 1) / THREADS;

  auto load_stage = [&](int stage, int st_i) {
    uint32_t* xs = smem_w + stage * T::STAGE;
    uint32_t* gs = xs + BM * LDW16;
    const int p0 = p_begin + st_i * BP;
    const int b = p0 / mp;
    const int m = p0 - b * mp;
    const nq_bf16* xb = x + (size_t)b * cin * mp;
    const nq_bf16* gb = g + (size_t)b * cout * mp;
#pragma unroll
    for (int i = 0; i < XROUNDS; ++i) {
      const int idx = tid + i * THREADS;
      if (idx >= XCOPIES) break;
      const int row = idx / XW, j = idx - row * XW;
      const int4 st = steps[row >> 2];              // shift, chan, rows
      const int rr = row & 3;
      uint32_t* dst = xs + row * LDW16 + j;
      if (st.y == -2) {                             // the row of ones: db
        *dst = rr == 0 ? 0x3f803f80u : 0u;
        continue;
      }
      const int pos = m + (st.x & ~1) + 2 * j;      // even, as m and Mp
      const bool valid = rr < st.z && pos >= 0 && pos < mp;
      const nq_bf16* src = valid ? xb + (size_t)(st.y + rr) * mp + pos : xb;
      nq_cp_async4(nq_smem_addr(dst), src, valid);
    }
#pragma unroll
    for (int i = 0; i < GROUNDS; ++i) {
      const int idx = tid + i * THREADS;
      if (idx >= GCOPIES) break;
      const int row = idx >> 2, v = idx & 3;
      const bool valid = c0 + row < cout;
      const nq_bf16* src =
          valid ? gb + (size_t)(c0 + row) * mp + m + v * 8 : gb;
      nq_cp_async16(nq_smem_addr(gs + row * LDW16 + v * 4), src, valid);
    }
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  bool nt_ok[WN];
#pragma unroll
  for (int j = 0; j < WN; ++j)
    nt_ok[j] = c0 + (warp_n * WN + j) * 8 < cout;

  // this thread's A rows (gq and gq + 8 of each fragment row) and the
  // funnel shift their step's shift parity asks for
  int arow[WM][2], fsh[WM][2];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      arow[i][hh] = (warp_m * WM + i) * 16 + gq + 8 * hh;
      fsh[i][hh] = (steps[arow[i][hh] >> 2].x & 1) * 16;
    }

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nst) load_stage(s, s);
    nq_cp_async_commit();
  }

  for (int it = 0; it < nst; ++it) {
    const int stage = it % T::STAGES;
    nq_cp_async_wait<T::STAGES - 2>();
    uint32_t* xs = smem_w + stage * T::STAGE;
    const uint32_t* gs = xs + BM * LDW16;
    if (act_in) {
      // this thread's own copies have landed: GELU them once, in place,
      // each value rounded back to bf16 (not the row of ones)
#pragma unroll
      for (int i = 0; i < XROUNDS; ++i) {
        const int idx = tid + i * THREADS;
        if (idx >= XCOPIES) break;
        const int row = idx / XW, j = idx - row * XW;
        if (steps[row >> 2].y == -2) continue;
        uint32_t* p = xs + row * LDW16 + j;
        *p = nq_gelu_bf16x2(*p);
      }
    }
    __syncthreads();
    if (it + T::STAGES - 1 < nst)
      load_stage((it + T::STAGES - 1) % T::STAGES, it + T::STAGES - 1);
    nq_cp_async_commit();

    // A fragments of the stage's two k16 halves: positions 16*half + 2t
    // (word 8*half + t of the cover) and + 8 (word + 4)
    uint32_t af[2][WM][4];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const uint32_t* p0 = xs + arow[i][0] * LDW16 + 8 * kh + t;
        const uint32_t* p1 = xs + arow[i][1] * LDW16 + 8 * kh + t;
        af[kh][i][0] = __funnelshift_r(p0[0], p0[1], fsh[i][0]);
        af[kh][i][1] = __funnelshift_r(p1[0], p1[1], fsh[i][1]);
        af[kh][i][2] = __funnelshift_r(p0[4], p0[5], fsh[i][0]);
        af[kh][i][3] = __funnelshift_r(p1[4], p1[5], fsh[i][1]);
      }
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      if (!nt_ok[j]) continue;
      const uint32_t* q = gs + ((warp_n * WN + j) * 8 + gq) * LDW16 + t;
      const uint32_t b0[2] = {q[0], q[4]};
      const uint32_t b1[2] = {q[8], q[12]};
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        float d[4];
        nq_mma_bf16_zero(d, af[0][i], b0);
        nq_mma_bf16(d, af[1][i], b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
      }
    }
  }

  float* pout = part + (size_t)blockIdx.z * nrows * cout;
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = k0 + arow[i][hh];
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

template <int WN>
cudaError_t launch_bf16(const nq_bf16* x, const nq_bf16* g,
                        const int4* ksteps, float* part, int cin, int cout,
                        int mp, int nsteps, int positions, int splits,
                        int chunk, int act_in, cudaStream_t stream) {
  using T = Tile16<WN>;
  auto kernel = tail_conv_dw_cf_bf16_kernel<WN>;
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

// output channels per block, shared by both instantiations
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

// The bf16 instantiation: x and g bf16 (x 4-byte, g 16-byte aligned),
// part and out fp32, as above.
extern "C" int nq_tail_conv_dw_cf_bf16(const void* x, const void* g,
                                       const int* ksteps, float* part,
                                       float* out, int batch, int cin,
                                       int cout, int mp, int nsteps,
                                       int splits, int chunk, int act_in,
                                       void* stream) {
  if (dw_args_bad(batch, cout, mp, nsteps, splits, chunk) ||
      (reinterpret_cast<uintptr_t>(x) & 3) ||
      (reinterpret_cast<uintptr_t>(g) & 15))
    return (int)cudaErrorInvalidValue;
  const long positions = (long)batch * mp;
  const int4* ks = reinterpret_cast<const int4*>(ksteps);
  const cudaStream_t st = (cudaStream_t)stream;
  const nq_bf16* xh = static_cast<const nq_bf16*>(x);
  const nq_bf16* gh = static_cast<const nq_bf16*>(g);
  const int wn = dw_wn(cout);
#define NQ_LAUNCH(WN)                                                     \
  launch_bf16<WN>(xh, gh, ks, part, cin, cout, mp, nsteps, (int)positions, \
                  splits, chunk, act_in, st)
  const cudaError_t err =
      wn == 4 ? NQ_LAUNCH(4) : wn == 6 ? NQ_LAUNCH(6) : NQ_LAUNCH(8);
#undef NQ_LAUNCH
  if (err != cudaSuccess) return (int)err;
  const int n = nsteps * 4 * cout;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n, splits);
  return (int)cudaGetLastError();
}
