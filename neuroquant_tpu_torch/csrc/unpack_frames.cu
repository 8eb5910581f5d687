// unpack_frames: packed head output -> full-resolution NHWC frames.
//
// Replaces the TPU kernels neuroquant_tpu/ops/tail_fused.py:2016
// `_unpack_kernel` and :2003 `_unpack_kernel5` (its width-tiled form),
// launched by `unpack_frames` (:2062):
//
//   out[b, Y*f+u, X*f+v, cc] = img(z[b, (u*f+v)*c + cc, (Y+pad)*wp + X+pad])
//
// z is (B, cp, Mp) channels-first flat (Mp a multiple of 8), out
// (B, h*f, w*f, c); img is out_img: sigmoid (mode 0), tanh*0.5+0.5 (mode 1)
// or +offset (mode 2). This is the channel order of `_unpack_jnp` (:1994):
// interior slice, out_img, then depth-to-space by f without a group
// permutation.
//
// Bound on the H100: bytes. At HNeRV Bunny-3M (f=4, c=3) it reads the
// 48 x 160 x 320 interior and writes a 640 x 1280 x 3 frame: 19.7 MB per
// frame in fp32 (5.9 us at 3.35 TB/s), 14.7 MB from bf16 to fp32 frames
// (4.4 us), 9.8 MB to bf16 frames (2.9 us); out_img is a few operations
// per value. Small plans (the width-tiled one: 0.7-1.5 MB) are bound by
// launch latency.
//
// Both kernels below own tiles of one packed row Y of one frame, a span of
// tx packed columns X and fu of the f output rows Y*f+u of that span: the
// span of the fu*g channel rows (g = f*c) is staged in shared memory, then
// output row Y*f+u's segment, which is contiguous (X*g + j <- channel
// u*g + j at column X), is written with 16-byte stores. A row's interior
// starts at (Y+pad)*wp + pad, at Bunny (wp=324, pad=2) 2 elements off a
// 16-byte boundary, so the staged span is the aligned cover, read at the
// offset `shift`. The output index splits as (X, j) by g, a template
// parameter for the configs' values (f = 2, 3, 4, 6 at c = 3): a multiply,
// not a division; one generic instantiation takes g at run time.
//
// fp32 -> fp32 (unpack_frames_kernel; tail_fused.unpack_frames_geometry
// picks the tile: at the Bunny decode all f rows and 108 columns, one
// output row for launches that would hold too few blocks): one tile per
// block, loaded with 16-byte loads, 8 rows in flight per lane, out_img
// applied once per loaded value; a scalar head and tail where a segment
// does not start or end on 16 bytes.
//
// bf16 -> fp32 or bf16 frames (the bf16 tail's head output, the TPU
// kernel's `dt`; unpack_frames_bf16_kernel), redesigned for the bytes and
// the instructions (tail_fused.unpack_frames_bf16_geometry picks the
// tile):
// - one output row a block (fu = 1): its g channel rows arrive by TMA
//   bulk copies (one a row, each row's cover contiguous) under an
//   mbarrier, staged as bf16, half the bytes of a staged fp32 value;
// - out_img in fp32 in registers at the store (the fp32 kernel's
//   function, so fp32 frames keep its bits), rounded once to the output
//   type (nearest even);
// - every store is 16 bytes, 4 fp32 or 8 bf16 a lane, consecutive lanes
//   on consecutive vectors. Where the output rows start on 16 bytes and a
//   segment is whole vectors (the configs' widths), lane i writes vector
//   i with a compile-time g; otherwise a segment is walked in the output's
//   aligned 16-byte vectors, and only a vector that a segment's end cuts
//   is written element by element;
// - one output row and a whole row of packed columns a block at the Bunny
//   decode (640 blocks, all resident at once). Fewer blocks, each walking
//   several tiles through a two-stage ring of bulk copies, were slower at
//   every shape measured (PERF.md, Findings).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "nq_common.cuh"
#include "nq_tma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_IN_FLIGHT = 8;     // loads a lane issues before it waits
constexpr int SMEM_MAX = 48 * 1024;   // without an opt-in attribute
constexpr int SMEM_BLOCK = 232448;    // a block's shared memory, at most

__device__ __forceinline__ float out_img(float x, int mode, float offset) {
  if (mode == 0) return 1.0f / (1.0f + expf(-x));
  if (mode == 1) return tanhf(x) * 0.5f + 0.5f;
  return x + offset;
}

template <int G>   // G = f*c; 0: g_rt at run time
__global__ void __launch_bounds__(THREADS)
unpack_frames_kernel(const float* __restrict__ z, float* __restrict__ out,
                     int cp, int mp, int h, int w, int pad, int f, int g_rt,
                     int fu, int tx, int mode, float offset) {
  extern __shared__ float4 smem4[];
  // [fu*g rows][sp]: tx rounded up to whole loads, and a load for the cover
  float* s = reinterpret_cast<float*>(smem4);
  const int g = G ? G : g_rt;
  const int sp = (tx + 3) / 4 * 4 + 4;
  const int nsplit = f / fu;
  const int x0 = blockIdx.x * tx, y = blockIdx.y;
  const int b = blockIdx.z / nsplit, u0 = (blockIdx.z - b * nsplit) * fu;
  const int n = min(tx, w - x0);
  const float* row0 = z + ((size_t)b * cp + (size_t)u0 * g) * mp +
                      (size_t)(y + pad) * (w + 2 * pad) + pad + x0;
  // every channel row shares this offset: Mp is a multiple of 4
  const int shift = (int)((reinterpret_cast<uintptr_t>(row0) / 4) & 3);
  const int nv = (n + shift + 3) / 4;
  const int rows = fu * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a warp takes rows warp, warp + WARPS, ...; its lanes the 16-byte
  // columns. All ROWS_IN_FLIGHT loads of a lane are issued before any is
  // used, so a warp waits for one memory round trip, not one per row.
  const float4* src = reinterpret_cast<const float4*>(row0 - shift);
  const size_t mpv = (size_t)mp / 4;
  const int sp4 = sp >> 2;
  float4* s4 = reinterpret_cast<float4*>(s);
  for (int r0 = warp; r0 < rows; r0 += WARPS * ROWS_IN_FLIGHT) {
    for (int q = lane; q < nv; q += 32) {
      float4 v[ROWS_IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < ROWS_IN_FLIGHT; ++k) {
        const int r = r0 + k * WARPS;
        if (r < rows) v[k] = __ldg(src + r * mpv + q);
      }
#pragma unroll
      for (int k = 0; k < ROWS_IN_FLIGHT; ++k) {
        const int r = r0 + k * WARPS;
        if (r < rows)
          s4[r * sp4 + q] = make_float4(out_img(v[k].x, mode, offset),
                                        out_img(v[k].y, mode, offset),
                                        out_img(v[k].z, mode, offset),
                                        out_img(v[k].w, mode, offset));
      }
    }
  }
  __syncthreads();

  const int len = n * g;
  for (int u = 0; u < fu; ++u) {
    float* o = out + (((size_t)b * h * f + (size_t)y * f + u0 + u) * w + x0) * g;
    const float* su = s + u * g * sp + shift;     // value (j, X) at j*sp + X
    const int hd = min(
        (int)((4 - ((reinterpret_cast<uintptr_t>(o) / 4) & 3)) & 3), len);
    const int nb4 = (len - hd) >> 2;
    for (int i = threadIdx.x; i < nb4; i += THREADS) {
      const int e = hd + (i << 2);
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xx = (e + k) / g, j = e + k - xx * g;
        v[k] = su[j * sp + xx];
      }
      nq_store4(o + e, v[0], v[1], v[2], v[3]);
    }
    // the scalar head (before the first 4-element boundary) and tail
    const int t = threadIdx.x, tl = len - hd - (nb4 << 2);
    if (t < hd + tl) {
      const int e = t < hd ? t : hd + (nb4 << 2) + (t - hd);
      const int xx = e / g, j = e - xx * g;
      o[e] = su[j * sp + xx];
    }
  }
}

template <int G>
void launch(const void* z, void* out, int batch, int cp, int mp, int h,
            int w, int pad, int f, int g, int fu, int tx, int mode,
            float offset, size_t smem, cudaStream_t stream) {
  const dim3 grid((w + tx - 1) / tx, h, batch * (f / fu));
  unpack_frames_kernel<G><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(z), static_cast<float*>(out), cp, mp, h, w,
      pad, f, g, fu, tx, mode, offset);
}

// ---- from bf16 -------------------------------------------------------------

// A staged channel row: the span rounded up to whole 16-byte chunks of 8
// bf16, and a chunk for the cover's offset. Shared memory: the mbarrier
// (128 bytes), then the g staged rows. tail_fused.
// unpack_frames_bf16_geometry mirrors both.
__host__ __device__ __forceinline__ int staged_row(int tx) {
  return (tx + 7) / 8 * 8 + 8;
}
__host__ __device__ __forceinline__ int bf16_smem(int rows, int tx) {
  return 128 + (rows * staged_row(tx) * 2 + 127) / 128 * 128;
}

// the fewest packed columns whose p*g outputs of type TO are whole
// 16-byte vectors: a span of a multiple of them is a segment of whole
// vectors
template <int G, typename TO>
__host__ __device__ constexpr int lane_cols() {
  int p = 1;
  while ((p * G * (int)sizeof(TO)) % 16) p *= 2;
  return p;
}

// 16 bytes of the output type from fp32 values
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(nq_bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(nq_pack_bf16(v[0], v[1]), nq_pack_bf16(v[2], v[3]),
                 nq_pack_bf16(v[4], v[5]), nq_pack_bf16(v[6], v[7]));
}

template <int G, typename TO>   // G = f*c; 0: g_rt at run time
__global__ void __launch_bounds__(THREADS)
unpack_frames_bf16_kernel(const nq_bf16* __restrict__ z, TO* __restrict__ out,
                          int cp, int mp, int h, int w, int pad, int f,
                          int g_rt, int tx, int mode, float offset) {
  constexpr int VO = 16 / sizeof(TO);           // output elements a store
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem);
  const int g = G ? G : g_rt;
  const int sp = staged_row(tx);
  const int x0 = blockIdx.x * tx, y = blockIdx.y;
  const int b = blockIdx.z / f, u = blockIdx.z - b * f;   // output row Y*f+u
  const int n = min(tx, w - x0);
  const nq_bf16* row0 = z + ((size_t)b * cp + (size_t)u * g) * mp +
                        (size_t)(y + pad) * (w + 2 * pad) + pad + x0;
  // every channel row shares this offset: Mp is a multiple of 8
  const int shift = (int)((reinterpret_cast<uintptr_t>(row0) / 2) & 7);
  if (threadIdx.x == 0) {
    nq_mbar_init(bar, 1);
    nq_fence_mbar_init();
  }
  __syncthreads();                 // the mbarrier's init
  // warp 0: the g channel rows' spans, a bulk copy of its 16-byte cover
  // each (lane 0's arrival carries the bytes the phase awaits)
  if (threadIdx.x < 32) {
    const uint32_t bytes = ((n + shift) * 2 + 15) / 16 * 16;
    if (threadIdx.x == 0) nq_mbar_expect_tx(bar, g * bytes);
    for (int r = threadIdx.x; r < g; r += 32)
      nq_bulk_load(bar + 128 + r * sp * 2, row0 - shift + (size_t)r * mp,
                   bytes, bar);
  }
  nq_mbar_wait(bar, 0);
  const nq_bf16* s =
      reinterpret_cast<const nq_bf16*>(smem + 128) + shift;  // (j, X): j*sp+X

  const int len = n * g;
  TO* o = out + (((size_t)b * h * f + (size_t)y * f + u) * w + x0) * g;
  if constexpr (G > 0) {
    // the aligned path: every output row starts on 16 bytes and the
    // segment is whole vectors (P columns make whole vectors), so lane i
    // writes vector i of the segment, consecutive lanes consecutive 16
    // bytes, with a compile-time g and no ends to cut. On an NVIDIA H100
    // 80GB HBM3 at 700 W it beat the walk below alone at every shape
    // measured, ms hot / cold: the Bunny-3M decode to fp32 frames
    // 0.0064-0.0066 / 0.0091-0.0092 against 0.0069-0.0070 / 0.0096, to
    // bf16 frames 0.0063-0.0064 / 0.0089-0.0091 against 0.0067-0.0068 /
    // 0.0092-0.0093, PNeRV's head and the width-tiled plan by 0.0001-0.0005
    // hot (scripts/torch_layout_bench.py --dtype bf16, the two in turns)
    constexpr int P = lane_cols<G, TO>();
    if (((size_t)w * G * sizeof(TO)) % 16 == 0 && n % P == 0) {
      for (int e0 = threadIdx.x * VO; e0 < len; e0 += THREADS * VO) {
        float v[VO];
#pragma unroll
        for (int kk = 0; kk < VO; ++kk) {
          const int xx = (e0 + kk) / G, j = e0 + kk - xx * G;
          v[kk] = out_img(__bfloat162float(s[j * sp + xx]), mode, offset);
        }
        store16(o + e0, v);
      }
      return;
    }
  }
  // any alignment: the segment walked in the output's aligned 16-byte
  // vectors; only a vector that the segment's end cuts is written element
  // by element
  const int head = (int)((reinterpret_cast<uintptr_t>(o) / sizeof(TO)) &
                         (VO - 1));               // elements before o
  const int nv = (head + len + VO - 1) / VO;
  for (int i = threadIdx.x; i < nv; i += THREADS) {
    const int e0 = i * VO - head;
    float v[VO];
#pragma unroll
    for (int kk = 0; kk < VO; ++kk) {
      const int e = min(max(e0 + kk, 0), len - 1);
      const int xx = e / g, j = e - xx * g;
      v[kk] = out_img(__bfloat162float(s[j * sp + xx]), mode, offset);
    }
    if (e0 >= 0 && e0 + VO <= len) {
      store16(o + e0, v);
    } else {                      // a vector the segment's end cuts
#pragma unroll
      for (int kk = 0; kk < VO; ++kk)
        if (e0 + kk >= 0 && e0 + kk < len)
          o[e0 + kk] = nq_from_f32<TO>(v[kk]);
    }
  }
}

template <int G, typename TO>
cudaError_t launch_bf16(const void* z, void* out, int batch, int cp, int mp,
                        int h, int w, int pad, int f, int g, int tx, int mode,
                        float offset, int smem, cudaStream_t st) {
  auto kernel = unpack_frames_bf16_kernel<G, TO>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((w + tx - 1) / tx, h, batch * f);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const nq_bf16*>(z), static_cast<TO*>(out), cp, mp, h, w,
      pad, f, g, tx, mode, offset);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_bf16_g(const void* z, void* out, int batch, int cp,
                          int mp, int h, int w, int pad, int f, int g, int tx,
                          int mode, float offset, int smem, cudaStream_t st) {
  switch (g) {   // the template values of tail_fused.UNPACK_G_TEMPLATES
    case 6: return launch_bf16<6, TO>(z, out, batch, cp, mp, h, w, pad, f, g,
                                      tx, mode, offset, smem, st);
    case 9: return launch_bf16<9, TO>(z, out, batch, cp, mp, h, w, pad, f, g,
                                      tx, mode, offset, smem, st);
    case 12: return launch_bf16<12, TO>(z, out, batch, cp, mp, h, w, pad, f,
                                        g, tx, mode, offset, smem, st);
    case 18: return launch_bf16<18, TO>(z, out, batch, cp, mp, h, w, pad, f,
                                        g, tx, mode, offset, smem, st);
    default: return launch_bf16<0, TO>(z, out, batch, cp, mp, h, w, pad, f,
                                       g, tx, mode, offset, smem, st);
  }
}

}  // namespace

// prm: batch, cp, mp, h, w, pad, f, c, mode, tx, fu, the input's and the
// output's type (0 fp32, 1 bf16: fp32 -> fp32, bf16 -> fp32,
// bf16 -> bf16), the bits of out_img's offset (a float), the shared-memory
// bytes a block (see tail_fused.unpack_frames_geometry and
// unpack_frames_bf16_geometry)
extern "C" int nq_unpack_frames(const void* z, void* out, const int* prm,
                                void* stream) {
  if (prm == nullptr || prm[0] < 1) return (int)cudaErrorInvalidValue;
  const int batch = prm[0], cp = prm[1], mp = prm[2], h = prm[3], w = prm[4],
            pad = prm[5], f = prm[6], c = prm[7], mode = prm[8], tx = prm[9],
            fu = prm[10], tin = prm[11], tout = prm[12], smem_in = prm[14];
  float offset;
  memcpy(&offset, prm + 13, sizeof(float));
  const int g = f * c;
  const int isz = tin == 1 ? 2 : 4, osz = tout == 1 ? 2 : 4;
  if (f < 1 || c < 1 || f * g > cp || fu < 1 || f % fu || h < 1 || w < 1 ||
      pad < 0 || mp % (tin == 1 ? 8 : 4) ||
      mp < (h + 2 * pad) * (w + 2 * pad) || tx < 4 || mode < 0 ||
      mode > 2 || tin < 0 || tin > 1 || tout < 0 || tout > 1 ||
      (tin == 0 && tout != 0) ||
      (reinterpret_cast<uintptr_t>(z) & (isz - 1)) ||
      (reinterpret_cast<uintptr_t>(out) & (tin == 1 ? 15 : osz - 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tin == 0) {
    const size_t smem = (size_t)fu * g * ((tx + 3) / 4 * 4 + 4) * 4;
    if (tx % 4 || smem > SMEM_MAX || smem_in != (int)smem)
      return (int)cudaErrorInvalidValue;
    switch (g) {   // the template values of tail_fused.UNPACK_G_TEMPLATES
      case 6: launch<6>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx, mode,
                        offset, smem, st); break;
      case 9: launch<9>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx, mode,
                        offset, smem, st); break;
      case 12: launch<12>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx,
                          mode, offset, smem, st); break;
      case 18: launch<18>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx,
                          mode, offset, smem, st); break;
      default: launch<0>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx, mode,
                         offset, smem, st);
    }
    return (int)cudaGetLastError();
  }
  // one output row a block (fu = 1)
  const long smem = bf16_smem(g, tx);
  if (tx % 8 || fu != 1 || smem > SMEM_BLOCK || smem_in != smem)
    return (int)cudaErrorInvalidValue;
  if (tout == 0)
    return (int)launch_bf16_g<float>(z, out, batch, cp, mp, h, w, pad, f, g,
                                     tx, mode, offset, (int)smem, st);
  return (int)launch_bf16_g<nq_bf16>(z, out, batch, cp, mp, h, w, pad, f, g,
                                     tx, mode, offset, (int)smem, st);
}
