// unpack_frames: packed head output -> full-resolution NHWC frames.
//
// Replaces the TPU kernels neuroquant_tpu/ops/tail_fused.py:2016
// `_unpack_kernel` and :2003 `_unpack_kernel5` (its width-tiled form),
// launched by `unpack_frames` (:2062):
//
//   out[b, Y*f+u, X*f+v, cc] = img(z[b, (u*f+v)*c + cc, (Y+pad)*wp + X+pad])
//
// z is (B, cp, Mp) fp32 channels-first flat (Mp a multiple of 4), out
// (B, h*f, w*f, c); img is out_img: sigmoid (mode 0), tanh*0.5+0.5 (mode 1)
// or +offset (mode 2). This is the channel order of `_unpack_jnp` (:1994):
// interior slice, out_img, then depth-to-space by f without a group
// permutation.
//
// Bound on the H100: bytes. At HNeRV Bunny-3M (f=4, c=3) it reads the
// 48 x 160 x 320 interior and writes a 640 x 1280 x 3 frame, 19.7 MB per
// frame (5.9 us at 3.35 TB/s); out_img is a few operations per value.
// Small plans (the width-tiled one: 1.5 MB) are bound by launch latency.
//
// Design for that bound: a block owns one packed row Y of one frame, a
// span of tx packed columns X and fu of the f output rows Y*f+u of that
// span (tail_fused.unpack_frames_geometry picks both: at the Bunny decode
// all f rows and 108 columns; one output row per block for launches that
// would hold too few blocks).
// - It stages the span of the fu*g channel rows (g = f*c) in shared memory
//   with 16-byte loads: a row's interior starts at (Y+pad)*wp + pad, 2
//   floats off a 16-byte boundary at Bunny (wp=324, pad=2), so the block
//   loads the aligned cover and reads at the offset `shift`, as the conv
//   kernel does. out_img is applied once per loaded value, in registers.
// - Output row Y*f+u's segment is contiguous (X*g + j <- channel u*g + j
//   at column X), so it is written with 16-byte stores, a scalar head and
//   tail only where g*w is not a multiple of 4.
// - The output index splits as (X, j) by g, a template parameter for the
//   configs' values (f = 2, 3, 4, 6 at c = 3): a multiply, not a division;
//   one generic instantiation takes g at run time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_IN_FLIGHT = 8;     // loads a lane issues before it waits
constexpr int SMEM_MAX = 48 * 1024;   // without an opt-in attribute

__device__ __forceinline__ float out_img(float x, int mode, float offset) {
  if (mode == 0) return 1.0f / (1.0f + expf(-x));
  if (mode == 1) return tanhf(x) * 0.5f + 0.5f;
  return x + offset;
}

template <int G>   // g = f*c; 0: taken from g_rt at run time
__global__ void __launch_bounds__(THREADS)
unpack_frames_kernel(const float* __restrict__ z, float* __restrict__ out,
                     int cp, int mp, int h, int w, int pad, int f, int g_rt,
                     int fu, int tx, int mode, float offset) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);   // [fu*g rows][tx + 4]
  const int g = G ? G : g_rt;
  const int sp = tx + 4;
  const int nsplit = f / fu;
  const int x0 = blockIdx.x * tx, y = blockIdx.y;
  const int b = blockIdx.z / nsplit, u0 = (blockIdx.z - b * nsplit) * fu;
  const int n = min(tx, w - x0);
  const float* row0 = z + ((size_t)b * cp + (size_t)u0 * g) * mp +
                      (size_t)(y + pad) * (w + 2 * pad) + pad + x0;
  // every channel row shares this offset: Mp is a multiple of 4
  const int shift = (int)((reinterpret_cast<uintptr_t>(row0) >> 2) & 3);
  const int nv4 = (n + shift + 3) >> 2;
  const int rows = fu * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a warp takes rows warp, warp + WARPS, ...; its lanes the float4 columns.
  // All ROWS_IN_FLIGHT loads of a lane are issued before any is used, so a
  // warp waits for one memory round trip, not one per row.
  const float4* src = reinterpret_cast<const float4*>(row0 - shift);
  const size_t mp4 = (size_t)mp >> 2;
  const int sp4 = sp >> 2;
  float4* s4 = reinterpret_cast<float4*>(s);
  for (int r0 = warp; r0 < rows; r0 += WARPS * ROWS_IN_FLIGHT) {
    for (int q = lane; q < nv4; q += 32) {
      float4 v[ROWS_IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < ROWS_IN_FLIGHT; ++k) {
        const int r = r0 + k * WARPS;
        if (r < rows) v[k] = __ldg(src + r * mp4 + q);
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
    float* o =
        out + (((size_t)b * h * f + (size_t)y * f + u0 + u) * w + x0) * g;
    const float* su = s + u * g * sp + shift;     // value (j, X) at j*sp + X
    const int hd = min((int)((4 - ((reinterpret_cast<uintptr_t>(o) >> 2) & 3))
                             & 3), len);
    const int nb4 = (len - hd) >> 2;
    for (int i = threadIdx.x; i < nb4; i += THREADS) {
      const int e = hd + (i << 2);
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xx = (e + k) / g, j = e + k - xx * g;
        v[k] = su[j * sp + xx];
      }
      *reinterpret_cast<float4*>(o + e) = make_float4(v[0], v[1], v[2], v[3]);
    }
    // the scalar head (before the first 16-byte boundary) and tail
    const int t = threadIdx.x, tl = len - hd - (nb4 << 2);
    if (t < hd + tl) {
      const int e = t < hd ? t : hd + (nb4 << 2) + (t - hd);
      const int xx = e / g, j = e - xx * g;
      o[e] = su[j * sp + xx];
    }
  }
}

template <int G>
void launch(const float* z, float* out, int batch, int cp, int mp, int h,
            int w, int pad, int f, int g, int fu, int tx, int mode,
            float offset, size_t smem, cudaStream_t stream) {
  const dim3 grid((w + tx - 1) / tx, h, batch * (f / fu));
  unpack_frames_kernel<G><<<grid, THREADS, smem, stream>>>(
      z, out, cp, mp, h, w, pad, f, g, fu, tx, mode, offset);
}

}  // namespace

// prm: batch, cp, mp, h, w, pad, f, c, mode, tx, fu
// (see tail_fused.unpack_frames_geometry)
extern "C" int nq_unpack_frames(const float* z, float* out, const int* prm,
                                float offset, void* stream) {
  if (prm == nullptr || prm[0] < 1) return (int)cudaErrorInvalidValue;
  const int batch = prm[0], cp = prm[1], mp = prm[2], h = prm[3], w = prm[4],
            pad = prm[5], f = prm[6], c = prm[7], mode = prm[8], tx = prm[9],
            fu = prm[10];
  const int g = f * c;
  const size_t smem = (size_t)fu * g * (tx + 4) * sizeof(float);
  if (f < 1 || c < 1 || f * g > cp || fu < 1 || f % fu || h < 1 || w < 1 ||
      pad < 0 || mp % 4 || mp < (h + 2 * pad) * (w + 2 * pad) || tx < 4 || tx % 4 ||
      mode < 0 || mode > 2 || smem > SMEM_MAX ||
      (reinterpret_cast<uintptr_t>(z) & 3) ||
      (reinterpret_cast<uintptr_t>(out) & 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (g) {   // the template values of tail_fused.UNPACK_G_TEMPLATES
    case 6: launch<6>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx,
                      mode, offset, smem, st); break;
    case 9: launch<9>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx,
                      mode, offset, smem, st); break;
    case 12: launch<12>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx,
                        mode, offset, smem, st); break;
    case 18: launch<18>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx,
                        mode, offset, smem, st); break;
    default: launch<0>(z, out, batch, cp, mp, h, w, pad, f, g, fu, tx,
                       mode, offset, smem, st);
  }
  return (int)cudaGetLastError();
}
