// unpack_frames: packed head output -> full-resolution NHWC frames.
//
// Replaces the TPU kernels neuroquant_tpu/ops/tail_fused.py:2016
// `_unpack_kernel` and :2003 `_unpack_kernel5` (its width-tiled form),
// launched by `unpack_frames` (:2062):
//
//   out[b, Y*f+u, X*f+v, cc] = img(z[b, (u*f+v)*c + cc, (Y+pad)*wp + X+pad])
//
// z is (B, cp, Mp) fp32 channels-first flat, out (B, h*f, w*f, c); img is
// out_img: sigmoid (mode 0), tanh*0.5+0.5 (mode 1) or +offset (mode 2).
// This is the channel order of `_unpack_jnp` (:1994): interior slice,
// out_img, then depth-to-space by f without a group permutation.
//
// Bound on the H100: bytes. At HNeRV Bunny-3M (f=4, c=3) it reads the
// 48 x 160 x 320 interior and writes a 640 x 1280 x 3 frame, ~20 MB per
// frame (~6 us at 3.35 TB/s); out_img is a few operations per value.
//
// Design for that bound: one block per output row (b, Y*f+u) and tile of
// 64 packed columns X. The row's values come from the g = f*c channels
// u*g .. u*g+g-1 at packed row Y; the block reads them channel by channel
// with consecutive threads on consecutive X (coalesced), applies out_img
// once per value, stages them in shared memory (rows padded to 65 floats
// against bank conflicts), and writes the output row segment X*g + j with
// consecutive threads on consecutive addresses. Any width works, so one
// kernel covers both TPU variants.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 64;
constexpr int SP = TX + 1;      // shared-memory row stride
constexpr int THREADS = 256;

__device__ __forceinline__ float out_img(float x, int mode, float offset) {
  if (mode == 0) return 1.0f / (1.0f + expf(-x));
  if (mode == 1) return tanhf(x) * 0.5f + 0.5f;
  return x + offset;
}

__global__ void __launch_bounds__(THREADS)
unpack_frames_kernel(const float* __restrict__ z, float* __restrict__ out,
                     int cp, int mp, int h, int w, int pad, int f, int c,
                     int mode, float offset) {
  extern __shared__ float s[];   // [g][SP]
  const int g = f * c;
  const int x0 = blockIdx.x * TX, yo = blockIdx.y, b = blockIdx.z;
  const int y = yo / f, u = yo - (yo / f) * f;
  const int wp = w + 2 * pad;
  const int n = min(TX, w - x0);
  const float* zb = z + (size_t)b * cp * mp + (size_t)(y + pad) * wp + pad +
                    x0 + (size_t)u * g * mp;
  for (int t = threadIdx.x; t < g * TX; t += THREADS) {
    const int j = t / TX, xx = t - (t / TX) * TX;
    if (xx < n) s[j * SP + xx] = out_img(zb[(size_t)j * mp + xx], mode, offset);
  }
  __syncthreads();
  float* ob = out + ((size_t)b * h * f + yo) * (size_t)w * g + (size_t)x0 * g;
  for (int t = threadIdx.x; t < n * g; t += THREADS) {
    const int xx = t / g, j = t - (t / g) * g;
    ob[t] = s[j * SP + xx];
  }
}

}  // namespace

extern "C" int nq_unpack_frames(const float* z, float* out, int batch, int cp,
                                int mp, int h, int w, int pad, int f, int c,
                                int mode, float offset, void* stream) {
  if (batch < 1 || f < 1 || c < 1 || f * f * c > cp)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)f * c * SP * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TX - 1) / TX, h * f, batch);
  unpack_frames_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      z, out, cp, mp, h, w, pad, f, c, mode, offset);
  return (int)cudaGetLastError();
}
