// unpack_cf: channels-first flat layout -> NHWC, the backward of pack_cf.
//
// Replaces the TPU kernel neuroquant_tpu/ops/tail_fused.py:666
// `_unpack_cf_kernel` (defined beside `_pack_cf_kernel`; the JAX package
// takes an XLA transpose for `pack_cf`'s backward, :736-745):
//
//   out[b, y, x, ch] = in[b, ch, (y+pad)*wp + (x+pad)]   (ch < c)
//
// in is (B, c8, Mp) fp32, out (B, h, w, c) contiguous: only the interior is
// read, the border ring, the channel pad and the flat tail pad are dropped.
//
// Bound on the H100: bytes. A transpose with no arithmetic: at HNeRV
// Bunny-3M, batch 2, the two tail entries move ~23 MB per step (~7 us at
// 3.35 TB/s).
//
// Design for that bound: the mirror of pack_cf.cu, a 32x32 shared-memory
// tile transpose. A block owns 32 interior positions (flat over h*w) x 32
// channels; it reads each channel's positions with consecutive threads on
// consecutive positions, and writes each position's channel run with
// consecutive threads on consecutive channels, so both sides are
// coalesced. The tile row is padded to 33 floats against bank conflicts.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;   // blockDim.y; each thread moves TILE/ROWS values

__global__ void unpack_cf_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int h, int w, int c,
                                 int c8, int pad, int mp) {
  __shared__ float tile[TILE][TILE + 1];   // [channel][position]
  const int q0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE, b = blockIdx.z;
  const int wp = w + 2 * pad, hw = h * w;
#pragma unroll
  for (int i = 0; i < TILE; i += ROWS) {
    const int ch = c0 + threadIdx.y + i, q = q0 + threadIdx.x;
    float v = 0.f;
    if (ch < c && q < hw) {
      const int y = q / w, xx = q - (q / w) * w;
      v = in[((size_t)b * c8 + ch) * mp + (size_t)(y + pad) * wp + xx + pad];
    }
    tile[threadIdx.y + i][threadIdx.x] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TILE; i += ROWS) {
    const int q = q0 + threadIdx.y + i, ch = c0 + threadIdx.x;
    if (q < hw && ch < c)
      out[((size_t)b * hw + q) * c + ch] = tile[threadIdx.x][threadIdx.y + i];
  }
}

}  // namespace

extern "C" int nq_unpack_cf(const float* in, float* out, int batch, int h,
                            int w, int c, int c8, int pad, int mp,
                            void* stream) {
  if (batch < 1 || c < 1 || c8 < c || h < 1 || w < 1 ||
      mp < (h + 2 * pad) * (w + 2 * pad))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((h * w + TILE - 1) / TILE, (c + TILE - 1) / TILE, batch);
  const dim3 block(TILE, ROWS);
  unpack_cf_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, out, h, w,
                                                             c, c8, pad, mp);
  return (int)cudaGetLastError();
}
