// pack_cf: NHWC -> channels-first flat layout of the decoder tail's entry.
//
// Replaces the TPU kernel neuroquant_tpu/ops/tail_fused.py:656
// `_pack_cf_kernel` (launched by `_pack_cf_t`) together with the pad and
// flatten glue of `pack_cf` (:714-734), in one pass:
//
//   out[b, ch, (y+pad)*wp + (x+pad)] = in[b, y, x, ch]   (ch < c, interior)
//   out[...] = 0                    (border ring, channel pad, flat tail pad)
//
// in is (B, h, w, c) fp32 contiguous, out (B, c8, Mp) with
// wp = w + 2*pad and Mp >= (h+2*pad)*wp.
//
// Bound on the H100: bytes. It is a transpose with no arithmetic: at HNeRV
// Bunny-3M the two entries move ~24 MB per frame (~7 us at 3.35 TB/s).
//
// Design for that bound: a 32x32 shared-memory tile transpose. A block
// owns 32 flat output positions x 32 channels; it reads each position's
// channel run (contiguous in NHWC) with consecutive threads on consecutive
// channels, then writes each channel's 32 positions with consecutive
// threads on consecutive positions, so both sides are coalesced. The tile
// row is padded to 33 floats against shared-memory bank conflicts. Border
// and pad positions are written as zeros in the same pass, so no separate
// memset or pad copy touches the output.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;   // blockDim.y; each thread moves TILE/ROWS values

__global__ void pack_cf_kernel(const float* __restrict__ in,
                               float* __restrict__ out, int h, int w, int c,
                               int c8, int pad, int mp) {
  __shared__ float tile[TILE][TILE + 1];   // [position][channel]
  const int m0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE, b = blockIdx.z;
  const int wp = w + 2 * pad, hp = h + 2 * pad;
#pragma unroll
  for (int i = 0; i < TILE; i += ROWS) {
    const int p = threadIdx.y + i;
    const int m = m0 + p, ch = c0 + threadIdx.x;
    const int row = m / wp, col = m - (m / wp) * wp;
    float v = 0.f;
    if (ch < c && m < hp * wp && row >= pad && row < pad + h && col >= pad &&
        col < pad + w)
      v = in[(((size_t)b * h + (row - pad)) * w + (col - pad)) * c + ch];
    tile[p][threadIdx.x] = v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TILE; i += ROWS) {
    const int ch = c0 + threadIdx.y + i, m = m0 + threadIdx.x;
    if (ch < c8 && m < mp)
      out[((size_t)b * c8 + ch) * mp + m] = tile[threadIdx.x][threadIdx.y + i];
  }
}

}  // namespace

extern "C" int nq_pack_cf(const float* in, float* out, int batch, int h,
                          int w, int c, int c8, int pad, int mp,
                          void* stream) {
  if (batch < 1 || c < 1 || c8 < c || mp < (h + 2 * pad) * (w + 2 * pad))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((mp + TILE - 1) / TILE, (c8 + TILE - 1) / TILE, batch);
  const dim3 block(TILE, ROWS);
  pack_cf_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, out, h, w, c,
                                                           c8, pad, mp);
  return (int)cudaGetLastError();
}
