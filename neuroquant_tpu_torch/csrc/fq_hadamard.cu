// fq_hadamard: fused Hadamard-domain fake-quantization of one conv weight.
//
// Replaces the TPU kernels neuroquant_tpu/ops/pallas_fakequant.py:69
// `_fq_kernel` (entry nq_fq_uaq) and :83 `_ada_kernel` (entry nq_fq_ada).
// For every row r = (cout, ky, kx) of the weight, over its C_in values
// zero-padded to C, a power of two:
//
//   x   = FWHT_C(row) / sqrt(C)                       (hadamard only)
//   q   = clip(round(x / delta) + zp, 0, 2^b - 1)                  (UAQ)
//   q   = clip(floor(x / delta) + h(alpha) + zp, 0, 2^b - 1)  (AdaRound)
//         h = clip(sigmoid(alpha) * 1.2 - 0.1, 0, 1) soft, [alpha >= 0] hard
//   out = FWHT_C((q - zp) * delta) / sqrt(C), cropped to C_in   (hadamard)
//
// delta and zp are per output channel (stride 1) or one per layer (stride
// 0). The TPU kernel multiplies by a dense C x C Hadamard matrix on the
// MXU; here the transform is what it is, a butterfly of exact fp32 adds and
// subtracts, in the stage order (half-width 1, 2, 4, ...) and with the
// final multiply by the fp32 1/sqrt(C) of ops/hadamard.py `fwht`, so the
// values before round/floor carry the plain chain's bits and no rounding
// decision flips. Products that feed an add are `__fmul_rn`, which nvcc
// never contracts into a fused multiply-add; the division is IEEE and
// round is half-to-even (`rintf`).
//
// Layout: every tensor is addressed as base[o * so + k * sk + c * sc]
// (o the output channel, k = ky * KW + kx, c the input channel), so the
// kernel reads the OIHW weight and the (KH, KW, C, C_out) alpha where they
// lie and writes an OIHW result: no transpose, pad or crop pass around it.
//
// Bound on the H100: bytes (HNeRV Bunny-3M: 3.3 M padded elements over
// seven layers, ~34 MB per AdaRound call, ~10 us at 3.35 TB/s), so launch
// latency sets the floor.
//
// Design: one warp per row (several rows per warp when C < 32). Lane l
// holds elements c = j * 32 + l, j < C / 32, in registers; stages of
// half-width < 32 are `__shfl_xor_sync` exchanges, the wider ones pair
// registers of one lane; quantization runs on the registers between the two
// transforms. C <= 1024 (32 registers per lane). Without the transform it
// is an elementwise pass, one thread per element.

#include <cuda_runtime.h>

namespace {

constexpr int MODE_UAQ = 0, MODE_ADA_SOFT = 1, MODE_ADA_HARD = 2;
constexpr int THREADS = 256;
constexpr int MAX_C = 1024;

struct View {          // element (o, k, c) lies at o * so + k * sk + c * sc
  long long so, sk, sc;
  __device__ __forceinline__ long long at(int o, int k, int c) const {
    return o * so + k * sk + c * sc;
  }
};

template <int MODE>
__device__ __forceinline__ float fake_quant(float x, float delta, float zp,
                                            float alpha, float qmax) {
  const float t = x / delta;
  float q;
  if (MODE == MODE_UAQ) {
    q = rintf(t) + zp;
  } else {
    float h;
    if (MODE == MODE_ADA_SOFT) {
      const float s = 1.0f / (1.0f + expf(-alpha));
      h = fminf(fmaxf(__fadd_rn(__fmul_rn(s, 1.2f), -0.1f), 0.f), 1.f);
    } else {
      h = alpha >= 0.f ? 1.f : 0.f;
    }
    q = (floorf(t) + h) + zp;
  }
  q = fminf(fmaxf(q, 0.f), qmax);
  return __fmul_rn(q - zp, delta);
}

// Normalized FWHT over the C = V * g values of one row held by g lanes, V
// registers each (element j * g + gl in v[j] of lane gl).
template <int V>
__device__ __forceinline__ void fwht(float (&v)[V], int gl, int g,
                                     float inv) {
  for (int h = 1; h < g; h <<= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float other = __shfl_xor_sync(0xffffffffu, v[j], h);
      v[j] = (gl & h) ? other - v[j] : v[j] + other;
    }
  }
#pragma unroll
  for (int hj = 1; hj < V; hj <<= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (!(j & hj)) {
        const float a = v[j], b = v[j + hj];
        v[j] = a + b;
        v[j + hj] = a - b;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __fmul_rn(v[j], inv);
}

template <int V, int MODE>
__global__ void fq_hadamard_kernel(const float* __restrict__ x, View xv,
                                   const float* __restrict__ alpha, View av,
                                   const float* __restrict__ delta,
                                   const float* __restrict__ zp, int dstride,
                                   float* __restrict__ out, View ov, int rows,
                                   int kk, int cin, int g, float inv,
                                   float qmax) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int gl = lane & (g - 1);
  const int row = warp * (32 / g) + lane / g;
  // lanes of a row past the end still take part in the shuffles
  const bool live = row < rows;
  const int o = live ? row / kk : 0, k = live ? row % kk : 0;
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = j * g + gl;
    v[j] = (live && c < cin) ? x[xv.at(o, k, c)] : 0.f;
  }
  fwht<V>(v, gl, g, inv);
  const float d = live ? delta[(long long)o * dstride] : 1.f;
  const float z = live ? zp[(long long)o * dstride] : 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float a = 0.f;
    if (MODE != MODE_UAQ && live) a = alpha[av.at(o, k, j * g + gl)];
    v[j] = fake_quant<MODE>(v[j], d, z, a, qmax);
  }
  fwht<V>(v, gl, g, inv);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = j * g + gl;
    if (live && c < cin) out[ov.at(o, k, c)] = v[j];
  }
}

template <int MODE>
__global__ void fq_plain_kernel(const float* __restrict__ x, View xv,
                                const float* __restrict__ alpha, View av,
                                const float* __restrict__ delta,
                                const float* __restrict__ zp, int dstride,
                                float* __restrict__ out, View ov,
                                long long total, int kk, int cin,
                                float qmax) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int row = (int)(i / cin), c = (int)(i % cin);
  const int o = row / kk, k = row % kk;
  const float a = MODE != MODE_UAQ ? alpha[av.at(o, k, c)] : 0.f;
  out[ov.at(o, k, c)] =
      fake_quant<MODE>(x[xv.at(o, k, c)], delta[(long long)o * dstride],
                       zp[(long long)o * dstride], a, qmax);
}

template <int MODE>
int launch(const float* x, View xv, const float* alpha, View av,
           const float* delta, const float* zp, int dstride, float* out,
           View ov, int cout, int kk, int cin, int cpad, int n_levels,
           int hadamard, float inv, cudaStream_t stream) {
  if (cout < 1 || kk < 1 || cin < 1 || n_levels < 2 ||
      (dstride != 0 && dstride != 1) ||
      (long long)cout * kk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rows = cout * kk;
  const float qmax = (float)(n_levels - 1);
  if (!hadamard) {
    const long long total = (long long)rows * cin;
    const long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fq_plain_kernel<MODE><<<(unsigned)blocks, THREADS, 0, stream>>>(
        x, xv, alpha, av, delta, zp, dstride, out, ov, total, kk, cin, qmax);
    return (int)cudaGetLastError();
  }
  if (cpad < cin || cpad > MAX_C || (cpad & (cpad - 1)))
    return (int)cudaErrorInvalidValue;
  const int g = cpad < 32 ? cpad : 32;          // lanes per row
  const int rows_per_block = (THREADS / 32) * (32 / g);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
#define NQ_FQ_CASE(V)                                                       \
  case V:                                                                   \
    fq_hadamard_kernel<V, MODE><<<blocks, THREADS, 0, stream>>>(            \
        x, xv, alpha, av, delta, zp, dstride, out, ov, rows, kk, cin, g,    \
        inv, qmax);                                                         \
    break;
  switch (cpad / g) {
    NQ_FQ_CASE(1)
    NQ_FQ_CASE(2)
    NQ_FQ_CASE(4)
    NQ_FQ_CASE(8)
    NQ_FQ_CASE(16)
    NQ_FQ_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NQ_FQ_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// x, out and alpha are addressed by (so, sk, sc) element strides; delta and
// zp hold cout values (dstride 1) or one (dstride 0); inv is the fp32
// 1/sqrt(cpad), unused without the transform.
extern "C" int nq_fq_uaq(const float* x, long long xso, long long xsk,
                         long long xsc, const float* delta, const float* zp,
                         int dstride, float* out, long long oso,
                         long long osk, long long osc, int cout, int kk,
                         int cin, int cpad, int n_levels, int hadamard,
                         float inv, void* stream) {
  return launch<MODE_UAQ>(x, View{xso, xsk, xsc}, nullptr, View{0, 0, 0},
                          delta, zp, dstride, out, View{oso, osk, osc}, cout,
                          kk, cin, cpad, n_levels, hadamard, inv,
                          (cudaStream_t)stream);
}

extern "C" int nq_fq_ada(const float* x, long long xso, long long xsk,
                         long long xsc, const float* alpha, long long aso,
                         long long ask, long long asc, const float* delta,
                         const float* zp, int dstride, float* out,
                         long long oso, long long osk, long long osc,
                         int cout, int kk, int cin, int cpad, int n_levels,
                         int hadamard, int soft, float inv, void* stream) {
  const View xv{xso, xsk, xsc}, av{aso, ask, asc}, ov{oso, osk, osc};
  if (soft)
    return launch<MODE_ADA_SOFT>(x, xv, alpha, av, delta, zp, dstride, out,
                                 ov, cout, kk, cin, cpad, n_levels, hadamard,
                                 inv, (cudaStream_t)stream);
  return launch<MODE_ADA_HARD>(x, xv, alpha, av, delta, zp, dstride, out, ov,
                               cout, kk, cin, cpad, n_levels, hadamard, inv,
                               (cudaStream_t)stream);
}
