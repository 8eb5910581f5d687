// fq_hadamard: fused Hadamard-domain fake-quantization of a group of conv
// weights, forward and backward, each one launch for the whole group.
//
// Replaces the TPU kernels neuroquant_tpu/ops/pallas_fakequant.py:69
// `_fq_kernel` and :83 `_ada_kernel` (entry nq_fq_group_forward), and the
// VJP that the JAX package takes of the plain chain in `_uaq_bwd` (:213)
// and `_ada_bwd` (:238) (entry nq_fq_group_backward). For every row
// r = (cout, ky, kx) of a weight, over its C_in values zero-padded to C, a
// power of two:
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
// The backward is the plain chain's VJP in closed form, with gq the
// output's gradient zero-padded and transformed, m the clip's mask (1
// inside, 1/2 on a bound, 0 outside: the split of a tie that jnp.clip and
// the port's `_clip` give) and A = gq * delta:
//   UAQ       dx = m A / delta, dw = FWHT^T(dx) cropped to C_in,
//             ddelta = sum gq (q - zp) + sum -m A ((x / delta) / delta),
//   AdaRound  dw = 0 (floor), ddelta = sum gq (q - zp),
//             dalpha = m A m_h * 1.2 * (1 - s) * s (soft; s = sigmoid(alpha),
//             m_h the mask of h's own clip; hard: none),
//   both      dzp = sum m A + sum -A,
// every product in the order autograd takes it through the plain chain
// (`fake_quant_vjp_ref` in ops/fused_fakequant.py), and FWHT^T the stages
// in reverse order after the multiply by 1/sqrt(C), as autograd's backward
// of `fwht` runs them: dw and dalpha are autograd's to the bit. The sums
// over a channel's kk * C elements are taken in a fixed order (per lane,
// then a shuffle tree over the row's lanes, then the rows in order), with no
// atomics: the same bits every run, another order than torch's reduction.
//
// Bound on the H100: bytes (HNeRV Bunny-3M: 3.3 M padded elements over
// seven layers; forward ~21 MB UAQ and ~34 MB AdaRound, 6.3 and 10.3 us at
// 3.35 TB/s), so launch latency sets the floor: one launch per group.
//
// Design. A launch takes up to MAX_LAYERS layers, described by one
// `__grid_constant__` Group. Blocks map to layers through the prefix
// `block0`; a block owns `cpb` whole output channels of one layer (its
// rows are those channels' kk rows), so the channel sums stay in the block.
// One warp takes a row at a time (32 / lanes rows when C < 32); lane l
// holds elements c = j * lanes + l, j < v = C / lanes, in registers;
// stages of half-width < lanes are `__shfl_xor_sync` exchanges, the wider
// ones pair registers of one lane; the quantizer runs on the registers
// between the transforms. A channel's kk * C_in weights are contiguous in
// the OIHW parameter (and its gradient), so a tile's weights, gradients
// and alphas are staged in shared memory, a contiguous run copied straight
// and any other layout a row per warp (an alpha made in the transform's
// domain has c fastest, so its rows are runs too); the rows are computed
// there, the results written back in place and stored the same way. The
// blocks are persistent, with two tile buffers: each asks for its next
// tile with cp.async before it computes the current one, so one tile's
// loads overlap the other's arithmetic. A layer whose channels do not fit
// a buffer (C_in * kk past ~5k values) reads and writes global memory
// directly. The backward computes only what the layer's `need` asks: no
// dw pass in a calibration, no sums in its phase 2.
// C <= 1024 (32 registers per lane); the launcher instantiates the
// kernels for v <= 4 (C <= 128) when the group allows it, as HNeRV's does.

#include <cuda_runtime.h>

namespace {

// threads a block and the blocks an SM keeps of the narrow instantiation
// (64 registers a thread): 256 and 4 beat 512 and 2 on each of the four
// passes, timed in turns on an H100 (PERF.md). The Python tile map
// (fused_fakequant.FQ_WARPS) assumes THREADS; nq_fq_threads() checks it at
// load.
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 4;
constexpr int MODE_UAQ = 0, MODE_ADA_SOFT = 1, MODE_ADA_HARD = 2;
constexpr int MAX_LAYERS = 16;
constexpr int MAX_BLOCK_ROWS = 256;   // rows of a block's channel sums
// one tile buffer's floats: two buffers and the rows' sums fit the 48 KB a
// block takes without opting in
constexpr int STAGE_FLOATS = 5632;
constexpr int MAX_C = 1024;
// what a backward launch writes, per layer
constexpr int NEED_W = 1, NEED_DELTA = 2, NEED_ZP = 4, NEED_ALPHA = 8;

struct View {          // element (o, k, c) lies at o * so + k * sk + c * sc
  int so, sk, sc;
  __device__ __forceinline__ long long at(int o, int k, int c) const {
    return (long long)o * so + (long long)k * sk + (long long)c * sc;
  }
};

// One layer of a launch. Its mirror is `_Layer` in ops/fused_fakequant.py:
// change both together (nq_fq_group_bytes() checks the size at load).
struct Layer {
  const float* w;        // the weight, (o, k, c) at wv
  const float* alpha;    // AdaRound alphas, (o, k, c < cq) at av, or null
  const float* delta;    // cout values (dstride 1) or one (dstride 0)
  const float* zp;
  float* out;            // forward: the OIHW result
  const float* g;        // backward: the output's gradient, at gv
  float* dw;             // backward: OIHW, or null
  float* dalpha;         // backward: alpha's layout (av), or null
  float* ddelta;         // backward: cout channel sums, or null
  float* dzp;            // backward: cout channel sums, or null
  View wv, av, gv;
  int cout, kk, cin;
  int cq;                // the quantization domain's width: C, or C_in
  int lanes, v;          // lanes per row and values per lane: C = lanes * v
  int levels, mode, dstride, hadamard;
  int block0;            // the layer's first block in the launch
  int cpb;               // output channels per block
  int staged;            // the block's channels go through shared memory
  int need;              // backward: NEED_* bits
  float inv;             // the fp32 1/sqrt(C)
};

struct Group {
  int n, blocks;
  Layer layer[MAX_LAYERS];
};

__device__ __forceinline__ float clip_mask(float v, float hi) {
  return (v > 0.f && v < hi) ? 1.f : ((v == 0.f || v == hi) ? 0.5f : 0.f);
}

struct Quant {
  float t;    // x / delta
  float q;    // the clipped code
  float m;    // its clip's mask
  float s;    // sigmoid(alpha) (soft)
  float mh;   // the mask of h's clip (soft)
};

__device__ __forceinline__ Quant quantize(float x, float delta, float zp,
                                          float alpha, float qmax, int mode) {
  const float t = x / delta;
  Quant r;
  r.t = t;
  r.s = 0.f;
  r.mh = 0.f;
  float xz;
  if (mode == MODE_UAQ) {
    xz = rintf(t) + zp;
  } else {
    float h;
    if (mode == MODE_ADA_SOFT) {
      r.s = 1.0f / (1.0f + expf(-alpha));
      const float hp = __fadd_rn(__fmul_rn(r.s, 1.2f), -0.1f);
      r.mh = clip_mask(hp, 1.f);
      h = fminf(fmaxf(hp, 0.f), 1.f);
    } else {
      h = alpha >= 0.f ? 1.f : 0.f;
    }
    xz = (floorf(t) + h) + zp;
  }
  r.m = clip_mask(xz, qmax);
  r.q = fminf(fmaxf(xz, 0.f), qmax);
  return r;
}

// Normalized FWHT over the C = V * g values of one row held by g lanes, V
// registers each (element j * g + gl in v[j] of lane gl): the stages in
// order (half-width 1, 2, ...), then the multiply by inv.
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

// Its transpose as autograd computes it: the multiply by inv first, then
// the stages from the widest down (the same butterfly: H is symmetric).
template <int V>
__device__ __forceinline__ void fwht_t(float (&v)[V], int gl, int g,
                                       float inv) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __fmul_rn(v[j], inv);
#pragma unroll
  for (int hj = V / 2; hj >= 1; hj >>= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (!(j & hj)) {
        const float a = v[j], b = v[j + hj];
        v[j] = a + b;
        v[j + hj] = a - b;
      }
    }
  }
  for (int h = g >> 1; h >= 1; h >>= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float other = __shfl_xor_sync(0xffffffffu, v[j], h);
      v[j] = (gl & h) ? other - v[j] : v[j] + other;
    }
  }
}

__device__ __forceinline__ int layer_of(const Group& grp, int tile) {
  int i = 0;
  while (i + 1 < grp.n && tile >= grp.layer[i + 1].block0) ++i;
  return i;
}

// the contiguous OIHW layout of a result (out, dw)
__device__ __forceinline__ View oihw(const Layer& L) {
  return View{L.cin * L.kk, 1, L.kk};
}

// A tile: channels [o0, o0 + nch) of one layer, their rows, and where
// each of its staged tensors lies in a shared-memory buffer (element
// (ol, k, c) of a tensor of width n at (ol * n + c) * kk + k, the OIHW
// order).
struct Tile {
  int o0, nch, nrows;
  float* sw;   // weight, then the forward's result / dw
  float* sa;   // alpha, then dalpha
  float* sg;   // the output's gradient
  float* part; // the rows' sums, 4 per row (backward)
};

__device__ __forceinline__ Tile make_tile(const Layer& L, int tile,
                                          float* buf, float* part) {
  Tile t;
  t.o0 = (tile - L.block0) * L.cpb;
  t.nch = min(L.cpb, L.cout - t.o0);
  t.nrows = t.nch * L.kk;
  const int wn = L.staged ? L.cpb * L.cin * L.kk : 0;
  const int an = (L.staged && L.mode != MODE_UAQ) ? L.cpb * L.cq * L.kk : 0;
  t.sw = buf;
  t.sa = t.sw + wn;
  t.sg = t.sa + an;
  t.part = part;
  return t;
}

// Asynchronous 4-byte copies into shared memory (sm_80 and later): a
// block asks for its next tile before it computes the current one.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A tile's elements (ol, k, c < n) of an (o, k, c) tensor and their places
// (ol * n + c) * kk + k in shared memory. A dense OIHW view (the HWIO view
// of an OIHW parameter or gradient) is one contiguous run; any other view
// goes a row (ol, k) per warp, its n values over the lanes (coalesced where
// c is the fastest axis, as in an alpha made in the transform's domain).
__device__ __forceinline__ void stage_in(float* s, const float* src, View v,
                                         const Tile& t, int kk, int n) {
  const int per = n * kk, total = t.nch * per;
  if (v.sk == 1 && v.sc == kk && v.so == per) {
    const float* base = src + (long long)t.o0 * per;
    for (int e = threadIdx.x; e < total; e += THREADS)
      cp_async4(s + e, base + e);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < t.nrows; row += WARPS) {
    const int ol = row / kk, k = row - ol * kk;
    for (int c = lane; c < n; c += 32)
      cp_async4(s + (ol * n + c) * kk + k, src + v.at(t.o0 + ol, k, c));
  }
}

// the same places back to a tensor, with plain stores
__device__ __forceinline__ void stage_out(float* dst, const float* s, View v,
                                          const Tile& t, int kk, int n) {
  const int per = n * kk, total = t.nch * per;
  if (v.sk == 1 && v.sc == kk && v.so == per) {
    float* base = dst + (long long)t.o0 * per;
    for (int e = threadIdx.x; e < total; e += THREADS) base[e] = s[e];
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < t.nrows; row += WARPS) {
    const int ol = row / kk, k = row - ol * kk;
    for (int c = lane; c < n; c += 32)
      dst[v.at(t.o0 + ol, k, c)] = s[(ol * n + c) * kk + k];
  }
}

// ask for a tile's staged tensors (the caller commits the group)
__device__ __forceinline__ void request_tile(const Group& grp, int tile,
                                           float* buf, bool backward) {
  if (tile >= grp.blocks) return;
  const Layer& L = grp.layer[layer_of(grp, tile)];
  if (!L.staged) return;
  const Tile t = make_tile(L, tile, buf, nullptr);
  stage_in(t.sw, L.w, L.wv, t, L.kk, L.cin);
  if (L.mode != MODE_UAQ) stage_in(t.sa, L.alpha, L.av, t, L.kk, L.cq);
  if (backward) stage_in(t.sg, L.g, L.gv, t, L.kk, L.cin);
}

template <int V>
__device__ __forceinline__ void forward_rows(const Layer& L, const Tile& t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = L.lanes, gl = lane & (g - 1), rpw = 32 / g;
  const int rpi = WARPS * rpw;
  const int iters = (L.cpb * L.kk + rpi - 1) / rpi;
  const float qmax = (float)(L.levels - 1);
  const int kk = L.kk, cin = L.cin, cq = L.cq;
  for (int it = 0; it < iters; ++it) {
    const int lr = it * rpi + warp * rpw + lane / g;
    // lanes of a row past the end still take part in the shuffles
    const bool live = lr < t.nrows;
    const int ol = live ? lr / kk : 0, k = live ? lr - (lr / kk) * kk : 0;
    const int o = t.o0 + ol;
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = j * g + gl;
      float x = 0.f;
      if (live && c < cin)
        x = L.staged ? t.sw[(ol * cin + c) * kk + k] : L.w[L.wv.at(o, k, c)];
      v[j] = x;
    }
    if (L.hadamard) fwht<V>(v, gl, g, L.inv);
    const float d = live ? L.delta[(long long)o * L.dstride] : 1.f;
    const float z = live ? L.zp[(long long)o * L.dstride] : 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = j * g + gl;
      float a = 0.f;
      if (L.mode != MODE_UAQ && live && c < cq)
        a = L.staged ? t.sa[(ol * cq + c) * kk + k] : L.alpha[L.av.at(o, k, c)];
      const Quant r = quantize(v[j], d, z, a, qmax, L.mode);
      v[j] = __fmul_rn(r.q - z, d);
    }
    if (L.hadamard) fwht<V>(v, gl, g, L.inv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = j * g + gl;
      if (live && c < cin) {
        if (L.staged)
          t.sw[(ol * cin + c) * kk + k] = v[j];     // where it was read
        else
          L.out[((long long)o * cin + c) * kk + k] = v[j];
      }
    }
  }
}

template <int VMAX>
__device__ __forceinline__ void forward_tile(const Layer& L, const Tile& t) {
  switch (L.v) {
    case 1: forward_rows<1>(L, t); break;
    case 2: forward_rows<2>(L, t); break;
    case 4: forward_rows<4>(L, t); break;
    default:
      if constexpr (VMAX >= 32) {
        switch (L.v) {
          case 8: forward_rows<8>(L, t); break;
          case 16: forward_rows<16>(L, t); break;
          case 32: forward_rows<32>(L, t); break;
        }
      }
  }
  if (L.staged) {
    __syncthreads();
    stage_out(L.out, t.sw, oihw(L), t, L.kk, L.cin);
  }
}

template <int V>
__device__ __forceinline__ void backward_rows(const Layer& L, const Tile& t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = L.lanes, gl = lane & (g - 1), rpw = 32 / g;
  const int rpi = WARPS * rpw;
  const int iters = (L.cpb * L.kk + rpi - 1) / rpi;
  const float qmax = (float)(L.levels - 1);
  const int kk = L.kk, cin = L.cin, cq = L.cq, mode = L.mode;
  const bool uaq = mode == MODE_UAQ;
  const bool want_alpha = mode == MODE_ADA_SOFT && (L.need & NEED_ALPHA);
  const bool want_w = L.need & NEED_W;
  // the sums wanted: ddelta's two (0, 1), dzp's two (2, 3)
  const int sum_lo = (L.need & NEED_DELTA) ? 0 : 2;
  const int sum_hi = (L.need & NEED_ZP) ? 4 : 2;
  for (int it = 0; it < iters; ++it) {
    const int lr = it * rpi + warp * rpw + lane / g;
    const bool live = lr < t.nrows;
    const int ol = live ? lr / kk : 0, k = live ? lr - (lr / kk) * kk : 0;
    const int o = t.o0 + ol;
    float gq[V], x[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = j * g + gl;
      float gv = 0.f, xv = 0.f;
      if (live && c < cin) {
        const int s = (ol * cin + c) * kk + k;
        gv = L.staged ? t.sg[s] : L.g[L.gv.at(o, k, c)];
        xv = L.staged ? t.sw[s] : L.w[L.wv.at(o, k, c)];
      }
      gq[j] = gv;
      x[j] = xv;
    }
    if (L.hadamard) {
      fwht_t<V>(gq, gl, g, L.inv);
      fwht<V>(x, gl, g, L.inv);
    }
    const float d = live ? L.delta[(long long)o * L.dstride] : 1.f;
    const float z = live ? L.zp[(long long)o * L.dstride] : 0.f;
    // the row's four sums: ddelta through the dequantization and through
    // x / delta, dzp through the clip and through the dequantization
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = j * g + gl;
      const bool el = live && c < cq;
      float a = 0.f;
      if (!uaq && el)
        a = L.staged ? t.sa[(ol * cq + c) * kk + k] : L.alpha[L.av.at(o, k, c)];
      const Quant r = quantize(x[j], d, z, a, qmax, mode);
      const float G = gq[j];
      const float A = __fmul_rn(G, d);
      const float mA = r.m * A;                  // exact: m is 0, 1/2 or 1
      float dx = 0.f;
      if (el) {
        acc[0] += __fmul_rn(G, r.q - z);
        acc[2] += mA;
        acc[3] += -A;
        if (uaq) {
          acc[1] += __fmul_rn(-mA, r.t / d);     // (x / delta) / delta
          if (want_w) dx = mA / d;
        } else if (want_alpha) {
          const float da = __fmul_rn(
              __fmul_rn(__fmul_rn(mA * r.mh, 1.2f), 1.f - r.s), r.s);
          if (L.staged)
            t.sa[(ol * cq + c) * kk + k] = da;
          else
            L.dalpha[L.av.at(o, k, c)] = da;
        }
      }
      x[j] = dx;
    }
    if (want_w) {
      if (uaq && L.hadamard) fwht_t<V>(x, gl, g, L.inv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = j * g + gl;
        if (live && c < cin) {
          if (L.staged)
            t.sw[(ol * cin + c) * kk + k] = x[j];
          else
            L.dw[((long long)o * cin + c) * kk + k] = x[j];
        }
      }
    }
    if (sum_lo < sum_hi) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < sum_lo || i >= sum_hi) continue;
        for (int h = g >> 1; h >= 1; h >>= 1)
          acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], h);
      }
      if (live && gl == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) t.part[lr * 4 + i] = acc[i];
      }
    }
  }
}

template <int VMAX>
__device__ __forceinline__ void backward_tile(const Layer& L, const Tile& t) {
  const bool want_alpha = L.mode == MODE_ADA_SOFT && (L.need & NEED_ALPHA);
  switch (L.v) {
    case 1: backward_rows<1>(L, t); break;
    case 2: backward_rows<2>(L, t); break;
    case 4: backward_rows<4>(L, t); break;
    default:
      if constexpr (VMAX >= 32) {
        switch (L.v) {
          case 8: backward_rows<8>(L, t); break;
          case 16: backward_rows<16>(L, t); break;
          case 32: backward_rows<32>(L, t); break;
        }
      }
  }
  __syncthreads();
  // each channel's sums over its rows, in row order
  if ((L.need & (NEED_DELTA | NEED_ZP)) && (int)threadIdx.x < t.nch) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    const float* p = t.part + threadIdx.x * L.kk * 4;
    for (int k = 0; k < L.kk; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[i] += p[k * 4 + i];
    }
    const int o = t.o0 + threadIdx.x;
    if (L.need & NEED_DELTA) L.ddelta[o] = sum[0] + sum[1];
    if (L.need & NEED_ZP) L.dzp[o] = sum[2] + sum[3];
  }
  if (L.staged) {
    if (L.need & NEED_W) stage_out(L.dw, t.sw, oihw(L), t, L.kk, L.cin);
    // dalpha takes alpha's layout
    if (want_alpha) stage_out(L.dalpha, t.sa, L.av, t, L.kk, L.cq);
  }
}

// Persistent blocks with two tile buffers each: a block asks for its next
// tile's tensors (cp.async) before it computes the current one, so the
// loads of one tile overlap the butterflies of the other. The narrow
// instantiation (v <= 4) keeps MIN_BLOCKS blocks an SM; the wide one
// takes the registers its 32 values a lane need.
template <int VMAX, bool BACKWARD>
__global__ void __launch_bounds__(THREADS, VMAX <= 4 ? MIN_BLOCKS : 1)
    fq_kernel(const __grid_constant__ Group grp, int buf_floats) {
  extern __shared__ float smem[];
  float* part = smem + 2 * buf_floats;
  int cur = 0;
  request_tile(grp, blockIdx.x, smem, BACKWARD);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < grp.blocks; tile += gridDim.x) {
    request_tile(grp, tile + gridDim.x, smem + (cur ^ 1) * buf_floats,
               BACKWARD);
    cp_async_commit();
    cp_async_wait_one();          // this thread's copies of the tile landed
    __syncthreads();              // and every other thread's
    const Layer& L = grp.layer[layer_of(grp, tile)];
    const Tile t = make_tile(L, tile, smem + cur * buf_floats, part);
    if (BACKWARD)
      backward_tile<VMAX>(L, t);
    else
      forward_tile<VMAX>(L, t);
    __syncthreads();              // the buffer is free for the tile after
    cur ^= 1;
  }
}

// shared memory of one tile buffer (the rows' sums lie after both)
int tile_floats(const Layer& L, bool backward) {
  if (!L.staged) return 0;
  return L.cpb * L.kk *
         (L.cin * (backward ? 2 : 1) + (L.mode != MODE_UAQ ? L.cq : 0));
}

int check(const Group* grp, bool backward, int* buf_floats, int* vmax) {
  if (grp == nullptr || grp->n < 1 || grp->n > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  int blocks = 0, most = 0, widest = 1;
  for (int i = 0; i < grp->n; ++i) {
    const Layer& L = grp->layer[i];
    const int c = L.lanes * L.v;
    if (L.cout < 1 || L.kk < 1 || L.cin < 1 || L.levels < 2 ||
        L.mode < MODE_UAQ || L.mode > MODE_ADA_HARD ||
        (L.dstride != 0 && L.dstride != 1) || L.lanes < 1 || L.lanes > 32 ||
        (L.lanes & (L.lanes - 1)) || (L.v & (L.v - 1)) || c > MAX_C ||
        (L.v > 1 && L.lanes != 32) || L.cin > c || L.cq < L.cin ||
        L.cq > c || (L.hadamard && L.cq != c) || L.cpb < 1 ||
        L.cpb * L.kk > MAX_BLOCK_ROWS || L.block0 != blocks ||
        L.w == nullptr || L.delta == nullptr || L.zp == nullptr ||
        (L.mode != MODE_UAQ && L.alpha == nullptr) ||
        tile_floats(L, backward) > STAGE_FLOATS)
      return (int)cudaErrorInvalidValue;
    if (!backward && L.out == nullptr) return (int)cudaErrorInvalidValue;
    if (backward &&
        (L.g == nullptr || ((L.need & NEED_W) && L.dw == nullptr) ||
         ((L.need & NEED_DELTA) && L.ddelta == nullptr) ||
         ((L.need & NEED_ZP) && L.dzp == nullptr) ||
         ((L.need & NEED_ALPHA) &&
          (L.mode != MODE_ADA_SOFT || L.dalpha == nullptr))))
      return (int)cudaErrorInvalidValue;
    blocks += (L.cout + L.cpb - 1) / L.cpb;
    most = tile_floats(L, backward) > most ? tile_floats(L, backward) : most;
    widest = L.v > widest ? L.v : widest;
  }
  if (blocks != grp->blocks) return (int)cudaErrorInvalidValue;
  *buf_floats = most;
  *vmax = widest;
  return 0;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <bool BACKWARD>
int launch(const Group* grp, void* stream) {
  int buf = 0, vmax = 0;
  const int rc = check(grp, BACKWARD, &buf, &vmax);
  if (rc) return rc;
  const int sums = BACKWARD ? 4 * MAX_BLOCK_ROWS : 0;
  const size_t smem = (size_t)(2 * buf + sums) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const bool narrow = vmax <= 4;
  const int most = sm_count() * (narrow ? MIN_BLOCKS : 1);
  const int grid = grp->blocks < most ? grp->blocks : most;
  if (narrow)
    fq_kernel<4, BACKWARD><<<grid, THREADS, smem, s>>>(*grp, buf);
  else
    fq_kernel<32, BACKWARD><<<grid, THREADS, smem, s>>>(*grp, buf);
  return (int)cudaGetLastError();
}

}  // namespace

// The size of a Group, for the Python mirror's check.
extern "C" int nq_fq_group_bytes() { return (int)sizeof(Group); }

// Threads a block, for the Python tile map's check.
extern "C" int nq_fq_threads() { return THREADS; }

// One forward launch over the group's layers: each layer's out.
extern "C" int nq_fq_group_forward(const void* grp, void* stream) {
  return launch<false>(static_cast<const Group*>(grp), stream);
}

// One backward launch over the group's layers: each layer's dw, dalpha,
// and ddelta / dzp channel sums, as its `need` asks.
extern "C" int nq_fq_group_backward(const void* grp, void* stream) {
  return launch<true>(static_cast<const Group*>(grp), stream);
}
