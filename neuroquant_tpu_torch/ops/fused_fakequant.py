"""Fused Hadamard-domain fake-quantization of conv weights on a CUDA kernel
(the counterpart of ``neuroquant_tpu/ops/pallas_fakequant.py``).

The calibration and evaluation paths quantize a weight as FWHT over C_in ->
uniform affine (or AdaRound) fake-quant -> inverse FWHT. The plain chain
(:func:`fake_quant_ref`, what ``quantization/qmodel.py`` runs under
``fq_impl='jnp'``) takes log2(C) butterfly stages of small tensor
operations, twice per layer; ``csrc/fq_hadamard.cu`` does the whole chain in
one launch per layer, with the transform as a butterfly in registers.

:func:`fused_fake_quant_hwio` is forward only. On a CUDA tensor it launches
the kernel or raises; on a CPU tensor it runs the plain version. The kernel
reads the weight and the alphas where they lie (any HWIO view whose two
kernel axes share one stride, as the HWIO view of an OIHW parameter) and
writes an OIHW tensor, returned as its HWIO view: no transpose, pad or crop
around it.

:func:`uaq_fake_quant` and :func:`ada_fake_quant` are differentiable: kernel
forward, and a backward that is the VJP of the plain version recomputed from
the saved inputs, as the JAX package's ``pallas_uaq_fake_quant`` and
``pallas_ada_fake_quant``. The gradients are the plain chain's by
construction: straight-through rounding, half the gradient on a clip bound,
none through ``floor``. Select them with ``QuantSpec(fq_impl='pallas')`` or
``calibrate_network --fq_impl pallas`` (the value keeps the JAX package's
name and selects the CUDA kernel).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from neuroquant_tpu_torch.ops import _cuda
from neuroquant_tpu_torch.ops import quant as Q
from neuroquant_tpu_torch.ops.hadamard import (
    fwht, next_power_of_two, pad_cin_to_pow2)
from neuroquant_tpu_torch.ops.tail_fused import _launch, _route

MAX_C = 1024     # the kernel's widest padded C_in: 32 registers per lane


def fake_quant_ref(w, delta, zp, alpha, n_bits: int, hadamard: bool,
                   soft: bool = True):
    """The plain chain on an HWIO weight (the JAX ``_jnp_reference``); UAQ
    when ``alpha`` is None, else AdaRound."""
    cin = w.shape[2]
    x = fwht(pad_cin_to_pow2(w), axis=2) if hadamard else w
    if alpha is None:
        xq = Q.uaq_fake_quant(x, delta, zp, n_bits)
    else:
        xq = Q.adaround_fake_quant(x, delta, zp, alpha, n_bits, soft=soft)
    if hadamard:
        xq = fwht(xq, axis=2)[:, :, :cin, :]     # self-inverse; crop the pad
    return xq


@lru_cache(maxsize=None)
def _inv_sqrt(n: int) -> float:
    """The fp32 reciprocal of sqrt(n), as ops/hadamard.fwht multiplies by."""
    return float(1.0 / torch.sqrt(torch.tensor(float(n))))


def _row_strides(t):
    """(so, sk, sc) element strides of an HWIO tensor over (C_out, the
    flattened kernel position ky * KW + kx, C_in), or None when the two
    kernel axes do not share one stride."""
    kh, kw = t.shape[:2]
    s0, s1, sc, so = t.stride()
    if kh == 1 or s0 == kw * s1:
        sk = s1
    elif kw == 1:
        sk = s0
    else:
        return None
    return so, sk, sc


def _strided(t):
    strides = _row_strides(t)
    if strides is None:
        t = t.contiguous()
        strides = _row_strides(t)
    return t, strides


def _scale_rows(s, cout: int, name: str, like):
    """A delta or zero point as a flat fp32 tensor of C_out values (stride
    1) or one (stride 0)."""
    if s.device != like.device or s.dtype != torch.float32:
        raise ValueError(f"fused_fake_quant {name}: expected fp32 on "
                         f"{like.device}, got {s.dtype} on {s.device}")
    if s.numel() not in (1, cout):
        raise ValueError(f"fused_fake_quant {name}: {s.numel()} values for "
                         f"{cout} output channels")
    return s.reshape(-1).contiguous(), int(s.numel() != 1)


def fused_fake_quant_hwio(w_hwio, delta, zp, n_bits: int,
                          hadamard: bool = True, alpha=None,
                          soft: bool = True):
    """Fused (FWHT ->) fake-quant (-> inverse FWHT) of an HWIO conv weight,
    forward only.

    delta/zp: per channel (1, 1, 1, C_out) or 0-d; alpha (AdaRound): the
    quantization-domain tensor (KH, KW, C_in padded, C_out), or None for
    UAQ. The same values as :func:`fake_quant_ref`."""
    if not _route(w_hwio, "fused_fake_quant"):
        return fake_quant_ref(w_hwio, delta, zp, alpha, n_bits, hadamard,
                              soft)
    if w_hwio.dim() != 4 or w_hwio.dtype != torch.float32:
        raise ValueError("fused_fake_quant w: expected a 4-D fp32 HWIO "
                         f"weight, got {tuple(w_hwio.shape)} {w_hwio.dtype}")
    kh, kw, cin, cout = w_hwio.shape
    cpad = next_power_of_two(cin) if hadamard else cin
    if hadamard and cpad > MAX_C:
        raise ValueError(f"fused_fake_quant: C_in {cin} pads to {cpad}; the "
                         f"kernel transforms at most {MAX_C} channels")
    d, dstride = _scale_rows(delta, cout, "delta", w_hwio)
    z, zstride = _scale_rows(zp, cout, "zp", w_hwio)
    if dstride != zstride:
        raise ValueError("fused_fake_quant: delta and zp differ in shape")
    w, (xso, xsk, xsc) = _strided(w_hwio.detach())
    out = torch.empty((cout, cin, kh, kw), dtype=torch.float32,
                      device=w.device)
    kk = kh * kw
    inv = _inv_sqrt(cpad)
    tail = (d.data_ptr(), z.data_ptr(), dstride, out.data_ptr(), cin * kk, 1,
            kk, cout, kk, cin, cpad, 2 ** n_bits, int(hadamard))
    if alpha is None:
        _launch("fq_uaq", _cuda.lib().nq_fq_uaq, w.data_ptr(), xso, xsk, xsc,
                *tail, inv)
    else:
        if (tuple(alpha.shape) != (kh, kw, cpad, cout)
                or alpha.dtype != torch.float32
                or alpha.device != w.device):
            raise ValueError(
                f"fused_fake_quant alpha: expected fp32 {(kh, kw, cpad, cout)}"
                f" on {w.device}, got {alpha.dtype} {tuple(alpha.shape)} on "
                f"{alpha.device}")
        a, (aso, ask, asc) = _strided(alpha.detach())
        _launch("fq_ada", _cuda.lib().nq_fq_ada, w.data_ptr(), xso, xsk, xsc,
                a.data_ptr(), aso, ask, asc, *tail, int(soft), inv)
    return out.permute(2, 3, 1, 0)


def _ref_vjp(ctx, g, tensors, fn):
    """Gradients of the plain version `fn` at the saved `tensors` for the
    inputs that need one, None for the rest."""
    need = ctx.needs_input_grad[:len(tensors)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(tensors, need)]
        out = fn(*leaves)
        wanted = [t for t, n in zip(leaves, need) if n]
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
    return [next(grads) if n else None for n in need]


class _UAQFakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, delta, zp, n_bits, hadamard):
        ctx.save_for_backward(w, delta, zp)
        ctx.cfg = (n_bits, hadamard)
        return fused_fake_quant_hwio(w, delta, zp, n_bits, hadamard)

    @staticmethod
    def backward(ctx, g):
        n_bits, hadamard = ctx.cfg
        grads = _ref_vjp(
            ctx, g, ctx.saved_tensors,
            lambda w, d, z: fake_quant_ref(w, d, z, None, n_bits, hadamard))
        return (*grads, None, None)


class _AdaFakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, delta, zp, alpha, n_bits, hadamard, soft):
        ctx.save_for_backward(w, delta, zp, alpha)
        ctx.cfg = (n_bits, hadamard, soft)
        return fused_fake_quant_hwio(w, delta, zp, n_bits, hadamard, alpha,
                                     soft)

    @staticmethod
    def backward(ctx, g):
        n_bits, hadamard, soft = ctx.cfg
        grads = _ref_vjp(
            ctx, g, ctx.saved_tensors,
            lambda w, d, z, a: fake_quant_ref(w, d, z, a, n_bits, hadamard,
                                              soft))
        return (*grads, None, None, None)


def uaq_fake_quant(w, delta, zp, n_bits: int, hadamard: bool):
    """UAQ fake-quant of an HWIO weight: fused forward, the plain chain's
    straight-through gradients (the JAX ``pallas_uaq_fake_quant``)."""
    return _UAQFakeQuant.apply(w, delta, zp, n_bits, hadamard)


def ada_fake_quant(w, delta, zp, alpha, n_bits: int, hadamard: bool,
                   soft: bool):
    """AdaRound fake-quant: fused forward; alpha gets the rectified
    sigmoid's gradient, w none through the floor (the JAX
    ``pallas_ada_fake_quant``)."""
    return _AdaFakeQuant.apply(w, delta, zp, alpha, n_bits, hadamard, soft)
