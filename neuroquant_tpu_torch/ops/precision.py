"""The precision of the port's convs and matrix products: the counterpart
of ``jax.default_matmul_precision`` (``regress --matmul_precision``).

Inside ``matmul_precision("bfloat16")`` every product the port takes on an
fp32 activation runs on bf16 operands with fp32 sums, as an fp32 conv or
dot does on the TPU:

  * the convs and linears on cuDNN / cuBLAS (:func:`conv2d`,
    :func:`linear`, :func:`einsum`): operands cast to bf16, the product in
    bf16, the result cast to fp32, the bias added in fp32. The library
    rounds its result to bf16 before the cast, one rounding (at most 2^-9
    of the value) that the TPU's fp32 result does not have;
  * the fused tail and the fused prefix block: their weights are cast to
    bf16 (:func:`operand_dtype`), so they run the kernels' bf16
    instantiations, entered by one pack to bf16 and left in fp32, as the
    JAX ``_entry_and_cast`` does on the TPU.

Outside it, and on activations that are already bf16 (a model whose
parameters were cast, ``calibrate_network --compute_dtype bfloat16``),
nothing changes. On the CPU the JAX package ignores this precision and
computes fp32; the port applies its own definition on every device.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("default", "bfloat16")
_mode = "default"


@contextlib.contextmanager
def matmul_precision(mode: str):
    """Run the enclosed region's products at `mode`: "default" (fp32) or
    "bfloat16"."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"matmul precision {mode!r} (use "
                         f"{' or '.join(MODES)})")
    prev, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = prev


def bf16_products(x) -> bool:
    """Whether a product on `x` runs on bf16 operands: fp32 `x` inside
    ``matmul_precision("bfloat16")``."""
    return _mode == "bfloat16" and x.dtype == torch.float32


def operand_dtype(x):
    """The dtype of the kernels' operands for an activation `x`: bf16 where
    :func:`bf16_products`, else x's own."""
    return torch.bfloat16 if bf16_products(x) else x.dtype


def conv2d(x, weight, bias=None, stride=1, padding=0, groups=1):
    """``F.conv2d`` of NCHW `x`; under :func:`bf16_products` on bf16
    operands, the result in fp32 and the bias added after."""
    if not bf16_products(x):
        return F.conv2d(x, weight, bias, stride, padding, groups=groups)
    y = F.conv2d(x.to(torch.bfloat16), weight.to(torch.bfloat16), None,
                 stride, padding, groups=groups).float()
    return y if bias is None else y + bias.reshape(-1, 1, 1)


def linear(x, weight, bias=None):
    """``F.linear``; under :func:`bf16_products` on bf16 operands, the
    result in fp32 and the bias added after."""
    if not bf16_products(x):
        return F.linear(x, weight, bias)
    y = F.linear(x.to(torch.bfloat16), weight.to(torch.bfloat16)).float()
    return y if bias is None else y + bias


def einsum(spec: str, a, b):
    """``torch.einsum`` of two operands; under :func:`bf16_products` (of
    `b`) on bf16 operands, the result in fp32."""
    if not bf16_products(b):
        return torch.einsum(spec, a, b)
    return torch.einsum(spec, a.to(torch.bfloat16),
                        b.to(torch.bfloat16)).float()
