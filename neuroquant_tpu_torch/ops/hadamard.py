"""Normalized fast Walsh-Hadamard transform (FWHT) over the input-channel
axis of HWIO weights, the quantization domain of ``spec.hadamard``.

The butterfly stages run in the same order as ``neuroquant_tpu/ops/
hadamard.py``, so the two packages agree to the last bit on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def next_power_of_two(n: int) -> int:
    return 1 if n == 0 else 2 ** math.ceil(math.log2(n))


def fwht(x: torch.Tensor, axis: int = -1, normalize: bool = True):
    """Normalized FWHT along `axis` (length a power of two); self-inverse."""
    n = x.shape[axis]
    assert n & (n - 1) == 0, f"FWHT length must be a power of two, got {n}"
    x = torch.movedim(x, axis, -1)
    lead = x.shape[:-1]
    for s in range(n.bit_length() - 1):
        half = 1 << s
        x = x.reshape(*lead, n // (2 * half), 2, half)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(*lead, n)
    if normalize:
        # times the fp32 reciprocal of sqrt(n), as the jitted JAX transform
        # computes it
        x = x * (1.0 / torch.sqrt(torch.tensor(float(n), dtype=x.dtype)))
    return torch.movedim(x, -1, axis)


def pad_cin_to_pow2(w_hwio: torch.Tensor) -> torch.Tensor:
    """Zero-pad the C_in axis of an HWIO weight to the next power of two."""
    p = next_power_of_two(w_hwio.shape[2]) - w_hwio.shape[2]
    if p == 0:
        return w_hwio
    return F.pad(w_hwio, (0, 0, 0, p))
