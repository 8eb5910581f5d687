"""Fake-quantization math: straight-through rounding, uniform affine
quantizers, scale initialization and AdaRound, as plain functions on
tensors (the counterpart of ``neuroquant_tpu/ops/quant.py``), and the
FFNeRV and HiNeRV quantization-aware-training quantizers. The per-channel
scale search runs batched over rows where the JAX version vmaps over
C_out.

Gradients follow JAX's autodiff of the same expressions: rounding passes
the gradient straight through, and a clip passes half of it at a value
exactly on a bound (``jnp.clip`` is a max and a min, which split a tie),
where ``torch.clamp`` would pass all of it. Quantized values sit on the
bounds often (the extreme weights under max scales), so the phase-1 scale
gradients depend on it.
"""

from __future__ import annotations

import torch

GAMMA, ZETA = -0.1, 1.1      # AdaRound rectified-sigmoid constants
EPS = 1e-8


def round_ste(x):
    """Round to nearest even, with the gradient passed straight through."""
    return x + (torch.round(x) - x).detach()


def floor_ste(x):
    return x + (torch.floor(x) - x).detach()


def _clip(x, lo: float, hi: float):
    """``jnp.clip``: clamp's values, half the gradient on a bound."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))

# A range divides into 2^b - 1 steps as a multiply by the fp32 reciprocal:
# the jitted JAX scale init computes it so (XLA turns a division by a
# constant into one), and a zero point that lands on x.5 rounds on that
# last bit.


def _step(span, n_bits: int):
    return torch.clamp(span * (1.0 / (2 ** n_bits - 1)), min=EPS)


def uaq_fake_quant(x, delta, zero_point, n_bits: int):
    """Asymmetric uniform affine fake-quant. The gradient reaches x through
    the straight-through round and delta through both the scaling and the
    dequantization."""
    x_int = round_ste(x / delta) + zero_point
    x_quant = _clip(x_int, 0.0, 2.0 ** n_bits - 1)
    return (x_quant - zero_point) * delta


def uaq_int_codes(x, delta, zero_point, n_bits: int):
    """Integer codes (what the entropy coder consumes)."""
    x_int = torch.round(x / delta) + zero_point
    return torch.clamp(x_int, 0, 2 ** n_bits - 1).to(torch.int32)


def _quantize_with_range(x, new_max, new_min, n_bits: int):
    """Candidate quantization used by the mse/l1/l2 searches."""
    delta = _step(new_max - new_min, n_bits)
    zp = torch.round(-new_min / delta)
    x_quant = torch.clamp(torch.round(x / delta) + zp, 0, 2 ** n_bits - 1)
    return (x_quant - zp) * delta


def _range_to_scale(x_min, x_max, n_bits: int, sym: bool):
    if sym:
        x_absmax = torch.maximum(x_min.abs(), x_max)
        x_min = torch.where(x_min < 0, -x_absmax, torch.zeros_like(x_min))
        x_max = x_absmax
    delta = _step(x_max - x_min, n_bits)
    return delta, torch.round(-x_min / delta)


def _init_scale_rows(x, n_bits: int, method: str, sym: bool):
    """Scale/zero-point for each row of a (R, N) tensor: (R,), (R,)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if "max" in method:
        x_min = torch.minimum(x.amin(dim=-1), zero)
        x_max = torch.maximum(x.amax(dim=-1), zero)
        return _range_to_scale(x_min, x_max, n_bits, sym)
    if method == "gaussian":
        mu = x.mean(dim=-1)
        # quirk kept from the reference: the variance, not the standard
        # deviation, sets the +-6 range (population variance, as jnp.var)
        sigma = x.var(dim=-1, unbiased=False)
        x_min = torch.minimum(mu - 6 * sigma, zero)
        x_max = torch.maximum(mu + 6 * sigma, zero)
        return _range_to_scale(x_min, x_max, n_bits, sym)
    if method in ("mse", "l1", "l2"):
        x_max, x_min = x.amax(dim=-1), x.amin(dim=-1)
        shrink = 1.0 - 0.05 * torch.arange(10, dtype=x.dtype, device=x.device)
        cand_max = x_max[:, None] * shrink                      # (R, 10)
        cand_min = x_min[:, None] * shrink
        xq = _quantize_with_range(x[:, None, :], cand_max[..., None],
                                  cand_min[..., None], n_bits)  # (R, 10, N)
        err = x[:, None, :] - xq
        if method == "mse":
            scores = (err.abs() ** 3.5).mean(dim=-1)
        elif method == "l2":
            scores = (err ** 2).mean(dim=-1)
        else:
            scores = err.abs().mean(dim=-1)
        best = torch.argmin(scores, dim=-1, keepdim=True)
        nmax = cand_max.gather(1, best)[:, 0]
        nmin = cand_min.gather(1, best)[:, 0]
        delta = _step(nmax - nmin, n_bits)
        return delta, torch.round(-nmin / delta)
    raise NotImplementedError(f"scale method {method!r}")


def _init_scale_flat(x, n_bits: int, method: str, sym: bool):
    """Scale/zero-point (0-d tensors) for one flat quantization group."""
    delta, zp = _init_scale_rows(x.reshape(1, -1), n_bits, method, sym)
    return delta[0], zp[0]


def init_weight_scale(w_hwio, n_bits: int, channel_wise: bool, method: str,
                      sym: bool = False):
    """Scale init for an HWIO conv weight: (delta, zp) of shape
    (1, 1, 1, C_out) when channel_wise, else 0-d."""
    if channel_wise:
        cout = w_hwio.shape[-1]
        per_ch = w_hwio.reshape(-1, cout).T               # (C_out, KH*KW*C_in)
        delta, zp = _init_scale_rows(per_ch, n_bits, method, sym)
        return delta.reshape(1, 1, 1, cout), zp.reshape(1, 1, 1, cout)
    return _init_scale_flat(w_hwio, n_bits, method, sym)


def init_bias_scale(b, n_bits: int, method: str, sym: bool = False):
    """A bias always gets a single scale, even channel_wise."""
    return _init_scale_flat(b, n_bits, method, sym)


def f16_round(x):
    """float32 -> float16 -> float32, the reference's ``.half().float()`` on
    delta/zero_point at the AdaRound hand-off."""
    return x.to(torch.float16).to(torch.float32)


F16_TINY = 2.0 ** -24   # the smallest positive float16 (a subnormal)


def f16_round_delta(delta):
    """:func:`f16_round` of a scale AdaRound divides by: a delta that float16
    rounds to zero (|delta| < 2^-25, phase 1's Adam having walked it across
    zero) keeps its sign at F16_TINY instead, so the alphas' init stays
    finite. The JAX package divides by the zero and its artifact guard
    refuses the run."""
    r = f16_round(delta)
    return torch.where(r == 0, torch.copysign(torch.full_like(r, F16_TINY),
                                              delta), r)


def adaround_init_alpha(x, delta):
    """alpha such that h(alpha) == x/delta - floor(x/delta)."""
    rest = x / delta - torch.floor(x / delta)
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


def adaround_soft_targets(alpha):
    """h(alpha) = clip(sigmoid(alpha)*(zeta-gamma)+gamma, 0, 1)."""
    return _clip(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def adaround_fake_quant(x, delta, zero_point, alpha, n_bits: int,
                        soft: bool = True):
    """AdaRound: floor(x/delta) + h(alpha) (soft) or + [alpha >= 0]. The
    floor passes no gradient; alpha gets it through h, delta through the
    dequantization."""
    x_floor = torch.floor(x / delta)
    if soft:
        x_int = x_floor + adaround_soft_targets(alpha)
    else:
        x_int = x_floor + (alpha >= 0).to(x.dtype)
    x_quant = _clip(x_int + zero_point, 0.0, 2.0 ** n_bits - 1)
    return (x_quant - zero_point) * delta


def adaround_int_codes(x, delta, zero_point, alpha, n_bits: int):
    """Hard-rounded integer codes."""
    x_int = torch.floor(x / delta) + (alpha >= 0).to(x.dtype)
    return torch.clamp(x_int + zero_point, 0, 2 ** n_bits - 1).to(torch.int32)


def adaround_reg(alpha, b):
    """Rounding regularizer sum(1 - |2h(alpha) - 1|^b)."""
    h = adaround_soft_targets(alpha)
    return (1.0 - torch.abs(2.0 * h - 1.0) ** b).sum()


# --------------------------------------------------------------------------
# QAT quantizers: the FFNeRV and HiNeRV baselines of stage 1's --qat_mode
# --------------------------------------------------------------------------
def qfn_ste(x, bit: int):
    """FFNeRV's quantizer: sign-preserving floor-quantize of |x| to
    2^(bit-1) - 1 levels, the gradient passed straight through."""
    n = float(2 ** (bit - 1) - 1)
    out = torch.floor(torch.abs(x) * n) / n * torch.sign(x)
    return x + (out - x).detach()


def quantize_ste_sym(x, n_bits: int, axis=0):
    """HiNeRV's symmetric quantizer with one scale per slice along `axis`
    (None: one for the tensor): (integer values, scale)."""
    quant_range = 2.0 ** n_bits - 1.0
    if axis is None:
        x_max = torch.abs(x).amax()
    else:
        x_max = torch.abs(x).amax(dim=axis, keepdim=True)
    x_scale = 2 * x_max / quant_range + 1e-6
    x_q = _clip(round_ste(x / x_scale), -2.0 ** (n_bits - 1),
                2.0 ** (n_bits - 1) - 1)
    return x_q, x_scale


def qat_mask(shape, generator=None, device=None):
    """HiNeRV's training mask: 1 where a uniform draw exceeds 0.9, the
    weights that stay unquantized this step (the JAX package draws it from
    ``jax.random.uniform``)."""
    u = torch.rand(shape, generator=generator, device=device)
    return (u > 0.9).to(torch.float32)


def qat_fake_quant(x, n_bits: int, mode: str, generator=None,
                   training: bool = True):
    """The QAT quantizer's forward on a weight in the JAX package's HWIO
    layout (HiNeRV's scale is per slice of axis 0, the kernel rows).
    'ffnerv': qfn_ste(tanh(x)); 'hinerv': the dequantized weight, and in
    training a random tenth of the weights left as they are, the mask
    drawn by :func:`qat_mask` from `generator`."""
    if mode == "ffnerv":
        return qfn_ste(torch.tanh(x), n_bits)
    if mode == "hinerv":
        x_q, x_scale = quantize_ste_sym(x, n_bits)
        x_qr = x_q.detach() * x_scale
        if training:
            mask = qat_mask(tuple(x.shape), generator,
                            x.device).to(x.dtype)
            return x * mask + x_qr * (1.0 - mask)
        return x_qr
    raise ValueError(f"Wrong rounding mode {mode!r}")
