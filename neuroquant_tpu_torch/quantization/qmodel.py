"""Fake-quantization as a transform of a state dict (the forward part of
``neuroquant_tpu/quantization/qmodel.py``):

    state = init_quant_state(model.state_dict(), spec)
    model.load_state_dict(quantize_params(model.state_dict(), spec, state))

The math runs on HWIO views of the OIHW weights, so the QuantState keeps
the JAX package's shapes (w_delta (1, 1, 1, C_out) channel-wise, 0-d per
layer) and a JAX-written artifact's state applies unchanged. With
``spec.hadamard`` weights are quantized in the normalized Walsh-Hadamard
domain along C_in, zero-padded to a power of two.
"""

from __future__ import annotations

from typing import Dict

import torch

from neuroquant_tpu_torch.ops import quant as Q
from neuroquant_tpu_torch.ops.hadamard import fwht, pad_cin_to_pow2
from neuroquant_tpu_torch.quantization.spec import QuantSpec
from neuroquant_tpu_torch.utils.convert import layer_prefix


def _get(params, path):
    """(HWIO kernel, bias) of the layer at a flax path in a state dict."""
    pre = layer_prefix(path)
    return params[f"{pre}.weight"].permute(2, 3, 1, 0), params[f"{pre}.bias"]


def _set(params, path, kernel_hwio, bias):
    """A shallow copy of the state dict with the layer replaced."""
    pre = layer_prefix(path)
    out = dict(params)
    out[f"{pre}.weight"] = kernel_hwio.permute(3, 2, 0, 1).contiguous()
    out[f"{pre}.bias"] = bias
    return out


def _hadamard_weight(w_hwio):
    return fwht(pad_cin_to_pow2(w_hwio), axis=2)


@torch.no_grad()
def init_quant_state(params, spec: QuantSpec) -> Dict:
    """Per-layer scale init: {name: {w_delta, w_zp, b_delta, b_zp}}."""
    state = {}
    for name, path, bits in zip(spec.layer_names, spec.layer_paths,
                                spec.n_bits):
        w, b = _get(params, path)
        w_dom = _hadamard_weight(w) if spec.hadamard else w
        wd, wz = Q.init_weight_scale(w_dom, bits, spec.channel_wise,
                                     spec.scale_method, spec.sym)
        bd, bz = Q.init_bias_scale(b, bits, spec.scale_method, spec.sym)
        state[name] = {"w_delta": wd, "w_zp": wz, "b_delta": bd, "b_zp": bz}
    return state


def _fq_weight(w, s, bits: int, hadamard: bool, mode: str, soft: bool):
    cin = w.shape[2]
    x = _hadamard_weight(w) if hadamard else w
    if mode == "uaq":
        xq = Q.uaq_fake_quant(x, s["w_delta"], s["w_zp"], bits)
    elif mode == "adaround":
        xq = Q.adaround_fake_quant(x, s["w_delta"], s["w_zp"], s["w_alpha"],
                                   bits, soft=soft)
    else:
        raise ValueError(mode)
    if hadamard:
        xq = fwht(xq, axis=2)[:, :, :cin, :]     # self-inverse; crop the pad
    return xq


def _fq_bias(b, s, bits: int, mode: str, soft: bool):
    if mode == "uaq":
        return Q.uaq_fake_quant(b, s["b_delta"], s["b_zp"], bits)
    return Q.adaround_fake_quant(b, s["b_delta"], s["b_zp"], s["b_alpha"],
                                 bits, soft=soft)


@torch.no_grad()
def quantize_params(params, spec: QuantSpec, state: Dict, mode: str = "uaq",
                    soft: bool = True):
    """A state dict with fake-quantized kernels and biases for every spec
    layer. Under mode='adaround' a layer without alphas is nearest-rounded:
    the mixed-rounding state."""
    out = params
    for name, path, bits in zip(spec.layer_names, spec.layer_paths,
                                spec.n_bits):
        w, b = _get(params, path)
        s = state[name]
        lmode = mode if (mode != "adaround" or "w_alpha" in s) else "uaq"
        out = _set(out, path,
                   _fq_weight(w, s, bits, spec.hadamard, lmode, soft),
                   _fq_bias(b, s, bits, lmode, soft))
    return out

