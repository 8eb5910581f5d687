"""Fake-quantization as a transform of a state dict (the counterpart of
``neuroquant_tpu/quantization/qmodel.py``):

    state = init_quant_state(model.state_dict(), spec)
    model.load_state_dict(quantize_params(model.state_dict(), spec, state))

``quantize_params`` is differentiable in the state: calibration marks the
deltas (phase 1) or the AdaRound alphas (phase 2) as requiring gradients
and runs the decoder on the result. A state that requires none, as
evaluation's, builds no graph.

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
from neuroquant_tpu_torch.ops.fused_fakequant import (
    fake_quant_group, fake_quant_ref)
from neuroquant_tpu_torch.ops.hadamard import fwht, pad_cin_to_pow2
from neuroquant_tpu_torch.quantization.spec import QuantSpec


def _get(params, pre):
    """(HWIO kernel, bias) of the layer at state-dict prefix `pre`
    (``QuantSpec.layer_keys``)."""
    return params[f"{pre}.weight"].permute(2, 3, 1, 0), params[f"{pre}.bias"]


def _set(params, pre, kernel_hwio, bias):
    """A shallow copy of the state dict with the layer replaced."""
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
    for name, pre, bits in zip(spec.layer_names, spec.layer_keys,
                                spec.n_bits):
        w, b = _get(params, pre)
        w_dom = _hadamard_weight(w) if spec.hadamard else w
        wd, wz = Q.init_weight_scale(w_dom, bits, spec.channel_wise,
                                     spec.scale_method, spec.sym)
        bd, bz = Q.init_bias_scale(b, bits, spec.scale_method, spec.sym)
        state[name] = {"w_delta": wd, "w_zp": wz, "b_delta": bd, "b_zp": bz}
    return state


def _fq_bias(b, s, bits: int, mode: str, soft: bool):
    if mode == "uaq":
        return Q.uaq_fake_quant(b, s["b_delta"], s["b_zp"], bits)
    return Q.adaround_fake_quant(b, s["b_delta"], s["b_zp"], s["b_alpha"],
                                 bits, soft=soft)


def quantize_params(params, spec: QuantSpec, state: Dict, mode: str = "uaq",
                    soft: bool = True, upto: int | None = None):
    """A state dict with fake-quantized kernels and biases for every spec
    layer, or with `upto` for layers 0..upto only (the reference's
    ``quantize_model_till``: the unit-scope calibration's fisher gradients
    and QDrop inputs). Under mode='adaround' a layer without alphas is
    nearest-rounded: the mixed-rounding state. Under ``spec.fq_impl ==
    'pallas'`` the weights of the layers go through one grouped kernel call
    (``fake_quant_group``: one launch forward, one backward); the biases
    take the plain chain under both impls, as in the JAX package."""
    if mode not in ("uaq", "adaround"):
        raise ValueError(mode)
    layers = []
    for i, (name, pre, bits) in enumerate(zip(
            spec.layer_names, spec.layer_keys, spec.n_bits)):
        if upto is not None and i > upto:
            break
        w, b = _get(params, pre)
        s = state[name]
        lmode = mode if (mode != "adaround" or "w_alpha" in s) else "uaq"
        layers.append((pre, w, b, s, bits, lmode,
                       s["w_alpha"] if lmode == "adaround" else None))
    if spec.fq_impl == "pallas":
        kernels = fake_quant_group(
            [(w, s["w_delta"], s["w_zp"], alpha, bits, soft)
             for _, w, _, s, bits, _, alpha in layers], spec.hadamard)
    else:
        kernels = [fake_quant_ref(w, s["w_delta"], s["w_zp"], alpha, bits,
                                  spec.hadamard, soft)
                   for _, w, _, s, bits, _, alpha in layers]
    out = params
    for (pre, _, b, s, bits, lmode, _), kernel in zip(layers, kernels):
        out = _set(out, pre, kernel, _fq_bias(b, s, bits, lmode, soft))
    return out


@torch.no_grad()
def adaround_upgrade(params, spec: QuantSpec, state: Dict,
                     only: tuple | None = None) -> Dict:
    """AdaRound's hand-off: deltas and zero points cast through f16 and
    per-element alphas that reproduce the current rounding residues (in the
    Hadamard domain when ``spec.hadamard``). ``only``: the layer names to
    upgrade; the rest keep their UAQ state (mixed rounding)."""
    new_state = {}
    for name, pre in zip(spec.layer_names, spec.layer_keys):
        s = state[name]
        if only is not None and name not in only:
            new_state[name] = {k: v.detach() for k, v in s.items()}
            continue
        w, b = _get(params, pre)
        w_dom = _hadamard_weight(w) if spec.hadamard else w
        wd, wz = Q.f16_round_delta(s["w_delta"]), Q.f16_round(s["w_zp"])
        bd, bz = Q.f16_round_delta(s["b_delta"]), Q.f16_round(s["b_zp"])
        new_state[name] = {
            "w_delta": wd, "w_zp": wz, "b_delta": bd, "b_zp": bz,
            "w_alpha": Q.adaround_init_alpha(w_dom, wd),
            "b_alpha": Q.adaround_init_alpha(b, bd),
        }
    return new_state


@torch.no_grad()
def get_perturbation(params, spec: QuantSpec, state: Dict):
    """Per-layer delta_w = w - UAQ(w) (HWIO) for the Omega criterion.

    Keeps the reference's quirk: the raw-domain weight is quantized with
    the current scales even when those scales were initialized in the
    Hadamard domain."""
    out = []
    for name, pre, bits in zip(spec.layer_names, spec.layer_keys,
                                spec.n_bits):
        w, _ = _get(params, pre)
        s = state[name]
        out.append(w - Q.uaq_fake_quant(w, s["w_delta"], s["w_zp"], bits))
    return out


def average_bits(params, spec: QuantSpec) -> float:
    """Parameter-weighted average bit width over the quantized layers."""
    bits_total, n_total = 0.0, 0.0
    for pre, bits in zip(spec.layer_keys, spec.n_bits):
        w, b = _get(params, pre)
        bits_total += bits * (w.numel() + b.numel())
        n_total += w.numel() + b.numel()
    return bits_total / n_total


@torch.no_grad()
def _int_code_arrays(params, spec: QuantSpec, state: Dict, mode: str):
    """Every layer's (weight codes, bias codes), int32; weight codes in the
    quantization domain."""
    arrays = {}
    for name, pre, bits in zip(spec.layer_names, spec.layer_keys,
                                spec.n_bits):
        w, b = _get(params, pre)
        w_dom = _hadamard_weight(w) if spec.hadamard else w
        s = state[name]
        if mode == "uaq" or "w_alpha" not in s:
            wc = Q.uaq_int_codes(w_dom, s["w_delta"], s["w_zp"], bits)
            bc = Q.uaq_int_codes(b, s["b_delta"], s["b_zp"], bits)
        else:
            wc = Q.adaround_int_codes(w_dom, s["w_delta"], s["w_zp"],
                                      s["w_alpha"], bits)
            bc = Q.adaround_int_codes(b, s["b_delta"], s["b_zp"],
                                      s["b_alpha"], bits)
        arrays[name] = (wc, bc)
    return arrays


def collect_int_codes(params, spec: QuantSpec, state: Dict,
                      mode: str = "adaround"):
    """Per-layer integer codes with their scales, what the entropy coder
    and ``eval_quantized.params_from_codes`` consume."""
    arrays = _int_code_arrays(params, spec, state, mode)
    codes = {}
    for name, bits in zip(spec.layer_names, spec.n_bits):
        wc, bc = arrays[name]
        s = state[name]
        codes[name] = {"w": wc, "b": bc,
                       "w_delta": s["w_delta"].detach(),
                       "w_zp": s["w_zp"].detach(),
                       "b_delta": s["b_delta"].detach(),
                       "b_zp": s["b_zp"].detach(), "bits": bits}
    return codes


def round_loss(state: Dict, spec: QuantSpec, b, weight: float):
    """AdaRound regularizer over the weight alphas: weight * sum over the
    layers that have alphas of sum(1 - |2h(alpha) - 1|^b)."""
    total = 0.0
    for name in spec.layer_names:
        if "w_alpha" in state[name]:
            total = total + Q.adaround_reg(state[name]["w_alpha"], b)
    return weight * total
