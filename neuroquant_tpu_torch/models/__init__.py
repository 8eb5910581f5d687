"""Model registry, parameter accounting and quantization layout for NeRV,
HNeRV, PNeRV1 and PNeRV2 (``pnerv`` is PNeRV1).

`quant_layer_paths(arch)` pins the traversal order of the quantizable conv
layers, the order `--precision` lists are read in; the paths are the JAX
package's flax paths, as the quantized artifact stores them
(``utils.convert.layer_prefix`` maps each to its state-dict prefix).
"""

from __future__ import annotations

import numpy as np
import torch

from neuroquant_tpu_torch.models.hnerv import HNeRV, HNeRVConfig
from neuroquant_tpu_torch.models.nerv import NeRV, NeRVConfig
from neuroquant_tpu_torch.models.pnerv import (
    PNeRV, PNeRV1, PNeRV2, PNeRVConfig, pnerv_tail_packed)
from neuroquant_tpu_torch.utils.device import resolve_device

__all__ = ["HNeRV", "HNeRVConfig", "NeRV", "NeRVConfig", "PNeRV", "PNeRV1",
           "PNeRV2", "PNeRVConfig", "build_model", "quant_layer_paths",
           "param_counts", "example_input", "tail_plan_for"]

_MODELS = {"hnerv": (HNeRV, HNeRVConfig), "nerv": (NeRV, NeRVConfig),
           "pnerv": (PNeRV1, PNeRVConfig), "pnerv1": (PNeRV1, PNeRVConfig),
           "pnerv2": (PNeRV2, PNeRVConfig)}


def build_model(arch: str, cfg: dict, device=None, seed: int = 0):
    """The model for (arch, cfg) on `device` (default: the GPU), its weights
    drawn from a torch.Generator seeded with `seed`."""
    arch = arch.lower()
    if arch not in _MODELS:
        raise ValueError(f"model arch wrong: {arch!r}")
    device = resolve_device(device)
    model_cls, cfg_cls = _MODELS[arch]
    model = model_cls(cfg_cls.from_cfg(cfg))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def quant_layer_paths(arch: str, cfg: dict | None = None):
    """Flax paths of the quantizable conv layers in the reference's
    module-traversal order. NeRV and HNeRV: decoder[0], one conv per
    NeRVBlock, the head. PNeRV: the excitation conv, one conv per
    NeRVBlock, bsm_z, bsm_r (not PNeRV2) and bsm_h of each fusion stage,
    the head (19 layers for PNeRV1 at five strides, 15 for PNeRV2)."""
    arch = arch.lower()
    if arch in ("nerv", "hnerv"):
        n_blocks = len(cfg["dec_strides"]) if cfg else 5
        return ([("decoder0",)]
                + [(f"blocks_{i}", "conv") for i in range(n_blocks)]
                + [("head_layer",)])
    if arch in ("pnerv", "pnerv1", "pnerv2"):
        n = len(cfg["kfc_strides"]) if cfg else 5
        kinds = ("z", "h") if arch == "pnerv2" else ("z", "r", "h")
        return ([("dec_exc", "conv")]
                + [(f"dec_layers_{i}", "conv") for i in range(n)]
                + [(f"bsm_{k}_{i}",) for k in kinds for i in range(n - 1)]
                + [("head_layer",)])
    raise ValueError(f"model arch wrong: {arch!r}")


def _size(module) -> int:
    return sum(p.numel() for p in module.parameters())


def param_counts(arch: str, cfg: dict, model, final_size: int,
                 full_data_length: int):
    """(encoder_M, decoder_M, total_M) with the reference's accounting.
    NeRV and HNeRV: the decoder counts decoder[0] and the blocks (no
    head); HNeRV's total adds the stored per-frame embeddings, NeRV's is
    its decoder (its encoder has no parameters). PNeRV: the encoder against
    everything else, the total adding the ``emd_channel`` embeddings."""
    arch = arch.lower()
    if arch not in _MODELS:
        raise ValueError(f"model arch wrong: {arch!r}")
    if arch.startswith("pnerv"):
        enc = _size(model.enc_layers) / 1e6
        dec = _size(model) / 1e6 - enc
        ch = float(cfg["emd_channel"])
    else:
        enc = _size(model.encoder) / 1e6
        dec = _size(model.decoder) / 1e6
        if arch == "nerv":
            return enc, dec, dec
        ch = float(cfg["enc_channel"][-1])
    embed = ch / np.prod(cfg["enc_strides"]) ** 2 * final_size \
        * full_data_length
    return enc, dec, dec + embed / 1e6


def example_input(arch: str, cfg: dict, batch: int = 1, device=None):
    """An input of the right shape for a forward pass: NeRV's `batch`
    normalized indices linspace(0, 1, batch, endpoint=False); HNeRV's and
    PNeRV's zero frames."""
    arch = arch.lower()
    if arch not in _MODELS:
        raise ValueError(f"model arch wrong: {arch!r}")
    if arch == "nerv":
        return torch.arange(batch, dtype=torch.float32,
                            device=resolve_device(device)) / batch
    return torch.zeros((batch, cfg["crop_h"], cfg["crop_w"], 3),
                       dtype=torch.float32, device=resolve_device(device))


def tail_plan_for(arch: str, cfg: dict):
    """(plan, f_final, ch_packed) of the fused tail for (arch, cfg), or None
    when the decode does not run it. Shapes only; no weights. PNeRV's tail
    is its last NeRVBlock and the head, from pack start 0 at the last
    fusion stage's resolution."""
    from neuroquant_tpu_torch.ops.packed_decode import resolve_pack_start
    from neuroquant_tpu_torch.ops.tail_fused import plan_geometry

    arch = arch.lower()
    if arch not in _MODELS:
        raise ValueError(f"model arch wrong: {arch!r}")
    c = _MODELS[arch][1].from_cfg(cfg)
    if arch.startswith("pnerv"):
        if not pnerv_tail_packed(c):
            return None
        r, ngf = int(c.kfc_strides[-1]), int(c.kfc_h_w_c[2])
        plan, f = plan_geometry(c.crop_h // r, c.crop_w // r,
                                [(3, ngf, ngf * r * r, r)], (3, ngf, 3))
        return plan, f, 3 * f * f
    if c.dec_acts != "gelu":
        return None
    chans = c.decoder_channels()
    t = resolve_pack_start(c.packed_tail, c.dec_kernels, c.dec_strides,
                           c.dec_norm, [c.dec_in_channel] + chans[:-1], chans,
                           c.crop_h, c.crop_w)
    if t is None:
        return None
    s = int(np.prod([int(x) for x in c.dec_strides[t:]]))
    cins = [c.dec_in_channel] + chans
    geoms = [(int(c.dec_kernels[j]), cins[j],
              chans[j] * int(c.dec_strides[j]) ** 2, int(c.dec_strides[j]))
             for j in range(t, len(chans))]
    plan, f = plan_geometry(c.crop_h // s, c.crop_w // s, geoms,
                            (3, chans[-1], 3))
    return plan, f, 3 * f * f
