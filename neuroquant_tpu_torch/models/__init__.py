"""Model registry, parameter accounting and quantization layout.

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
from neuroquant_tpu_torch.utils.device import resolve_device

__all__ = ["HNeRV", "HNeRVConfig", "NeRV", "NeRVConfig", "build_model",
           "quant_layer_paths", "param_counts", "example_input",
           "tail_plan_for", "require_ported"]

_MODELS = {"hnerv": (HNeRV, HNeRVConfig), "nerv": (NeRV, NeRVConfig)}

_NOT_PORTED = {
    "pnerv": "PNeRV1/PNeRV2 are ROADMAP queue A item 12",
    "pnerv1": "PNeRV1/PNeRV2 are ROADMAP queue A item 12",
    "pnerv2": "PNeRV1/PNeRV2 are ROADMAP queue A item 12",
}


def require_ported(arch: str) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for an arch of
    the JAX package that is not ported yet."""
    if arch.lower() in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch.lower()!r} is not ported yet: "
                                  f"{_NOT_PORTED[arch.lower()]}")


def build_model(arch: str, cfg: dict, device=None, seed: int = 0):
    """The model for (arch, cfg) on `device` (default: the GPU), its weights
    drawn from a torch.Generator seeded with `seed`."""
    arch = arch.lower()
    require_ported(arch)
    if arch not in _MODELS:
        raise ValueError(f"model arch wrong: {arch!r}")
    device = resolve_device(device)
    model_cls, cfg_cls = _MODELS[arch]
    model = model_cls(cfg_cls.from_cfg(cfg))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def quant_layer_paths(arch: str, cfg: dict | None = None):
    """Flax paths of the quantizable conv layers in the reference's
    module-traversal order: decoder[0], one conv per NeRVBlock, head."""
    arch = arch.lower()
    if arch in ("nerv", "hnerv"):
        n_blocks = len(cfg["dec_strides"]) if cfg else 5
        return ([("decoder0",)]
                + [(f"blocks_{i}", "conv") for i in range(n_blocks)]
                + [("head_layer",)])
    raise NotImplementedError(f"quant_layer_paths for arch {arch!r}: "
                              f"{_NOT_PORTED.get(arch, 'unknown arch')}")


def _size(module) -> int:
    return sum(p.numel() for p in module.parameters())


def param_counts(arch: str, cfg: dict, model, final_size: int,
                 full_data_length: int):
    """(encoder_M, decoder_M, total_M) with the reference's accounting: the
    decoder counts decoder[0] and the blocks (no head); HNeRV's total adds
    the stored per-frame embeddings, NeRV's is its decoder (its encoder
    has no parameters)."""
    arch = arch.lower()
    if arch not in _MODELS:
        raise NotImplementedError(f"param_counts for arch {arch!r}")
    enc = _size(model.encoder) / 1e6
    dec = _size(model.decoder) / 1e6
    if arch == "nerv":
        return enc, dec, dec
    embed = (float(cfg["enc_channel"][-1]) / np.prod(cfg["enc_strides"]) ** 2
             * final_size * full_data_length)
    return enc, dec, dec + embed / 1e6


def example_input(arch: str, cfg: dict, batch: int = 1, device=None):
    """An input of the right shape for a forward pass: NeRV's `batch`
    normalized indices linspace(0, 1, batch, endpoint=False), else zero
    frames."""
    arch = arch.lower()
    if arch == "nerv":
        return torch.arange(batch, dtype=torch.float32,
                            device=resolve_device(device)) / batch
    if arch != "hnerv":
        raise NotImplementedError(f"example_input for arch {arch!r}")
    return torch.zeros((batch, cfg["crop_h"], cfg["crop_w"], 3),
                       dtype=torch.float32, device=resolve_device(device))


def tail_plan_for(arch: str, cfg: dict):
    """(plan, f_final, ch_packed) of the fused tail for (arch, cfg), or None
    when the decode does not run it. Shapes only; no weights."""
    from neuroquant_tpu_torch.ops.packed_decode import resolve_pack_start
    from neuroquant_tpu_torch.ops.tail_fused import plan_geometry

    arch = arch.lower()
    if arch not in _MODELS:
        raise NotImplementedError(f"tail_plan_for for arch {arch!r}")
    c = _MODELS[arch][1].from_cfg(cfg)
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
