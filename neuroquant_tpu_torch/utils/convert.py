"""Weights across the two packages: the HNeRV/NeRV part of
``neuroquant_tpu/utils/torch_compat.py``, kept here as the port's own copy.

The JAX package keeps a flax params tree; its checkpoints and artifacts
store the reference's torch state-dict layout:

  torch                                    flax
  -----------------------------------     -------------------------------
  decoder.0.{weight,bias}                  decoder0/{kernel,bias}
  decoder.{i}.conv.0.{weight,bias}         blocks_{i-1}/conv/{kernel,bias}
  head_layer.{weight,bias}                 head_layer/{kernel,bias}
  encoder.downsample_layers.0.0 (conv)     encoder/down_conv_0
  encoder.downsample_layers.0.1 (LN)       encoder/down_norm_0
  encoder.downsample_layers.i.0 (LN)       encoder/down_norm_i   (i > 0)
  encoder.downsample_layers.i.1 (conv)     encoder/down_conv_i
  encoder.stages.i.j.{dwconv,norm,         encoder/stage_{i}_block_{j}/...
                      pwconv1,pwconv2,gamma}

Conv weights are OIHW in torch and HWIO in flax; Linear weights (out, in)
and (in, out); LayerNorm ``weight`` is flax's ``scale``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _convnext_pairs(n_stages: int, stage_blocks: int):
    """(torch_key, flax_path, kind) triples of the ConvNeXt encoder."""
    out = []
    for i in range(n_stages):
        conv_idx, norm_idx = (0, 1) if i == 0 else (1, 0)
        out.append((f"encoder.downsample_layers.{i}.{conv_idx}",
                    ("encoder", f"down_conv_{i}"), "conv"))
        out.append((f"encoder.downsample_layers.{i}.{norm_idx}",
                    ("encoder", f"down_norm_{i}"), "norm"))
        for j in range(stage_blocks):
            base, blk = f"encoder.stages.{i}.{j}", f"stage_{i}_block_{j}"
            out.append((f"{base}.dwconv", ("encoder", blk, "dwconv"), "conv"))
            out.append((f"{base}.norm", ("encoder", blk, "norm"), "norm"))
            out.append((f"{base}.pwconv1", ("encoder", blk, "pwconv1"),
                        "linear"))
            out.append((f"{base}.pwconv2", ("encoder", blk, "pwconv2"),
                        "linear"))
            out.append((f"{base}.gamma", ("encoder", blk), "gamma"))
    return out


def _decoder_pairs(n_blocks: int):
    out = [("decoder.0", ("decoder0",), "conv")]
    for i in range(n_blocks):
        out.append((f"decoder.{i + 1}.conv.0", (f"blocks_{i}", "conv"),
                    "conv"))
    out.append(("head_layer", ("head_layer",), "conv"))
    return out


def layer_prefix(path) -> str:
    """State-dict prefix of a quantized layer given by its flax path
    (``models.quant_layer_paths``): ('blocks_2', 'conv') -> 'decoder.3.conv.0'."""
    path = tuple(path)
    if path == ("decoder0",):
        return "decoder.0"
    if path == ("head_layer",):
        return "head_layer"
    if len(path) == 2 and path[0].startswith("blocks_") and path[1] == "conv":
        return f"decoder.{int(path[0][len('blocks_'):]) + 1}.conv.0"
    raise KeyError(f"no state-dict prefix for layer path {path}")


def state_dict_from_jax(arch: str, params_np) -> "OrderedDict":
    """numpy leaves of a flax HNeRV/NeRV params tree -> a torch state dict
    with the reference key names (CPU tensors)."""
    arch = arch.lower()
    p = params_np["params"] if "params" in params_np else params_np
    n_blocks = sum(1 for k in p if k.startswith("blocks_"))
    pairs = []
    if arch == "hnerv":
        enc = p["encoder"]
        pairs += _convnext_pairs(
            sum(1 for k in enc if k.startswith("down_conv_")),
            sum(1 for k in enc if k.startswith("stage_0_block_")))
    elif arch != "nerv":
        raise NotImplementedError(f"state-dict conversion for arch {arch!r}")
    pairs += _decoder_pairs(n_blocks)

    sd = OrderedDict()
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa
    for key, path, kind in pairs:
        node = p
        for k in path:
            node = node[k]
        if kind == "conv":
            sd[f"{key}.weight"] = t(np.transpose(node["kernel"], (3, 2, 0, 1)))
            if "bias" in node:
                sd[f"{key}.bias"] = t(node["bias"])
        elif kind == "linear":
            sd[f"{key}.weight"] = t(np.asarray(node["kernel"]).T)
            sd[f"{key}.bias"] = t(node["bias"])
        elif kind == "norm":
            sd[f"{key}.weight"] = t(node["scale"])
            sd[f"{key}.bias"] = t(node["bias"])
        else:
            sd[key] = t(node["gamma"])
    return sd


def save_pth(path: str, model) -> None:
    """Write `model`'s weights as a reference-layout .pth: its state dict
    (the reference's key names) as CPU tensors, which the JAX package's
    ``load_pth`` and the port's ``methods.common.load_pth`` read."""
    sd = OrderedDict((k, v.detach().cpu().clone())
                     for k, v in model.state_dict().items())
    torch.save(sd, path)


def state_dict_from_numpy(state_dict, device=None) -> "OrderedDict":
    """A reference-layout state dict of numpy arrays (the quantized
    artifact's ``state_dict``) -> fp32 tensors on `device`."""
    return OrderedDict((k, torch.as_tensor(np.array(v, np.float32),
                                           device=device))
                       for k, v in state_dict.items())


def quant_state_from_numpy(state, device=None) -> dict:
    """A JAX ``QuantState`` of numpy arrays ({layer: {leaf: array}}, HWIO
    shapes: w_delta (1, 1, 1, C_out) channel-wise, 0-d per layer) -> the
    same dict of fp32 tensors on `device`."""
    return {name: {leaf: torch.as_tensor(np.array(v, np.float32),
                                         device=device)
                   for leaf, v in layer.items()}
            for name, layer in state.items()}


def quant_state_to_numpy(state) -> dict:
    """Inverse of :func:`quant_state_from_numpy` (artifact writing)."""
    return {name: {leaf: v.detach().cpu().numpy() for leaf, v in layer.items()}
            for name, layer in state.items()}
