"""Weights across the two packages: the counterpart of
``neuroquant_tpu/utils/torch_compat.py``, kept here as the port's own copy.

The JAX package keeps a flax params tree; its checkpoints and artifacts
store the reference's torch state-dict layout:

  torch                                    flax
  -----------------------------------     -------------------------------
  decoder.0.{weight,bias}                  decoder0/{kernel,bias}
  decoder.{i}.conv.0.{weight,bias}         blocks_{i-1}/conv/{kernel,bias}
  decoder.{i}.norm.{weight,bias}           blocks_{i-1}/norm_fn/{scale,bias}
  head_layer.{weight,bias}                 head_layer/{kernel,bias}
  encoder.downsample_layers.0.0 (conv)     encoder/down_conv_0
  encoder.downsample_layers.0.1 (LN)       encoder/down_norm_0
  encoder.downsample_layers.i.0 (LN)       encoder/down_norm_i   (i > 0)
  encoder.downsample_layers.i.1 (conv)     encoder/down_conv_i
  encoder.stages.i.j.{dwconv,norm,         encoder/stage_{i}_block_{j}/...
                      pwconv1,pwconv2,gamma}

PNeRV (``_pnerv_pairs``; the names the reference's PNeRV modules give):

  enc_layers.{3k} (conv), .{3k+1} (LN)     encoder/conv_k, encoder/norm_k
  enc_layers.{3k+2}.* (ConvNeXt block)     encoder/block_k/...
  enc_layers.{3n} (conv)                   encoder/proj
  dec_exc_layers.conv.0                    dec_exc/conv
  dec_exc_layers.norm                      dec_exc/norm_fn
  dec_layers.{i}.conv.0                    dec_layers_{i}/conv
  dec_layers.{i}.norm                      dec_layers_{i}/norm_fn
  dec_shortcuts.{3i} (KFc, verbatim)       shortcuts_{i}/{w_L,w_R,b_h,b_w,b_c}
  dec_shortcuts.{3i+1} (BatchNorm)         shortcut_norms_{i}
  dec_bsm_{z,r,h}.{i}                      bsm_{z,r,h}_{i}
  dec_head_layers                          head_layer

Conv weights are OIHW in torch and HWIO in flax; Linear weights (out, in)
and (in, out); LayerNorm and BatchNorm ``weight`` is flax's ``scale``.

A decoder block's batch norm (``dec_norm: batch``; an instance norm has no
parameters) is carried here and in the port's ``.pth``, which writes and
reads it. The JAX package's mapping (``torch_compat``) carries none, and
its loader leaves a missing key at its init: a JAX ``.pth`` loads into the
port with the norm at its init, and the port's loads into JAX with the
norm at identity. The quantized artifact carries none in either package
(:func:`is_block_norm`), as the JAX package writes it.
"""

from __future__ import annotations

import re
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


def _decoder_pairs(p: dict):
    """(torch_key, flax_path, kind) triples of a NeRV/HNeRV decoder: a
    block's batch norm (``dec_norm: batch``) where the tree holds one."""
    out = [("decoder.0", ("decoder0",), "conv")]
    for i in range(sum(1 for k in p if k.startswith("blocks_"))):
        out.append((f"decoder.{i + 1}.conv.0", (f"blocks_{i}", "conv"),
                    "conv"))
        if "norm_fn" in p[f"blocks_{i}"]:
            out.append((f"decoder.{i + 1}.norm", (f"blocks_{i}", "norm_fn"),
                        "norm"))
    out.append(("head_layer", ("head_layer",), "conv"))
    return out


# a NeRVBlock's norm in the reference key layout: decoder.{i}.norm (HNeRV,
# NeRV), dec_exc_layers.norm and dec_layers.{i}.norm (PNeRV)
_BLOCK_NORM = re.compile(r"^(decoder\.\d+|dec_exc_layers|dec_layers\.\d+)"
                         r"\.norm\.")


def is_block_norm(key: str) -> bool:
    """Whether a state-dict key is a decoder block's norm parameter, which
    the JAX package's checkpoints and artifacts do not carry."""
    return _BLOCK_NORM.match(key) is not None


def _pnerv_pairs(p: dict):
    """(torch_key, flax_path, kind) triples of a PNeRV1/PNeRV2 params
    tree."""
    enc = p["encoder"]
    n_stages = sum(1 for k in enc if k.startswith("conv_"))
    out = []
    for k in range(n_stages):
        out.append((f"enc_layers.{3 * k}", ("encoder", f"conv_{k}"), "conv"))
        out.append((f"enc_layers.{3 * k + 1}", ("encoder", f"norm_{k}"),
                    "norm"))
        blk, base = f"block_{k}", f"enc_layers.{3 * k + 2}"
        out.append((f"{base}.dwconv", ("encoder", blk, "dwconv"), "conv"))
        out.append((f"{base}.norm", ("encoder", blk, "norm"), "norm"))
        out.append((f"{base}.pwconv1", ("encoder", blk, "pwconv1"),
                    "linear"))
        out.append((f"{base}.pwconv2", ("encoder", blk, "pwconv2"),
                    "linear"))
        out.append((f"{base}.gamma", ("encoder", blk), "gamma"))
    out.append((f"enc_layers.{3 * n_stages}", ("encoder", "proj"), "conv"))
    out.append(("dec_exc_layers.conv.0", ("dec_exc", "conv"), "conv"))
    if "norm_fn" in p["dec_exc"]:
        out.append(("dec_exc_layers.norm", ("dec_exc", "norm_fn"), "norm"))
    for i in range(sum(1 for k in p if k.startswith("dec_layers_"))):
        out.append((f"dec_layers.{i}.conv.0", (f"dec_layers_{i}", "conv"),
                    "conv"))
        if "norm_fn" in p[f"dec_layers_{i}"]:
            out.append((f"dec_layers.{i}.norm", (f"dec_layers_{i}",
                                                 "norm_fn"), "norm"))
    for i in range(sum(1 for k in p if k.startswith("shortcuts_"))):
        out.append((f"dec_shortcuts.{3 * i}", (f"shortcuts_{i}",), "raw"))
        out.append((f"dec_shortcuts.{3 * i + 1}", (f"shortcut_norms_{i}",),
                    "norm"))
    for kind in ("z", "r", "h"):
        for i in range(sum(1 for k in p if k.startswith(f"bsm_{kind}_"))):
            out.append((f"dec_bsm_{kind}.{i}", (f"bsm_{kind}_{i}",), "conv"))
    out.append(("dec_head_layers", ("head_layer",), "conv"))
    return out


def layer_prefix(path, arch: str) -> str:
    """State-dict prefix of a quantized layer of `arch` given by its flax
    path (``models.quant_layer_paths``): ('blocks_2', 'conv') ->
    'decoder.3.conv.0', ('bsm_z_1',) -> 'dec_bsm_z.1'. The head's path,
    ('head_layer',), is 'dec_head_layers' in PNeRV, else 'head_layer'."""
    path = tuple(path)
    if path == ("head_layer",):
        pnerv = arch.lower().startswith("pnerv")
        return "dec_head_layers" if pnerv else "head_layer"
    if path == ("decoder0",):
        return "decoder.0"
    if path == ("dec_exc", "conv"):
        return "dec_exc_layers.conv.0"
    if len(path) == 2 and path[1] == "conv":
        if path[0].startswith("blocks_"):
            return f"decoder.{int(path[0][len('blocks_'):]) + 1}.conv.0"
        if path[0].startswith("dec_layers_"):
            return f"dec_layers.{int(path[0][len('dec_layers_'):])}.conv.0"
    if len(path) == 1 and path[0][:6] in ("bsm_z_", "bsm_r_", "bsm_h_"):
        return f"dec_bsm_{path[0][4]}.{int(path[0][6:])}"
    raise KeyError(f"no state-dict prefix for layer path {path}")


def state_dict_from_jax(arch: str, params_np) -> "OrderedDict":
    """numpy leaves of a flax NeRV/HNeRV/PNeRV params tree -> a torch state
    dict with the reference key names (CPU tensors)."""
    arch = arch.lower()
    p = params_np["params"] if "params" in params_np else params_np
    pairs = []
    if arch.startswith("pnerv"):
        pairs = _pnerv_pairs(p)
    elif arch in ("hnerv", "nerv"):
        if arch == "hnerv":
            enc = p["encoder"]
            pairs += _convnext_pairs(
                sum(1 for k in enc if k.startswith("down_conv_")),
                sum(1 for k in enc if k.startswith("stage_0_block_")))
        pairs += _decoder_pairs(p)
    else:
        raise NotImplementedError(f"state-dict conversion for arch {arch!r}")

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
        elif kind == "raw":   # KFc: its leaves under their own names
            for name, v in node.items():
                sd[f"{key}.{name}"] = t(v)
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
