"""Evaluate a calibrated or entropy-coded model: quantized artifact (or
bitstream) -> dequantized decoder -> PSNR / MS-SSIM / decode FPS (the
counterpart of ``neuroquant_tpu/methods/eval_quantized.py``).

It reads the artifact pickle that ``calibrate_network`` writes: the model's
reference-layout ``state_dict`` (numpy), the ``quant_spec`` dict and the
``quant_state`` (numpy, HWIO shapes), plus ``arch`` and ``cfg``. With
``--from_bitstream`` the quantized layers are rebuilt from the ``NQTB``
stream alone, its integer codes and its f16 scales; the artifact then gives
only the unquantized parts (the encoder, the shapes) and the codes the
decoded ones are checked against.

Run:
  python -m neuroquant_tpu_torch.methods.eval_quantized --artifact <...pth> \
      --data_path <frame dir> [--from_bitstream <...nqtb>] [--eval_fps] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import pickle
import sys

import numpy as np
import torch

from neuroquant_tpu_torch.data import VideoDataSet
from neuroquant_tpu_torch.methods import common
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.ops.hadamard import fwht
from neuroquant_tpu_torch.quantization.qmodel import (
    _get, _set, quantize_params)
from neuroquant_tpu_torch.quantization.spec import QuantSpec
from neuroquant_tpu_torch.utils.convert import (
    is_block_norm, layer_prefix, quant_state_from_numpy,
    state_dict_from_numpy)
from neuroquant_tpu_torch.utils.device import resolve_device


def parse_args(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--artifact", type=str, required=True)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--from_bitstream", type=str, default=None,
                   help="reconstruct weights from this .nqtb stream instead "
                        "of the saved QuantState")
    p.add_argument("--data_split", type=str, default="1_1_1")
    p.add_argument("-p", "--print-freq", default=50, type=int)
    p.add_argument("--eval_fps", action="store_true", default=False,
                   help="also log the decode FPS")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def spec_from_artifact(artifact) -> QuantSpec:
    qs = artifact["quant_spec"]
    paths = tuple(tuple(p) for p in qs["layer_paths"])
    return QuantSpec(
        layer_names=tuple(qs["layer_names"]), layer_paths=paths,
        layer_keys=tuple(layer_prefix(p, artifact["arch"]) for p in paths),
        n_bits=tuple(qs["n_bits"]), channel_wise=qs["channel_wise"],
        scale_method=qs["scale_method"], hadamard=qs["hadamard"],
        sym=qs["sym"])


def _on(v, device):
    """A code or scale (tensor or numpy) as an fp32 tensor on `device`."""
    if not torch.is_tensor(v):
        v = torch.as_tensor(np.asarray(v))
    return v.to(device=device, dtype=torch.float32)


def params_from_codes(params, spec: QuantSpec, codes: dict):
    """A state dict with every quantized layer's weights rebuilt from its
    integer codes and scales alone: (code - zp) * delta, inverse FWHT and
    C_in crop when ``spec.hadamard``."""
    out = params
    for name, pre in zip(spec.layer_names, spec.layer_keys):
        c = codes[name]
        w, _ = _get(params, pre)
        dev = w.device
        w_deq = (_on(c["w"], dev) - _on(c["w_zp"], dev)) * _on(c["w_delta"],
                                                               dev)
        if spec.hadamard:
            w_deq = fwht(w_deq, axis=2)[:, :, :w.shape[2], :]
        b_deq = (_on(c["b"], dev) - _on(c["b_zp"], dev)) * _on(c["b_delta"],
                                                               dev)
        out = _set(out, pre, w_deq, b_deq)
    return out


def params_from_stream(params, spec: QuantSpec, decoded: dict):
    """Dequantize entirely from the decoded bitstream, codes and scales.

    The stream's scale block is the f16 concatenation [w_delta, w_zp,
    b_delta, b_zp] (``codec.compress_artifact``); splitting it needs only
    the spec (per-channel layout) and the kernel's C_out. For an AdaRound
    state this is lossless: its deltas and zero points were cast through
    f16 at the phase-2 hand-off. A UAQ state's fp32 scales are not, so its
    stream decodes to other weights than its state does."""
    codes = {}
    for name, pre in zip(spec.layer_names, spec.layer_keys):
        d = decoded[name]
        cout = _get(params, pre)[0].shape[-1]
        n_wd = cout if spec.channel_wise else 1
        sc = np.asarray(d["scales"], np.float32)
        if sc.size != 2 * n_wd + 2:
            raise ValueError(f"{name}: {sc.size} scales in the stream, "
                             f"expected {2 * n_wd + 2}")
        wshape = (1, 1, 1, cout) if spec.channel_wise else ()
        codes[name] = {"w": d["w"], "b": d["b"],
                       "w_delta": sc[:n_wd].reshape(wshape),
                       "w_zp": sc[n_wd:2 * n_wd].reshape(wshape),
                       "b_delta": sc[2 * n_wd], "b_zp": sc[2 * n_wd + 1]}
    return params_from_codes(params, spec, codes)


def main(argv):
    args = parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)

    with open(args.artifact, "rb") as f:
        artifact = pickle.load(f)
    arch, cfg = artifact["arch"], artifact["cfg"]
    args.arch = arch

    dataset = VideoDataSet(cfg, args.data_path, device=device)
    common.split_dataset(args, dataset)

    model = build_model(arch, cfg, device=device)
    # every key but a decoder block's norm, which the artifact does not
    # carry (the JAX package's layout): it stays at its init, as in JAX
    missing, unexpected = model.load_state_dict(
        state_dict_from_numpy(artifact["state_dict"], device), strict=False)
    if unexpected or not all(is_block_norm(k) for k in missing):
        raise RuntimeError(f"{args.artifact}: state_dict keys differ from "
                           f"the model's: missing {missing}, unexpected "
                           f"{unexpected}")
    spec = spec_from_artifact(artifact)
    if args.from_bitstream:
        from neuroquant_tpu_torch.coding import decompress_artifact

        with open(args.from_bitstream, "rb") as f:
            decoded = decompress_artifact(f.read())
        # cross-check every decoded payload against the artifact's codes
        for name, c in artifact["int_codes"].items():
            for leaf in ("w", "b"):
                if not np.array_equal(decoded[name][leaf],
                                      np.asarray(c[leaf])):
                    raise SystemExit(
                        f"{args.from_bitstream}: the decoded {name}/{leaf} "
                        "codes differ from the artifact's")
        qparams = params_from_stream(model.state_dict(), spec, decoded)
        logging.info("reconstructed weights+biases+scales from bitstream %s",
                     args.from_bitstream)
    else:
        state = quant_state_from_numpy(artifact["quant_state"], device)
        # any-layer alpha => adaround mode; quantize_params resolves the
        # per-layer mode from alpha presence (mixed-rounding states)
        mode = ("adaround" if any("w_alpha" in s for s in state.values())
                else "uaq")
        qparams = quantize_params(model.state_dict(), spec, state, mode=mode,
                                  soft=False)
    model.load_state_dict(qparams)
    model.eval()

    results, _, _ = common.evaluate(model, dataset, args, cfg,
                                    eval_fps=args.eval_fps)
    s, _ = common.best_metrics_str(results)
    logging.info("Quantized eval: %s", s)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
