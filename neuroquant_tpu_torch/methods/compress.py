"""Stage 4: entropy-code a calibrated model into a bitstream and report bpp
(the counterpart of ``neuroquant_tpu/methods/compress.py``).

It consumes the artifact written by calibrate_network (either package's),
arithmetic-codes every layer's weight and bias symbols
(neuroquant_tpu_torch/coding), accounts for the scale/zero-point side
information and (for content-conditioned archs) the per-frame embeddings,
and writes `<artifact>.nqtb` plus a JSON bpp report. Host-side numpy and the
C++ coder: it takes no device.

bpp = total_bits / (num_frames * crop_h * crop_w), the "model is the
bitstream" accounting used in the paper's RD curves.

Run:
  python -m neuroquant_tpu_torch.methods.compress \
      --artifact <hnerv_W4.79...pth> --data_path <frame dir> [--embed_bits 8]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import sys

import numpy as np

from neuroquant_tpu_torch.coding import compress_artifact, decompress_artifact
from neuroquant_tpu_torch.coding.codec import build_freqs, encode_symbols


def parse_args(argv):
    p = argparse.ArgumentParser(description="entropy-code a calibrated model")
    p.add_argument("--artifact", type=str, required=True,
                   help="quantized artifact from calibrate_network")
    p.add_argument("--data_path", type=str, default=None,
                   help="frame dir (frame count for bpp; else cfg-less)")
    p.add_argument("--num_frames", type=int, default=None,
                   help="override frame count for bpp accounting")
    p.add_argument("--embed_bits", type=int, default=8,
                   help="bits for quantizing stored embeddings (HNeRV/PNeRV)")
    p.add_argument("--out", type=str, default=None)
    return p.parse_args(argv)


def embedding_bitstream(embeds: np.ndarray, bits: int):
    """Uniform per-tensor quantization + arithmetic coding of the stored
    per-frame embeddings (the HNeRV 'content' half of the bitstream)."""
    lo, hi = float(embeds.min()), float(embeds.max())
    n_sym = 1 << bits
    delta = max((hi - lo) / (n_sym - 1), 1e-12)
    sym = np.clip(np.round((embeds - lo) / delta), 0, n_sym - 1).astype(np.int32)
    freqs = build_freqs(sym, n_sym)
    blob = encode_symbols(sym, freqs)
    side = 4 * n_sym + 8  # freq table + min/delta
    return blob, len(blob) + side, (lo, delta)


def main(argv):
    args = parse_args(argv)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO)

    with open(args.artifact, "rb") as f:
        artifact = pickle.load(f)
    cfg = artifact["cfg"]
    arch = artifact["arch"]

    if args.num_frames is not None:
        n_frames = args.num_frames
    elif args.data_path:
        # count only frame files: a stray README/.DS_Store would silently
        # inflate the bpp denominator
        exts = (".png", ".jpg", ".jpeg", ".bmp")
        n_frames = sum(1 for f in os.listdir(args.data_path)
                       if f.lower().endswith(exts))
        if n_frames == 0:
            raise SystemExit(f"no frame files in {args.data_path}")
    else:
        raise SystemExit("need --data_path or --num_frames for bpp")

    stream = compress_artifact(artifact["int_codes"])

    # verify decodability before reporting
    back = decompress_artifact(stream)
    for name, c in artifact["int_codes"].items():
        np.testing.assert_array_equal(back[name]["w"], np.asarray(c["w"]))
        np.testing.assert_array_equal(back[name]["b"], np.asarray(c["b"]))

    weight_bits = len(stream) * 8
    total_bits = weight_bits
    embed_bits_total = 0

    if arch in ("hnerv", "pnerv", "pnerv1", "pnerv2"):
        # content-conditioned: per-frame embeddings are part of the bitstream
        embeds = artifact.get("embeddings")
        if embeds is not None:
            _, nbytes, _ = embedding_bitstream(np.asarray(embeds), args.embed_bits)
            embed_bits_total = nbytes * 8
        else:
            # fall back to the reference's analytic accounting
            # (methods/regress.py:177): raw fp count at embed_bits
            key = "enc_channel" if arch == "hnerv" else "emd_channel"
            ch = cfg[key][-1] if isinstance(cfg[key], list) else cfg[key]
            n_embed = (ch / np.prod(cfg["enc_strides"]) ** 2
                       * cfg["crop_h"] * cfg["crop_w"] * n_frames)
            embed_bits_total = int(n_embed * args.embed_bits)
        total_bits += embed_bits_total

    pixels = n_frames * cfg["crop_h"] * cfg["crop_w"]
    bpp = total_bits / pixels

    out_path = args.out or (args.artifact + ".nqtb")
    with open(out_path, "wb") as f:
        f.write(stream)

    report = {
        "arch": arch,
        "avg_bits": artifact.get("avg_bits"),
        "weight_stream_bytes": len(stream),
        "embed_bits": embed_bits_total,
        "total_bits": total_bits,
        "pixels": pixels,
        "bpp": round(bpp, 6),
        "bitstream": out_path,
    }
    with open(out_path + ".json", "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
