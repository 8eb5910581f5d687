"""Per-layer weight statistics plots of a trained decoder (the counterpart
of ``neuroquant_tpu/analysis/draw_weight.py``): channel-wise min/max bar
charts plus a weight histogram per quantizable layer, from a stage-1
``.pth``, read into the port's model.

The port keeps conv kernels OIHW; each layer is handed to the statistics
as HWIO, the JAX package's layout, so that an output channel is the last
axis in both packages.

Run (on the GPU; ``--device cpu`` for the CPU):
  python -m neuroquant_tpu_torch.analysis.draw_weight --config <yaml> \\
      --arch hnerv --ckpt <epoch300.pth> --out plots/
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def channel_minmax(w_hwio: np.ndarray):
    """(min, max) per output channel of an HWIO conv weight."""
    flat = w_hwio.reshape(-1, w_hwio.shape[-1])
    return flat.min(axis=0), flat.max(axis=0)


def plot_layer(name: str, w_hwio: np.ndarray, out_dir: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cmin, cmax = channel_minmax(w_hwio)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    idx = np.arange(len(cmin))
    axes[0].bar(idx, cmax, color="#4c72b0", label="max")
    axes[0].bar(idx, cmin, color="#dd8452", label="min")
    axes[0].set_title(f"{name}: per-channel range")
    axes[0].set_xlabel("output channel")
    axes[0].legend()

    vals = w_hwio.ravel()
    axes[1].hist(vals, bins=101, density=True, color="#55a868", alpha=0.8)
    axes[1].set_title(f"{name}: weight distribution "
                      f"(std={vals.std():.4f}, kurt~{_kurtosis(vals):.2f})")
    axes[1].set_xlabel("weight value")
    fig.tight_layout()
    path = os.path.join(out_dir, f"weights_{name.replace('/', '_')}.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def _kurtosis(x):
    x = x - x.mean()
    return float((x ** 4).mean() / (x ** 2).mean() ** 2)


def layer_weights(arch: str, cfg: dict, ckpt: str, device):
    """[(layer name, HWIO numpy kernel)] of the quantizable layers, in
    quant-traversal order, from `ckpt` loaded into the port's model."""
    from neuroquant_tpu_torch.methods.common import load_pth
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization.spec import make_spec

    model = build_model(arch, cfg, device=device)
    load_pth(ckpt, model)
    sd = model.state_dict()
    spec = make_spec(arch, cfg)
    return [(name, sd[f"{pre}.weight"].permute(2, 3, 1, 0).cpu().numpy())
            for name, pre in zip(spec.layer_names, spec.layer_keys)]


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--arch", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--out", type=str, default="plots")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.utils.device import resolve_device

    cfg = validate_config(get_config(args.config), args.arch)
    layers = layer_weights(args.arch, cfg, args.ckpt,
                           resolve_device(args.device))
    os.makedirs(args.out, exist_ok=True)
    paths = [plot_layer(name, w, args.out) for name, w in layers]
    print("\n".join(paths))
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
