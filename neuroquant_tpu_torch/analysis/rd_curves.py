"""UVG rate-distortion curves and BD-rate (the counterpart of
``neuroquant_tpu/analysis/rd_curves.py``; numpy only, so the port keeps its
own copy).

The published per-codec (bpp, PSNR) points below are benchmark *data*
hardcoded in the reference notebook (draw_RDs.ipynb cell 2); the -VR rows are
NeuroQuant's ICLR'25 variable-rate results. This module renders the same RD
plot, computes BD-rate/BD-PSNR between any two curves (Bjontegaard 2001,
cubic log-rate interpolation), and lets users overlay their own pipeline
outputs (the bpp/PSNR pairs emitted by methods/compress.py + eval_quantized).

Run (host only, no device):
  python -m neuroquant_tpu_torch.analysis.rd_curves --out plots/rd_uvg.png \
      [--extra my_run.json]       # {"label": ..., "bpp": [...], "psnr": [...]}
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

PUBLISHED_UVG = {
    "x264": dict(
        bpp=[0.019529851, 0.024798606, 0.03145038, 0.040445181, 0.052089963,
             0.067762785, 0.08908649, 0.119998625, 0.167446419],
        psnr=[32.4076291, 33.13900129, 33.82915931, 34.57786362, 35.22131672,
              35.85809628, 36.48485178, 37.07316834, 37.6872532],
        style=dict(color="#708090", linestyle="--", marker="<")),
    "x265": dict(
        bpp=[0.010533638, 0.017297753, 0.034846718, 0.052092168, 0.069226093,
             0.081516848, 0.116900364, 0.140282629, 0.172093032],
        psnr=[31.09701223, 32.37807948, 34.46285081, 35.5652131, 36.22249996,
              36.54785245, 37.19775282, 37.51812663, 37.83899274],
        style=dict(color="r", linestyle="--", marker="*")),
    "DCVC": dict(
        bpp=[0.026946852, 0.039822457, 0.060852451, 0.098824209],
        psnr=[33.56625311, 34.79113846, 35.98613648, 37.11172044],
        style=dict(color="peru", linestyle="--", marker="s")),
    "NeRV": dict(
        bpp=[0.0227, 0.0453, 0.0655, 0.0875, 0.1314, 0.1772],
        psnr=[31.31, 32.22, 32.72, 33.18, 33.75, 34.13],
        style=dict(color="indigo", linestyle="--", marker="p")),
    "NeRV-VR": dict(
        bpp=[0.0113, 0.0168, 0.0308, 0.04875, 0.0651, 0.098, 0.124],
        psnr=[30.83, 31.31, 32.22, 32.72, 33.18, 33.75, 34.02],
        style=dict(color="indigo", linestyle="-", marker="")),
    "D-CABAC": dict(
        bpp=[0.014, 0.0275, 0.0392, 0.052, 0.0761, 0.101, 0.12],
        psnr=[30.67, 31.58, 32.10, 32.52, 33.07, 33.42, 33.66],
        style=dict(color="limegreen", linestyle="-", marker="")),
    "HNeRV": dict(
        bpp=[0.0242, 0.0453, 0.0655, 0.0875, 0.1314, 0.18],
        psnr=[32.38, 33.66, 34.31, 34.88, 35.64, 36.25],
        style=dict(color="#1E90FF", linestyle="--", marker="o")),
    "HNeRV-VR": dict(
        bpp=[0.012, 0.01718, 0.034, 0.04915, 0.06561, 0.0986, 0.1305],
        psnr=[31.64, 32.2, 33.62, 34.31, 34.88, 35.64, 36.08],
        style=dict(color="#1E90FF", linestyle="-", marker="")),
    "HiNeRV*": dict(
        bpp=[0.0129, 0.02, 0.032, 0.0524, 0.0680, 0.104],
        psnr=[34.08, 34.9, 36.1, 37.14, 37.7, 38.15],
        style=dict(color="hotpink", linestyle="--", marker="h")),
    "HiNeRV-VR": dict(
        bpp=[0.0081, 0.0145, 0.029, 0.0570, 0.0824, 0.096],
        psnr=[33.33, 34.53, 36.01, 37.45, 37.972, 38.1],
        style=dict(color="hotpink", linestyle="-", marker="")),
}


def bd_rate(bpp_anchor, psnr_anchor, bpp_test, psnr_test) -> float:
    """BD-rate (%) of test vs anchor: negative = test saves rate."""
    la, lt = np.log(bpp_anchor), np.log(bpp_test)
    pa = np.polyfit(psnr_anchor, la, 3)
    pt = np.polyfit(psnr_test, lt, 3)
    lo = max(min(psnr_anchor), min(psnr_test))
    hi = min(max(psnr_anchor), max(psnr_test))
    if hi <= lo:
        return float("nan")
    ia = np.polyint(pa)
    it = np.polyint(pt)
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float((np.exp(avg_t - avg_a) - 1) * 100)


def bd_psnr(bpp_anchor, psnr_anchor, bpp_test, psnr_test) -> float:
    """BD-PSNR (dB) of test vs anchor over the overlapping log-rate range."""
    la, lt = np.log(bpp_anchor), np.log(bpp_test)
    pa = np.polyfit(la, psnr_anchor, 3)
    pt = np.polyfit(lt, psnr_test, 3)
    lo = max(la.min(), lt.min())
    hi = min(la.max(), lt.max())
    if hi <= lo:
        return float("nan")
    ia, it = np.polyint(pa), np.polyint(pt)
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float(avg_t - avg_a)


def plot(out_path: str, extra: dict | None = None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.5, 4.5), dpi=150)
    ax.grid(which="major", color="gray", linestyle="-", linewidth=0.6, zorder=0)
    ax.minorticks_on()
    for name, d in PUBLISHED_UVG.items():
        ax.plot(d["bpp"], d["psnr"], label=name, linewidth=1.5, **d["style"])
    if extra:
        ax.plot(extra["bpp"], extra["psnr"], label=extra.get("label", "ours"),
                color="darkorange", linestyle="-", marker="D", linewidth=2.0)
    ax.set_xlabel("Bit Rate (bpp)")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title("R-D Curves on UVG")
    ax.legend(fontsize=7, ncol=2)
    fig.tight_layout()
    fig.savefig(out_path)
    return out_path


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="plots/rd_uvg.png", type=str)
    parser.add_argument("--extra", default=None, type=str,
                        help="JSON file with {label, bpp, psnr} to overlay")
    parser.add_argument("--bd", nargs=2, default=["NeRV", "NeRV-VR"],
                        metavar=("ANCHOR", "TEST"),
                        help="print BD-rate/BD-PSNR of TEST vs ANCHOR")
    args = parser.parse_args(argv)

    import os
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    extra = json.load(open(args.extra)) if args.extra else None
    plot(args.out, extra)

    a, t = args.bd
    da = PUBLISHED_UVG[a] if a in PUBLISHED_UVG else extra
    dt = PUBLISHED_UVG[t] if t in PUBLISHED_UVG else extra
    r = bd_rate(da["bpp"], da["psnr"], dt["bpp"], dt["psnr"])
    p = bd_psnr(da["bpp"], da["psnr"], dt["bpp"], dt["psnr"])
    print(json.dumps({"anchor": a, "test": t,
                      "bd_rate_pct": round(r, 2), "bd_psnr_db": round(p, 3),
                      "plot": args.out}))


if __name__ == "__main__":
    main(sys.argv[1:])
