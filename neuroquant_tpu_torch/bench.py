"""Benchmark of the port on one NVIDIA GPU: network-wise calibration
throughput at HNeRV Bunny-3M (the counterpart of the repository's
``bench.py``, which measures the JAX package).

The shortened HNeRV Bunny-3M calibration of ``bench.py``: batch 2,
precision 6 5 4 5 5 6 6, Hadamard, channel-wise, max scales, lr 0.003,
warmup 0.2, the weights' fake-quant on the plain chain (``fq_impl``
'jnp', the default of both packages), ``--iters`` 2112 by default (one
phase-1 and 31 phase-2 epochs of 66 steps); the same per-step work as a
full run. The weights are the
port's seeded init and the clip is 132 seeded synthetic 1280x720 frames,
center-cropped to 640x1280 as ``VideoDataSet`` crops a decoded clip, made
on the device. It reports the median phase-2 it/s over the epochs after
the first (each epoch ends in a synchronisation) and the decode FPS at
batch 1 (``methods.common.measure_decode_fps``).

  python -m neuroquant_tpu_torch.bench [--iters N]

Exactly one JSON line goes to stdout: metric, value, unit,
decode_fps_per_chip, the card's name and power limit as ``nvidia-smi``
gives them, and the device; progress goes to stderr. A failure exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time

import numpy as np
import torch

BENCH_BATCH = 2
BENCH_ITERS = 2112      # 1 phase-1 epoch + 31 phase-2 epochs at 66 steps
N_FRAMES = 132          # Bunny's clip
SEED = 903
PRECISION = [6, 5, 4, 5, 5, 6, 6]
CFG = dict(
    crop_h=640, crop_w=1280, diff_enc=False, stage_block=1,
    enc_strides=[5, 4, 4, 2, 2], enc_channel=[64, 64, 64, 64, 16],
    channel_reduce=1.2, channel_lbound=12, dec_in_channel=92,
    dec_kernels=[1, 3, 5, 5, 5], dec_strides=[5, 4, 4, 2, 2],
    dec_norm="none", dec_acts="gelu", out_bias="tanh", loss="l2",
    epoch=300, workers=0, eval_freq=30, batch_size=1, learning_rate=5e-4)


def synthetic_frames(n: int, seed: int, device, size=(720, 1280),
                     crop=(640, 1280)):
    """`n` seeded frames of `size` (a gradient, a per-frame tint and noise,
    rounded to 8 bits), center-cropped to `crop`: (n, *crop, 3) float32 in
    [0, 1] on `device`."""
    h, w = size
    ch, cw = crop
    top, left = int(round((h - ch) / 2.0)), int(round((w - cw) / 2.0))
    gen = torch.Generator(device=device).manual_seed(seed)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    out = torch.empty((n, ch, cw, 3), device=device)
    for t in range(n):
        img = torch.stack([xx.expand(h, w), yy.expand(h, w),
                           torch.full((h, w), 0.5 + 0.4 * np.sin(t),
                                      device=device)], -1)
        img = img + 0.05 * torch.randn(img.shape, generator=gen,
                                       device=device)
        u8 = (img.clamp(0, 1) * 255).to(torch.uint8)
        out[t] = u8[top:top + ch, left:left + cw].to(torch.float32) / 255.0
    return out


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(iters: int, batch_size: int, n_frames: int, seed: int, device,
        cfg=None, precision=PRECISION, fps_iters: int = 400):
    """The shortened calibration and the decode FPS: a result dict. `cfg`:
    the HNeRV config (Bunny-3M's by default) and `precision` its layers'
    bits; the frames are 16:9 at its width, cropped to its height;
    `fps_iters` decodes a timed window of the FPS."""
    from neuroquant_tpu_torch.config import validate_config
    from neuroquant_tpu_torch.methods.common import measure_decode_fps
    from neuroquant_tpu_torch.models import build_model, tail_plan_for
    from neuroquant_tpu_torch.ops.tail_fused import border_mask, pack_targets
    from neuroquant_tpu_torch.quantization import (
        init_quant_state, make_spec, model_reconstruction)
    from neuroquant_tpu_torch.utils.device import synchronize

    cfg = validate_config(dict(cfg or CFG), "hnerv")
    model = build_model("hnerv", cfg, device=device, seed=seed)
    model.eval()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    t0 = time.time()
    crop = (cfg["crop_h"], cfg["crop_w"])
    frames = synthetic_frames(n_frames, seed, device,
                              size=(crop[1] * 9 // 16, crop[1]), crop=crop)
    with torch.no_grad():
        cali = torch.cat([model.encode(frames[i:i + 8])
                          for i in range(0, n_frames, 8)])
    synchronize(device)
    logging.info("made and encoded %d frames in %.1fs", n_frames,
                 time.time() - t0)
    spec = make_spec("hnerv", cfg, channel_wise=True, scale_method="max",
                     hadamard=True).with_bits(precision)
    state = init_quant_state(params, spec)
    plan, f, ch = tail_plan_for("hnerv", cfg)
    cf_pack = {"gt": pack_targets(frames, plan, f),
               "mask": border_mask(plan, ch=ch, device=frames.device),
               "denom": crop[0] * crop[1]}

    rates, last = [], {"t": None, "count": 0}

    def epoch_hook(e, count, st):
        synchronize(device)
        now = time.time()
        if last["t"] is not None:
            rate = (count - last["count"]) / max(now - last["t"], 1e-9)
            rates.append(rate)
            logging.info("phase 2 epoch %d: %.3f iters/s", e, rate)
        last["t"], last["count"] = now, count

    t0 = time.time()
    model_reconstruction(
        model, params, spec, state, cali, frames, list(range(n_frames)),
        arch="hnerv", batch_size=batch_size, iters=iters, weight=0.01,
        b_range=(20, 2), warmup=0.2, p=2.0, lr=0.003, seed=seed,
        log_fn=logging.info, cf_pack=cf_pack, epoch_hook=epoch_hook)
    logging.info("total calibration wall: %.1fs", time.time() - t0)
    if not rates:
        raise RuntimeError(f"--iters {iters}: fewer than two phase-2 epochs "
                           f"of {n_frames // batch_size} steps; no steady "
                           f"rate")
    fps = measure_decode_fps(model, cali, 1, n_iters=fps_iters)
    logging.info("decode fps (batch 1): %.1f", fps)
    return {"metric": "hnerv_bunny_network_calib_throughput",
            "value": float(np.median(rates)), "unit": "iters/sec",
            "decode_fps_per_chip": float(fps),
            "steady_epoch_rates": rates,
            "card": card_line(device),
            "device": (torch.cuda.get_device_name(device)
                       if torch.device(device).type == "cuda" else "cpu")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=BENCH_ITERS)
    ap.add_argument("--batch_size", type=int, default=BENCH_BATCH)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO)

    from neuroquant_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    result = run(args.iters, args.batch_size, N_FRAMES, SEED, device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
