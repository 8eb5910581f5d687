#!/usr/bin/env python3
"""Time the port's two training steps at HNeRV Bunny-3M on one GPU, for the
port package of a given checkout: a stage-1 step (batch 1: encode, decode
on the fused tail, l2 loss, backward, Adam) and a phase-2 calibration step
(batch 2, ``fq_impl`` jnp and pallas), each as its training loop runs it,
with no synchronize between steps. Per step: ms over 20 steps back to back
(one synchronize at the end), and from a profiler window of 5 steps the
card's busy ms, its idle share and the host's waits for the card inside
a step (``cudaStreamSynchronize``: a copy between host and card, an
``.item()``).

The steps use only what every checkout since the calibration slice has, so
with the parent commit unpacked by ``git archive`` into a directory, calls
in turns (parent, change, change, parent) in one session compare two
commits on one card. Needs one NVIDIA GPU and nvcc.

  python3 scripts/torch_train_step.py [--root DIR] [--steps 20]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _window(torch, step, n: int = 5):
    """(busy ms, idle share, stream synchronisations) per step over n
    steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, syncs = 0.0, 0
    for e in prof.key_averages():
        if e.key == "cudaStreamSynchronize":
            syncs += e.count
        # kernels and copies; annotated ranges span kernels counted already
        if (getattr(e, "device_type", None) == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            busy += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3
    return busy / n, 1 - busy / wall, syncs / n


def _time(torch, step, steps: int) -> float:
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    import chip_smoke
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.models import build_model, tail_plan_for
    from neuroquant_tpu_torch.ops import tail_fused as tf
    from neuroquant_tpu_torch.quantization import (
        adaround_upgrade, init_quant_state, make_spec)
    from neuroquant_tpu_torch.quantization.calibrate import make_loss
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy
    from neuroquant_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        print("torch_train_step: needs one CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    print(chip_smoke._card_line())
    print(f"package: {os.path.dirname(os.path.dirname(tf.__file__))}")
    cfg = validate_config(get_config(os.path.join(
        HERE, "configs", "HNeRV", "Bunny_1280x640_3M.yaml")), "hnerv")
    rng = np.random.RandomState(chip_smoke.SEED)
    model = build_model("hnerv", cfg, device=dev)
    sd = chip_smoke._seeded_state_dict(model, rng)
    model.load_state_dict(state_dict_from_numpy(sd, dev), strict=True)
    frames_dir = tempfile.mkdtemp(prefix="nq_train_step_")
    try:
        chip_smoke._write_frames(frames_dir, rng)
        frames = VideoDataSet(cfg, frames_dir, device=dev).frames
    finally:
        shutil.rmtree(frames_dir, ignore_errors=True)

    # stage 1, batch 1
    img = frames[:1].clone()
    opt = torch.optim.Adam(model.parameters(), lr=cfg["learning_rate"],
                           eps=1e-8)

    def stage1():
        opt.zero_grad(set_to_none=True)
        ((model(img) - img) ** 2).mean().backward()
        opt.step()

    rows = [("stage-1 step, batch 1", stage1)]

    # calibration phase 2, batch 2, from the seeded weights
    params = {k: torch.as_tensor(v, device=dev) for k, v in sd.items()}
    model.load_state_dict(params)
    with torch.no_grad():
        emb = model.encode(frames[:2])
    plan, f, ch = tail_plan_for("hnerv", cfg)
    pack = {"gt": tf.pack_targets(frames[:2], plan, f),
            "mask": tf.border_mask(plan, ch=ch, device=dev),
            "denom": cfg["crop_h"] * cfg["crop_w"]}
    for fq_impl in ("jnp", "pallas"):
        spec = make_spec("hnerv", cfg, channel_wise=True, scale_method="max",
                         hadamard=True, fq_impl=fq_impl).with_bits(
                             chip_smoke.PRECISION)
        state = adaround_upgrade(params, spec, init_quant_state(params, spec))
        st = {ln: {k: v.clone().requires_grad_(k.endswith("alpha"))
                   for k, v in s.items()} for ln, s in state.items()}
        copt = torch.optim.Adam([v for s in st.values() for v in s.values()
                                 if v.requires_grad], lr=0.003, eps=1e-8)
        loss = make_loss(model, params, spec, "adaround", 2.0, pack)

        def calib(st=st, copt=copt, loss=loss):
            copt.zero_grad(set_to_none=True)
            loss(st, pack["gt"], emb, 1)[0].backward()
            copt.step()

        rows.append((f"calibration step, batch 2, fq_impl {fq_impl}", calib))

    for name, step in rows:
        ms = _time(torch, step, args.steps)
        busy, idle, syncs = _window(torch, step)
        print(f"{name}: {ms:.3f} ms a step ({args.steps} back to back); "
              f"device busy {busy:.3f} ms, idle {100 * idle:.1f}%, "
              f"{syncs:g} stream synchronisations a step (profiled)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
