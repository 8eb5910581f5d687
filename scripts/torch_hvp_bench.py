#!/usr/bin/env python3
"""Stage 2's Hessian-vector product at HNeRV Bunny-3M (640x1280, seeded
random weights, batch 2) on one NVIDIA GPU: the port's two routes
(``fused_tail: pallas_hvp``, the fused tail's kernels carrying the tangent;
``off``, the plain unpacked decode on cuDNN), each against the plain route
in float64, and their times.

  python3 scripts/torch_hvp_bench.py [--reps N] [--out FILE]
  python3 scripts/torch_hvp_bench.py --remat hnerv pnerv [--reps N]

Per route: seconds per HVP batch (host clock around a synchronised call,
median of --reps after one warm-up), peak device memory, the card's busy
time per batch and its 12 costliest kernels (torch.profiler), its
launches; per leaf (the seven
quantized kernels) max|Hv - Hv_fp64| / max|Hv_fp64|, and the omega score
v . Hv against float64's, relative to sum |Hv * v|. The perturbation v is
that of the toy candidate 6 5 4 5 5 6 6 (channel-wise, max scales), as
``chip_smoke.py`` takes it. Prints the card's name and power limit first
and writes the rows as JSON to --out.

With --remat ARCH [ARCH ...] (hnerv, pnerv: PNeRV1 Bunny-3M,
configs/PNeRV/Bunny_1280x640_3M.yaml, its bf16 fusion stages as shipped)
it measures ``bit_assign --remat`` instead: per arch, one batch-2 HVP on
the kernel route (``pallas_hvp``) in three variants: without remat (the
default), without remat but the tail's tangent GELU in pieces (what
``--remat`` adds to the segments, alone), and with remat (the decode
checkpointed in segments, the tail layer by layer, the GELU in pieces); in
turns (off, pieces, on, on, pieces, off), each turn's peak device memory
(over what the model and inputs hold before it) and seconds per batch
(median of --reps), and max|Hv_variant - Hv| / max|Hv| per leaf.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _seeded_state_dict(model, rng):
    """chip_smoke.py's seeded weights: U(+-1/sqrt(fan_in)), small biases,
    LayerNorm scales near 1, gamma 0.1."""
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("gamma"):
            a = np.full(shape, 0.1)
        elif len(shape) >= 2:
            b = 1.0 / math.sqrt(int(np.prod(shape[1:])))
            a = rng.uniform(-b, b, shape)
        elif k.endswith("weight"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = 0.02 * rng.randn(*shape)
        sd[k] = a.astype(np.float32)
    return sd


def _profile(torch, fn):
    """(the card's busy ms of one call, its top 12 kernels by device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
                    e.count, e.key[:90]) for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    return (busy if busy > 0 else None), rows[:12]


FOLDERS = {"hnerv": "HNeRV", "pnerv": "PNeRV"}
PATTERN = (6, 5, 4, 5, 5, 6, 6)   # the toy candidate, over PNeRV's 19


@contextlib.contextmanager
def _variant(variant):
    """The decode's segment runner for one variant: 'pieces' keeps the
    segments as they are without remat but runs the tail's tangent GELU in
    pieces, as ``--remat`` does; 'off' and 'on' are ``remat`` False and
    True, as shipped."""
    from neuroquant_tpu_torch.models import decoder, pnerv
    from neuroquant_tpu_torch.ops.tail_fused import PIECE

    shipped = decoder.segment_runner
    if variant == "pieces":
        decoder.segment_runner = pnerv.segment_runner = (
            lambda remat: (decoder._run, PIECE))
    try:
        yield
    finally:
        decoder.segment_runner = pnerv.segment_runner = shipped


def _remat_rows(torch, arch, dev, card, reps):
    """One batch-2 HVP at `arch` Bunny-3M on the kernel route, in the three
    variants of :func:`_variant` in turns: peak memory, seconds, Hv
    agreement."""
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization import (
        get_perturbation, hessian_vector_product, init_quant_state,
        make_spec)
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    cfg = validate_config(get_config(os.path.join(
        HERE, "configs", FOLDERS[arch], "Bunny_1280x640_3M.yaml")), arch)
    rng = np.random.RandomState(0)
    model = build_model(arch, dict(cfg, fused_tail="pallas_hvp"), device=dev)
    sd = state_dict_from_numpy(_seeded_state_dict(model, rng), dev)
    model.load_state_dict(sd, strict=True)
    frames = torch.from_numpy(rng.rand(2, 640, 1280, 3).astype(
        np.float32)).to(dev)
    n = len(model.jvp_keys())
    spec = make_spec(arch, cfg, channel_wise=True, scale_method="max"
                     ).with_bits([PATTERN[i % len(PATTERN)]
                                  for i in range(n)])
    vec = get_perturbation(sd, spec, init_quant_state(sd, spec))
    batch = [[0, 1]]
    hv, turns = {}, []
    for variant in ("off", "pieces", "on", "on", "pieces", "off"):
        def run():
            with _variant(variant):
                return hessian_vector_product(
                    model, spec, vec, frames, None, batch,
                    remat=variant == "on")
        hv[variant] = run()                 # warm-up (and the kernel build)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**20
        turns.append(dict(variant=variant, seconds=sorted(secs),
                          median_s=float(np.median(secs)), peak_mib=peak,
                          held_mib=held))
        print(f"  {arch} {variant}: {np.median(secs):.4f} s a batch "
              f"(median of {reps}; {min(secs):.4f}-{max(secs):.4f}), peak "
              f"{peak:.1f} MiB ({held:.1f} MiB held before); {card}")
    err = {}
    for variant in ("pieces", "on"):
        err[variant] = [float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(hv[variant], hv["off"])]
        print(f"  {arch} Hv {variant} against off: leaf max|diff| / max|Hv| "
              f"{' '.join(f'{e:.2e}' for e in err[variant])}")
    return dict(arch=arch, card=card, turns=turns, leaf_rel_err=err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(HERE, "results",
                                                  "hvp_bench.json"))
    ap.add_argument("--remat", nargs="+", default=None,
                    choices=["hnerv", "pnerv"],
                    help="measure --remat's peak and time at these archs")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_hvp_bench: needs one CUDA device", file=sys.stderr)
        return 2
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.ops import tail_fused as tf
    from neuroquant_tpu_torch.quantization import (
        get_perturbation, hessian_vector_product, init_quant_state,
        make_spec)
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy
    from neuroquant_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")            # TF32 off, as the entry points
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    if args.remat:
        rows = [_remat_rows(torch, arch, dev, card, args.reps)
                for arch in args.remat]
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        return 0
    cfg = validate_config(get_config(os.path.join(
        HERE, "configs", "HNeRV", "Bunny_1280x640_3M.yaml")), "hnerv")
    rng = np.random.RandomState(0)
    base = build_model("hnerv", cfg, device=dev)
    sd = state_dict_from_numpy(_seeded_state_dict(base, rng), dev)
    del base
    frames = torch.from_numpy(rng.rand(2, 640, 1280, 3).astype(
        np.float32)).to(dev)
    spec = make_spec("hnerv", cfg, channel_wise=True,
                     scale_method="max").with_bits((6, 5, 4, 5, 5, 6, 6))
    vec = get_perturbation(sd, spec, init_quant_state(sd, spec))
    batch = [[0, 1]]
    rows, hv = [], {}
    for route, ft, dtype in (("pallas_hvp", "pallas_hvp", torch.float32),
                             ("off", "off", torch.float32),
                             ("off fp64", "off", torch.float64)):
        model = build_model("hnerv", dict(cfg, fused_tail=ft), device=dev)
        model.load_state_dict(sd, strict=True)
        model.to(dtype)
        v = [t.to(dtype) for t in vec]
        x = frames.to(dtype)

        def run():
            return hessian_vector_product(model, spec, v, x, None, batch)

        hv[route] = run()                   # warm-up (and the kernel build)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tf.reset_launch_counts()
        secs = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = {k: n // args.reps for k, n in tf.KERNEL_LAUNCHES.items()
                    if n}
        busy, top = _profile(torch, run)
        row = dict(route=route, card=card, seconds=sorted(secs),
                   median_s=float(np.median(secs)),
                   peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                   busy_ms=busy, launches=launches, top=top)
        rows.append(row)
        print(f"  {route}: {row['median_s']:.4f} s a batch (median of "
              f"{args.reps}; {min(secs):.4f}-{max(secs):.4f}), card busy "
              f"{row['busy_ms']} ms, peak {row['peak_mib']:.1f} MiB, "
              f"launches {launches}; by kernel:")
        for ms, n, key in top:
            print(f"    {ms:9.4f} ms x{n:<4d} {key}")
        del model
    ref = [t.double() for t in hv["off fp64"]]
    v64 = [t.double() for t in vec]
    for row in rows[:2]:
        got = [t.double() for t in hv[row["route"]]]
        row["leaf_rel_err"] = [float((a - b).abs().max() / b.abs().max())
                               for a, b in zip(got, ref)]
        row["omega_rel_err"] = [
            float(((a - b) * v).sum().abs() / (b * v).abs().sum())
            for a, b, v in zip(got, ref, v64)]
        print(f"  {row['route']} against float64: leaf max|diff| / max|Hv| "
              + " ".join(f"{e:.2e}" for e in row["leaf_rel_err"])
              + "; omega |diff| / sum|Hv*v| "
              + " ".join(f"{e:.2e}" for e in row["omega_rel_err"]))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
