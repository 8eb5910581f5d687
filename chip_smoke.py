#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU, at HNeRV Bunny-3M
(640x1280, configs/HNeRV/Bunny_1280x640_3M.yaml) with seeded random weights.

  python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero):
  1. build  -- compile neuroquant_tpu_torch/csrc/*.cu with nvcc (sm_90a)
  2. kernels -- every kernel of the decode path against its plain PyTorch
     version on the card, at the shapes the decode gives it; times of the
     kernel, the plain version and one PyTorch library call of the same
     function (CUDA events, fp32, TF32 off)
  3. decode -- 4 embeddings through the kernel path and the plain unpacked
     path; they must agree, with 4 tail_conv_cf, 2 pack_cf and 1
     unpack_frames launches per decode
  4. serving -- a quantized artifact (Hadamard, channel-wise, max scales,
     precision 6 5 4 5 5 6 6) evaluated through
     ``neuroquant_tpu_torch.methods.eval_quantized.main`` on 8 seeded
     1280x720 PNG frames, with --eval_fps

The second-to-last line is one JSON object with each kernel's launches on
the serving run, its largest error against the plain version, and its
times and bound summed over the launches of one decode (per-launch figures
under "per_launch"); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import logging
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
SEED = 0
N_FRAMES = 8
PRECISION = [6, 5, 4, 5, 5, 6, 6]
CONV_TOL = 1e-4      # relative to the output's max |value|: fp32, other order
DECODE_TOL = 1e-4    # absolute on frames in [0, 1]
REPO = os.path.dirname(os.path.abspath(__file__))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _seeded_state_dict(model, rng):
    """numpy state dict with the reference key names: U(+-1/sqrt(fan_in))
    weights, small biases, LayerNorm scales near 1, gamma 0.1."""
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


def _kernel_phase(torch, tf, cfg, model):
    """Every kernel at the decode's shapes vs its plain version; returns
    per-kernel records (launches filled in later)."""
    import torch.nn.functional as F

    from neuroquant_tpu_torch.models.layers import collect_tail_params

    dev = torch.device("cuda")
    t = model.pack_start
    pre = model.blocks[t - 1]
    ph, pw = cfg["crop_h"] // 16, cfg["crop_w"] // 16      # 40 x 80
    pkern, pbias = pre.conv_params()
    pplan = tf._prefix_plan(ph, pw, pkern.shape[0], pkern.shape[2],
                            pkern.shape[3])
    blocks, head = collect_tail_params(model.blocks, model.head_layer, t)
    plan, kks, bms, f, ch = tf.plan_and_pack(ph * 4, pw * 4, blocks, head)
    wrel, brel = tf._relabel(pkern, pbias, pre.stride)
    pl0 = pplan.layers[0]
    pkk = tf._pad_kk(wrel, pl0.cin, pl0.cout).contiguous()
    pbm = torch.nn.functional.pad(brel, (0, pl0.cout - brel.shape[0]))
    pbm = pbm.reshape(pl0.cout, 1)

    def cf_input(p, cin):
        x = torch.randn((1, cin, p.mp), generator=gen, device=dev)
        return (x * tf.border_mask(p, device=dev)).contiguous()

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # (name, plan, layer, kk, bias, main-path emit, real cin, real cout,
    #  library conv: (input NCHW shape, weight OIHW shape, padding))
    convs = [
        ("prefix", pplan, pl0, pkk, pbm, "z", 64, 848,
         ((1, 64, ph, pw), (848, 64, 5, 5), 2)),
        ("tail L0", plan, plan.layers[0], kks[0], bms[0], "y", 53, 176,
         ((1, 53, ph * 4, pw * 4), (176, 53, 5, 5), 2)),
        ("tail L1", plan, plan.layers[1], kks[1], bms[1], "y", None, None,
         ((1, 44, ph * 8, pw * 8), (148, 44, 5, 5), 2)),
        ("head", plan, plan.layers[2], kks[2], bms[2], "z", None, None,
         ((1, 37, ph * 16, pw * 16), (3, 37, 3, 3), 1)),
    ]
    records = {k: {"per_launch": [], "max_abs_err": 0.0}
               for k in ("tail_conv_cf", "pack_cf", "unpack_frames")}
    with torch.no_grad():
        for name, p, layer, kk, bias, emit, cin, cout, lib in convs:
            x = cf_input(p, layer.cin)
            # the operand the decode packs once per model (HNeRV keeps it)
            w_op = tf.conv_w_operand(kk, p, layer)
            for em, act in (("z", False), ("y", False), ("z", True),
                            ("y", True)):
                ref = tf.conv_cf_ref(x, kk, bias, p, layer, em, act)
                out = tf.conv_cf(x, kk, bias, p, layer, em, act, w_op)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                tol = CONV_TOL * max(1.0, float(ref.abs().max()))
                print(f"  tail_conv_cf {name} {layer.cin}->{layer.cout} "
                      f"k{layer.side} emit={em} act_in={act}: max_abs_err "
                      f"{err:.3e} (tol {tol:.1e})")
                assert err <= tol, (name, em, act, err, tol)
                records["tail_conv_cf"]["max_abs_err"] = max(
                    records["tail_conv_cf"]["max_abs_err"], err)
            ms = _time_ms(lambda: tf.conv_cf(x, kk, bias, p, layer, emit,
                                             w_op=w_op))
            plain_ms = _time_ms(lambda: tf.conv_cf_ref(x, kk, bias, p, layer,
                                                       emit), iters=5)
            xs, ws, pad = lib
            xl = torch.randn(xs, generator=gen, device=dev)
            wl = torch.randn(ws, generator=gen, device=dev) * 0.05
            bl = torch.zeros(ws[0], device=dev)
            lib_ms = _time_ms(lambda: F.conv2d(xl, wl, bl, padding=pad))
            flops = tf.conv_cf_flops(p, layer, 1, cin, cout)
            nbytes = 4 * (x.numel() + kk.numel() + layer.cout
                          + layer.cout * p.mp)
            bound_ms, by = _bound(nbytes, flops)
            records["tail_conv_cf"]["per_launch"].append(dict(
                shape=f"{name} {layer.cin}->{layer.cout} k{layer.side} "
                      f"grid {p.h}x{p.w} emit={emit}",
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, gflop=flops / 1e9,
                mbytes=nbytes / 1e6))
            print(f"  tail_conv_cf {name}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                  f"F.conv2d {lib_ms:.4f}, bound {bound_ms:.4f} by {by}; "
                  f"{flops / 1e9:.2f} GFLOP -> "
                  f"{flops / ms / 1e9:.2f} TFLOP/s)")

        for name, p, hw, c in (("prefix entry", pplan, (ph, pw), 64),
                               ("tail entry", plan, (ph * 4, pw * 4), 53)):
            x = torch.randn((1, *hw, c), generator=gen, device=dev)
            ref, out = tf.pack_cf_ref(x, p), tf.pack_cf(x, p)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            print(f"  pack_cf {name} {tuple(x.shape)} -> {tuple(out.shape)}: "
                  f"max_abs_err {err:.3e} (tol 0, a copy)")
            assert err == 0.0, (name, err)
            ms = _time_ms(lambda: tf.pack_cf(x, p))
            plain_ms = _time_ms(lambda: tf.pack_cf_ref(x, p))
            lib_ms = _time_ms(lambda: x.permute(0, 3, 1, 2).contiguous())
            bound_ms, by = _bound(4 * (x.numel() + out.numel()), 0)
            records["pack_cf"]["per_launch"].append(dict(
                shape=f"{name} {tuple(x.shape)}->{tuple(out.shape)}", ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=by, mbytes=4 * (x.numel() + out.numel()) / 1e6))
            print(f"  pack_cf {name}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                  f"permute+contiguous {lib_ms:.4f}, bound {bound_ms:.4f})")

        z = torch.randn((1, plan.layers[-1].cout, plan.mp), generator=gen,
                        device=dev)
        for ob in ("tanh", "sigmoid", "0.5"):
            ref = tf.unpack_frames_ref(z, plan, f, ch, ob)
            out = tf.unpack_frames(z, plan, f, ch, ob)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            print(f"  unpack_frames out_bias={ob} -> {tuple(out.shape)}: "
                  f"max_abs_err {err:.3e} (tol 1e-6)")
            assert err <= 1e-6, (ob, err)
            records["unpack_frames"]["max_abs_err"] = max(
                records["unpack_frames"]["max_abs_err"], err)
        ob = cfg["out_bias"]
        ms = _time_ms(lambda: tf.unpack_frames(z, plan, f, ch, ob))
        plain_ms = _time_ms(lambda: tf.unpack_frames_ref(z, plan, f, ch, ob))
        zl = torch.randn((1, ch, plan.h, plan.w), generator=gen, device=dev)
        lib_ms = _time_ms(lambda: F.pixel_shuffle(zl, f))
        nbytes = 4 * (ch * plan.h * plan.w + out.numel())
        bound_ms, by = _bound(nbytes, 0)
        records["unpack_frames"]["per_launch"].append(dict(
            shape=f"{tuple(z.shape)}->{tuple(out.shape)} out_bias={ob}",
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=by, mbytes=nbytes / 1e6))
        print(f"  unpack_frames: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"pixel_shuffle {lib_ms:.4f}, bound {bound_ms:.4f})")
    return records


def _decode_phase(torch, tf, cfg, sd, model):
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    dev = torch.device("cuda")
    plain = build_model("hnerv", dict(cfg, packed_tail="off"), device=dev)
    plain.load_state_dict(state_dict_from_numpy(sd, dev), strict=True)
    assert plain.pack_start is None and model.pack_start == 3
    eh, ew = model.cfg.embed_hw                          # 2 x 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    embeds = torch.randn((4, eh, ew, cfg["enc_channel"][-1]), generator=gen,
                         device=dev)
    with torch.no_grad():
        tf.reset_launch_counts()
        outs = [model.decode(embeds[i:i + 1]) for i in range(4)]
        torch.cuda.synchronize()
        counts = dict(tf.KERNEL_LAUNCHES)
        refs = [plain.decode(embeds[i:i + 1]) for i in range(4)]
        torch.cuda.synchronize()
        err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
        for o in outs:
            assert o.shape == (1, cfg["crop_h"], cfg["crop_w"], 3), o.shape
            assert bool(torch.isfinite(o).all())
        print(f"  4 decodes: kernel path vs plain unpacked path max_abs_err "
              f"{err:.3e} (tol {DECODE_TOL:.0e}); launches {counts}")
        assert err <= DECODE_TOL, err
        assert counts == {"tail_conv_cf": 16, "pack_cf": 8,
                          "unpack_frames": 4}, counts
        e1 = embeds[:1]
        k_ms = _time_ms(lambda: model.decode(e1), iters=20)
        p_ms = _time_ms(lambda: plain.decode(e1), iters=20)
    print(f"  decode latency (batch 1): kernel path {k_ms:.3f} ms, "
          f"plain unpacked path {p_ms:.3f} ms")
    return dict(decode_ms=k_ms, plain_decode_ms=p_ms, max_abs_err=err,
                launches=counts)


def _write_frames(path: str, rng):
    from PIL import Image

    yy, xx = np.mgrid[0:720, 0:1280].astype(np.float32)
    for t in range(N_FRAMES):
        img = np.stack([xx / 1280, yy / 720,
                        np.full_like(xx, 0.5 + 0.4 * math.sin(t))], -1)
        img = np.clip(img + 0.05 * rng.randn(720, 1280, 3), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(path, f"{t + 1:04d}.png"))


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _serving_phase(torch, tf, cfg, sd, card, rng):
    from neuroquant_tpu_torch.methods import eval_quantized
    from neuroquant_tpu_torch.quantization.qmodel import init_quant_state
    from neuroquant_tpu_torch.quantization.spec import make_spec
    from neuroquant_tpu_torch.utils.convert import (
        quant_state_to_numpy, state_dict_from_numpy)

    spec = make_spec("hnerv", cfg, channel_wise=True, scale_method="max",
                     hadamard=True).with_bits(PRECISION)
    state = init_quant_state(state_dict_from_numpy(sd, "cuda"), spec)
    artifact = {
        "arch": "hnerv", "mode": "uaq", "cfg": cfg, "state_dict": sd,
        "quant_spec": {
            "layer_names": spec.layer_names, "layer_paths": spec.layer_paths,
            "n_bits": spec.n_bits, "channel_wise": spec.channel_wise,
            "scale_method": spec.scale_method, "hadamard": spec.hadamard,
            "sym": spec.sym},
        "quant_state": quant_state_to_numpy(state),
    }
    tmp = tempfile.mkdtemp(prefix="nq_chip_smoke_")
    try:
        frames = os.path.join(tmp, "frames")
        os.makedirs(frames)
        _write_frames(frames, rng)
        art = os.path.join(tmp, "artifact.pth")
        with open(art, "wb") as f:
            pickle.dump(artifact, f)
        # the stdout handler eval_quantized would install, installed first,
        # so that its INFO lines both print and reach the capture
        logging.basicConfig(stream=sys.stdout, level=logging.INFO)
        cap = _Capture()
        logging.getLogger().addHandler(cap)
        tf.reset_launch_counts()
        t0 = time.time()
        results = eval_quantized.main(["--artifact", art, "--data_path",
                                       frames, "--eval_fps"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(tf.KERNEL_LAUNCHES)
        logging.getLogger().removeHandler(cap)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    psnr, msssim = float(results[0]), float(results[1])
    assert math.isfinite(psnr) and math.isfinite(msssim), results
    assert 0.0 < msssim <= 1.0, msssim
    fps_lines = [m for m in cap.lines if "decode throughput" in m]
    fps = float(re.search(r"throughput: ([0-9.]+) FPS", fps_lines[-1])[1])
    print(f"  eval_quantized on {N_FRAMES} frames: PSNR {psnr:.4f} dB, "
          f"MS-SSIM {msssim:.6f}, {wall:.2f} s wall; launches {launches}")
    print(f"  decode FPS (batch 1, eval_quantized --eval_fps): {fps} on "
          f"{card}")
    return dict(psnr=psnr, msssim=msssim, fps=fps, launches=launches)


def main() -> int:
    import torch

    # the package first: a copy of this script without the repository
    # fails here, with or without a card
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.ops import _cuda
    from neuroquant_tpu_torch.ops import tail_fused as tf
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy
    from neuroquant_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    resolve_device("cuda")          # the port's entry points turn TF32 off
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    assert tf32 == (False, False), tf32
    card = _card_line()
    print(card)
    print(f"card: {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | TF32 off "
          f"(cudnn.allow_tf32={tf32[0]}, cuda.matmul.allow_tf32={tf32[1]}, "
          f"set by resolve_device)")
    t_start = time.time()

    print("[build]")
    t0 = time.time()
    _cuda.build()
    _cuda.lib()
    print(f"  kernels built/loaded in {time.time() - t0:.2f} s "
          f"(nvcc wall {_cuda.BUILD_INFO['seconds']})")
    for line in _cuda.BUILD_INFO["log"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("   ", line.strip())

    cfg = validate_config(get_config(os.path.join(
        REPO, "configs", "HNeRV", "Bunny_1280x640_3M.yaml")), "hnerv")
    cfg["workers"] = 0
    rng = np.random.RandomState(SEED)
    model = build_model("hnerv", cfg, device="cuda")
    sd = _seeded_state_dict(model, rng)
    model.load_state_dict(state_dict_from_numpy(sd, "cuda"), strict=True)
    model.eval()

    print("[kernels]")
    records = _kernel_phase(torch, tf, cfg, model)
    print("[decode]")
    dec = _decode_phase(torch, tf, cfg, sd, model)
    print("[serving]")
    serve = _serving_phase(torch, tf, cfg, sd, card, rng)

    sources = {"tail_conv_cf": ("neuroquant_tpu_torch/csrc/tail_conv_cf.cu",
                                "neuroquant_tpu/ops/tail_fused.py:1133"),
               "pack_cf": ("neuroquant_tpu_torch/csrc/pack_cf.cu",
                           "neuroquant_tpu/ops/tail_fused.py:656"),
               "unpack_frames": ("neuroquant_tpu_torch/csrc/unpack_frames.cu",
                                 "neuroquant_tpu/ops/tail_fused.py:2016")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = records[name]
        per = r["per_launch"]
        # per decode: the pack runs at both entries, the conv at 4 layers
        t_ops = sum(p["bound_ms"] for p in per if p["bound_by"] == "operations")
        t_bytes = sum(p["bound_ms"] for p in per if p["bound_by"] == "bytes")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": serve["launches"][name],
            "max_abs_err": r["max_abs_err"],
            "ms": sum(p["ms"] for p in per),
            "plain_ms": sum(p["plain_ms"] for p in per),
            "bound_ms": sum(p["bound_ms"] for p in per),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": sum(p["library_ms"] for p in per),
            "per_decode_launches": dec["launches"][name] // 4,
            "per_launch": per})
    for k in kernels:
        assert k["launches"] > 0, k["name"]
    print(f"  total {time.time() - t_start:.1f} s after start; decode "
          f"{dec['decode_ms']:.3f} ms/frame kernel path, "
          f"{dec['plain_decode_ms']:.3f} plain; card {card}")
    print(json.dumps({"card": card, "decode": dec, "serving": serve}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
