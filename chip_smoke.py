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
  3. kernels of the calibration step -- at batch 2: each conv's forward,
     dx pass (GELU' epilogue) and dW pass, and unpack_cf, the same way
  4. decode -- 4 embeddings through the kernel path and the plain unpacked
     path; they must agree, with 4 tail_conv_cf, 2 pack_cf and 1
     unpack_frames launches per decode
  5. serving -- a quantized artifact (Hadamard, channel-wise, max scales,
     precision 6 5 4 5 5 6 6) evaluated through
     ``neuroquant_tpu_torch.methods.eval_quantized.main`` on 8 seeded
     1280x720 PNG frames, with --eval_fps
  6. calibration step -- one phase-2 step's loss and gradients, kernel
     path against the plain unpacked path; its launches; its forward,
     backward and optimizer times; a profiler window
  7. calibrate -- ``neuroquant_tpu_torch.methods.calibrate_network.main``
     at Bunny-3M on the 8 frames from a .pth of the seeded weights, batch 2,
     80 steps (1 phase-1 and 19 phase-2 epochs): every step's launches (8
     tail_conv_cf, 4 tail_conv_dw_cf, 2 pack_cf, 2 unpack_cf), finite
     state, both guards, and the artifact read back by eval_quantized

The second-to-last line is one JSON object per kernel: its launches over
the calibrate_network run, its largest error against the plain version,
and its times and bound summed over one decode's launches (the decode's
kernels) or one calibration step's (tail_conv_dw_cf, unpack_cf); per-launch
figures under "per_launch". The last line is {"ok": true, "device": ...}.
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
CALIB_BATCH = 2
CALIB_ITERS = 80     # batch 2 over 8 frames: 1 phase-1 and 19 phase-2 epochs
# a calibration step's launches: 4 convs forward and 4 dx passes (the fused
# prefix block and the tail's three layers), their 4 dW passes, the two
# entries' pack_cf and its backward; the packed loss needs no unpack
PER_STEP = {"tail_conv_cf": 8, "tail_conv_dw_cf": 4, "pack_cf": 2,
            "unpack_cf": 2, "unpack_frames": 0}
# one step's gradients, kernel path vs the plain unpacked path (cuDNN): fp32
# sums over ~1e5 positions in other orders through 7 layers; of each
# leaf's largest |gradient|
GRAD_TOL = 1e-3
LOSS_TOL = 1e-5      # relative
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


def _conv_layers(torch, tf, cfg, model):
    """The four conv layers of the kernel path at HNeRV Bunny-3M: (name,
    plan, layer, kk, bias, real cin, real cout, library conv: (input NCHW
    shape at batch 1, weight OIHW shape, padding))."""
    from neuroquant_tpu_torch.models.layers import collect_tail_params

    t = model.pack_start
    pre = model.blocks[t - 1]
    ph, pw = cfg["crop_h"] // 16, cfg["crop_w"] // 16      # 40 x 80
    pkern, pbias = pre.conv_params()
    pplan = tf._prefix_plan(ph, pw, pkern.shape[0], pkern.shape[2],
                            pkern.shape[3])
    blocks, head = collect_tail_params(model.blocks, model.head_layer, t)
    with torch.no_grad():
        plan, kks, bms, f, ch = tf.plan_and_pack(ph * 4, pw * 4, blocks,
                                                 head)
        wrel, brel = tf._relabel(pkern, pbias, pre.stride)
        pl0 = pplan.layers[0]
        pkk = tf._pad_kk(wrel, pl0.cin, pl0.cout).contiguous()
        pbm = torch.nn.functional.pad(brel, (0, pl0.cout - brel.shape[0]))
        pbm = pbm.reshape(pl0.cout, 1)
    convs = [
        ("prefix", pplan, pl0, pkk, pbm, 64, 848,
         ((1, 64, ph, pw), (848, 64, 5, 5), 2)),
        ("tail L0", plan, plan.layers[0], kks[0], bms[0], 53, 176,
         ((1, 53, ph * 4, pw * 4), (176, 53, 5, 5), 2)),
        ("tail L1", plan, plan.layers[1], kks[1], bms[1], None, None,
         ((1, 44, ph * 8, pw * 8), (148, 44, 5, 5), 2)),
        ("head", plan, plan.layers[2], kks[2], bms[2], None, None,
         ((1, 37, ph * 16, pw * 16), (3, 37, 3, 3), 1)),
    ]
    return convs, pplan, plan, f, ch


def _cf_input(torch, tf, p, cin, gen, batch=1):
    x = torch.randn((batch, cin, p.mp), generator=gen, device="cuda")
    return (x * tf.border_mask(p, device="cuda")).contiguous()


def _kernel_phase(torch, tf, cfg, model):
    """Every kernel at the decode's shapes vs its plain version; returns
    per-kernel records (launches filled in later)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    ph, pw = cfg["crop_h"] // 16, cfg["crop_w"] // 16
    convs, pplan, plan, f, ch = _conv_layers(torch, tf, cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def cf_input(p, cin):
        return _cf_input(torch, tf, p, cin, gen)

    records = {k: {"per_launch": [], "max_abs_err": 0.0}
               for k in ("tail_conv_cf", "pack_cf", "unpack_frames")}
    emits = {"prefix": "z", "tail L0": "y", "tail L1": "y", "head": "z"}
    with torch.no_grad():
        for name, p, layer, kk, bias, cin, cout, lib in convs:
            emit = emits[name]
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
        # a plan whose JAX unpack is the width-tiled _unpack_kernel5 (f=4,
        # w=480 -> 240-wide tiles): the one kernel covers it
        wplan, wf = tf.plan_geometry(4, 480, [(3, 17, 224, 4)], (3, 14, 3))
        zw = torch.randn((2, wplan.layers[-1].cout, wplan.mp), generator=gen,
                         device=dev)
        outw = tf.unpack_frames(zw, wplan, wf, 48, "tanh")
        err = float((outw - tf.unpack_frames_ref(zw, wplan, wf, 48, "tanh"))
                    .abs().max())
        print(f"  unpack_frames width-tiled plan (f=4, w=480): max_abs_err "
              f"{err:.3e} (tol 1e-6)")
        assert err <= 1e-6, err
        records["unpack_frames"]["max_abs_err"] = max(
            records["unpack_frames"]["max_abs_err"], err)
        zwl = torch.randn((2, 48, wplan.h, wplan.w), generator=gen, device=dev)
        nbytes = 4 * (zwl.numel() + outw.numel())
        bound_ms, by = _bound(nbytes, 0)
        records["unpack_frames"]["width_tiled"] = dict(
            shape=f"{tuple(zw.shape)}->{tuple(outw.shape)} out_bias=tanh",
            ms=_time_ms(lambda: tf.unpack_frames(zw, wplan, wf, 48, "tanh")),
            plain_ms=_time_ms(lambda: tf.unpack_frames_ref(zw, wplan, wf, 48,
                                                           "tanh")),
            library_ms=_time_ms(lambda: F.pixel_shuffle(zwl, wf)),
            bound_ms=bound_ms, bound_by=by, mbytes=nbytes / 1e6)
        print(f"  unpack_frames width-tiled plan: "
              f"{records['unpack_frames']['width_tiled']}")
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
        assert counts == {"tail_conv_cf": 16, "tail_conv_dw_cf": 0,
                          "pack_cf": 8, "unpack_cf": 0,
                          "unpack_frames": 4}, counts
        e1 = embeds[:1]
        k_ms = _time_ms(lambda: model.decode(e1), iters=20)
        p_ms = _time_ms(lambda: plain.decode(e1), iters=20)
    print(f"  decode latency (batch 1): kernel path {k_ms:.3f} ms, "
          f"plain unpacked path {p_ms:.3f} ms")
    return dict(decode_ms=k_ms, plain_decode_ms=p_ms, max_abs_err=err,
                launches=counts)


def _backward_kernel_phase(torch, tf, cfg, model):
    """The calibration step's kernels at Bunny-3M, batch 2, against their
    plain versions: each conv layer's forward as the step runs it (emit z,
    GELU on the input where the layer has it), its dx pass (the transposed
    layer with the GELU' epilogue) and its dW pass; unpack_cf at both
    entries. Library yardsticks: cuDNN's conv2d, conv2d_input and
    conv2d_weight on the unpacked convs; permute().contiguous()."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    B = CALIB_BATCH
    ph, pw = cfg["crop_h"] // 16, cfg["crop_w"] // 16
    convs, pplan, plan, _, _ = _conv_layers(torch, tf, cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    records = {k: {"per_launch": [], "max_abs_err": 0.0}
               for k in ("tail_conv_cf", "tail_conv_dw_cf", "unpack_cf")}

    def check(kname, what, got, want):
        err = float((got - want).abs().max())
        tol = CONV_TOL * max(1.0, float(want.abs().max()))
        print(f"  {kname} {what}: max_abs_err {err:.3e} (tol {tol:.1e})")
        assert err <= tol, (kname, what, err, tol)
        records[kname]["max_abs_err"] = max(records[kname]["max_abs_err"],
                                            err)

    def record(kname, shape, fn, plain, lib, nbytes, flops):
        ms = _time_ms(fn, iters=10)
        plain_ms = _time_ms(plain, iters=3, warmup=1)
        lib_ms = _time_ms(lib, iters=10)
        bound_ms, by = _bound(nbytes, flops)
        records[kname]["per_launch"].append(dict(
            shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by, gflop=flops / 1e9,
            mbytes=nbytes / 1e6))
        print(f"  {kname} {shape}: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"library {lib_ms:.4f}, bound {bound_ms:.4f} by {by}; "
              f"{flops / 1e9:.2f} GFLOP -> {flops / ms / 1e9:.2f} TFLOP/s)")

    with torch.no_grad():
        for name, p, layer, kk, bias, cin, cout, lib in convs:
            xs, ws, pad = lib
            act = layer.gelu_in
            x = _cf_input(torch, tf, p, layer.cin, gen, B)
            g = _cf_input(torch, tf, p, layer.cout, gen, B)
            flops = tf.conv_cf_flops(p, layer, B, cin, cout)
            xl = torch.randn((B, *xs[1:]), generator=gen, device=dev)
            wl = torch.randn(ws, generator=gen, device=dev) * 0.05
            gl = torch.randn((B, ws[0], *xs[2:]), generator=gen, device=dev)
            geo = (f"{name} {layer.cin}->{layer.cout} k{layer.side} grid "
                   f"{p.h}x{p.w} batch {B}")

            w_op = tf.conv_w_operand(kk, p, layer)
            check("tail_conv_cf", f"forward {geo} emit=z act_in={act}",
                  tf.conv_cf(x, kk, bias, p, layer, "z", act, w_op),
                  tf.conv_cf_ref(x, kk, bias, p, layer, "z", act))
            record("tail_conv_cf", f"forward {geo} emit=z act_in={act}",
                   lambda: tf.conv_cf(x, kk, bias, p, layer, "z", act, w_op),
                   lambda: tf.conv_cf_ref(x, kk, bias, p, layer, "z", act),
                   lambda: F.conv2d(xl, wl, padding=pad),
                   4 * (x.numel() + kk.numel() + layer.cout + g.numel()),
                   flops)

            lt = layer.transposed()
            kt = tf._kk_transpose(kk).contiguous()
            om = x if act else None
            wt_op = tf.conv_w_operand(kt, p, lt)
            dx_geo = f"dx {geo} out_mul={act}"
            check("tail_conv_cf", dx_geo,
                  tf.conv_cf(g, kt, None, p, lt, w_op=wt_op, out_mul=om),
                  tf.conv_cf_ref(g, kt, None, p, lt, out_mul=om))
            record("tail_conv_cf", dx_geo,
                   lambda: tf.conv_cf(g, kt, None, p, lt, w_op=wt_op,
                                      out_mul=om),
                   lambda: tf.conv_cf_ref(g, kt, None, p, lt, out_mul=om),
                   lambda: torch.nn.grad.conv2d_input(xl.shape, wl, gl,
                                                      padding=pad),
                   4 * (g.numel() + kt.numel() + x.numel()
                        * (2 if act else 1)), flops)

            blocks = tf._k_blocks(p, layer)
            dkk, db = tf.conv_cf_dw(x, g, p, layer, act)
            rkk, rdb = tf.conv_cf_dw_ref(x, g, p, layer, act, blocks)
            check("tail_conv_dw_cf", f"dW {geo} act_in={act}", dkk, rkk)
            check("tail_conv_dw_cf", f"db {geo}", db, rdb)
            again = tf.conv_cf_dw(x, g, p, layer, act)[0]
            assert torch.equal(again, dkk), "dW differs from run to run"
            record("tail_conv_dw_cf", f"dW {geo} act_in={act}",
                   lambda: tf.conv_cf_dw(x, g, p, layer, act),
                   lambda: tf.conv_cf_dw_ref(x, g, p, layer, act, blocks),
                   lambda: torch.nn.grad.conv2d_weight(xl, wl.shape, gl,
                                                       padding=pad),
                   4 * (x.numel() + g.numel() + dkk.numel() + db.numel()),
                   flops)

        for name, p, (h, w), c in (("prefix entry", pplan, (ph, pw), 64),
                                   ("tail entry", plan, (ph * 4, pw * 4),
                                    53)):
            g = torch.randn((B, tf._r8(c), p.mp), generator=gen, device=dev)
            out, ref = tf.unpack_cf(g, p, c), tf.unpack_cf_ref(g, p, c)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            shape = f"{name} {tuple(g.shape)}->{tuple(out.shape)}"
            print(f"  unpack_cf {shape}: max_abs_err {err:.3e} (tol 0, a "
                  f"copy)")
            assert err == 0.0, (name, err)
            zl = torch.randn((B, c, h, w), generator=gen, device=dev)
            record("unpack_cf", shape, lambda: tf.unpack_cf(g, p, c),
                   lambda: tf.unpack_cf_ref(g, p, c),
                   lambda: zl.permute(0, 2, 3, 1).contiguous(),
                   4 * 2 * out.numel(), 0)
    return records


def _gradient_phase(torch, tf, cfg, sd, frames_dir):
    """One phase-2 calibration step at Bunny-3M, batch 2: the kernel path
    (decode_cf, packed loss) against the plain unpacked path (packed_tail
    off, NHWC loss, cuDNN, TF32 off) -- the same loss up to a permutation
    of its terms, so the same value and gradients; the step's launches; and
    the step's time split into forward, backward and optimizer, with a
    profiler window for the kernel time by name and the device's busy
    share."""
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.models import build_model, tail_plan_for
    from neuroquant_tpu_torch.quantization import (
        adaround_upgrade, init_quant_state, make_spec)
    from neuroquant_tpu_torch.quantization.calibrate import make_loss
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    dev = torch.device("cuda")
    kern = build_model("hnerv", cfg, device=dev)
    plain = build_model("hnerv", dict(cfg, packed_tail="off"), device=dev)
    for m in (kern, plain):
        m.load_state_dict(state_dict_from_numpy(sd, dev), strict=True)
        m.eval()
    params = {k: v.detach().clone() for k, v in kern.state_dict().items()}
    spec = make_spec("hnerv", cfg, channel_wise=True, scale_method="max",
                     hadamard=True).with_bits(PRECISION)
    state = adaround_upgrade(params, spec, init_quant_state(params, spec))
    frames = VideoDataSet(cfg, frames_dir, device=dev).frames[:CALIB_BATCH]
    with torch.no_grad():
        emb = kern.encode(frames)
    plan, f, ch = tail_plan_for("hnerv", cfg)
    pack = {"gt": tf.pack_targets(frames, plan, f),
            "mask": tf.border_mask(plan, ch=ch, device=dev),
            "denom": cfg["crop_h"] * cfg["crop_w"]}

    def fresh():
        return {ln: {k: v.clone().requires_grad_(k.endswith("alpha"))
                     for k, v in s.items()} for ln, s in state.items()}

    def step(model, pk):
        st = fresh()
        loss = make_loss(model, params, spec, "adaround", 2.0, pk)
        total, _ = loss(st, pk["gt"] if pk else frames, emb, 1)
        total.backward()
        torch.cuda.synchronize()
        return float(total.detach()), {(ln, k): st[ln][k].grad
                                       for ln in st for k in st[ln]
                                       if k.endswith("alpha")}

    tf.reset_launch_counts()
    loss_k, grads_k = step(kern, pack)
    counts = dict(tf.KERNEL_LAUNCHES)
    loss_p, grads_p = step(plain, None)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    worst = max(float((grads_k[key] - grads_p[key]).abs().max())
                / max(float(grads_p[key].abs().max()), 1e-30)
                for key in grads_p)
    print(f"  one step, kernel path vs plain unpacked path: loss {loss_k:.7f} "
          f"vs {loss_p:.7f} (rel {rel_loss:.2e}, tol {LOSS_TOL:.0e}); "
          f"gradients: worst leaf max|diff| / max|grad| {worst:.2e} (tol "
          f"{GRAD_TOL:.0e}); launches {counts}")
    assert counts == PER_STEP, counts
    assert rel_loss <= LOSS_TOL, (loss_k, loss_p)
    assert worst <= GRAD_TOL, worst

    # the step's time: forward, backward, Adam over the alphas
    st = fresh()
    leaves = [v for s in st.values() for v in s.values() if v.requires_grad]
    opt = torch.optim.Adam(leaves, lr=0.003, eps=1e-8)
    loss = make_loss(kern, params, spec, "adaround", 2.0, pack)

    def one(times=None):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        total, _ = loss(st, pack["gt"], emb, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        total.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if times is not None:
            times.append((t1 - t0, t2 - t1, t3 - t2))

    for _ in range(3):
        one()
    times = []
    for _ in range(10):
        one(times)
    fwd, bwd, upd = (1e3 * sum(t[i] for t in times) / len(times)
                     for i in range(3))
    print(f"  step (batch {CALIB_BATCH}, mean of 10): forward {fwd:.3f} ms, "
          f"backward {bwd:.3f} ms, optimizer {upd:.3f} ms, total "
          f"{fwd + bwd + upd:.3f} ms")
    prof = _profile_steps(torch, one)
    return dict(loss=loss_k, plain_loss=loss_p, loss_rel_err=rel_loss,
                grad_rel_err=worst, launches=counts, forward_ms=fwd,
                backward_ms=bwd, optimizer_ms=upd, profile=prof)


def _profile_steps(torch, one, n=5):
    """Device time by kernel name and the device's busy share over n steps
    (torch.profiler, CUPTI); 'not measured' when the trace has no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue               # host ops: their kernels are rows too
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.count > 0:
            rows.append((dev_us / 1e3 / n, e.count // n, e.key))
    busy = sum(r[0] for r in rows) * n
    if busy <= 0:
        print("  profiler: no device time in the trace (not measured)")
        return None
    rows.sort(reverse=True)
    print(f"  profiler over {n} steps: device busy {busy:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({100 * busy / wall_ms:.1f}%); per step:")
    for ms, cnt, key in rows[:14]:
        print(f"    {ms:8.3f} ms  x{cnt:<4d} {key[:90]}")
    return dict(wall_ms_per_step=wall_ms / n, busy_ms_per_step=busy / n,
                busy_share=busy / wall_ms,
                top=[dict(ms=r[0], launches=r[1], name=r[2][:120])
                     for r in rows[:14]])


def _calibrate_phase(torch, tf, cfg, sd, frames_dir, card):
    """``calibrate_network.main`` at Bunny-3M on the 8 seeded frames, from
    a .pth of the seeded weights: both phases, the four eval blocks, both
    guards, the artifact; every step's launches (from a count taken at
    each loss call); the artifact read back by ``eval_quantized``."""
    from neuroquant_tpu_torch.methods import calibrate_network, eval_quantized
    from neuroquant_tpu_torch.quantization import calibrate as tcal

    tmp = tempfile.mkdtemp(prefix="nq_chip_calib_")
    snaps = []
    make_loss = tcal.make_loss

    def counting(*a, **k):
        fn = make_loss(*a, **k)

        def loss(*args):
            snaps.append(dict(tf.KERNEL_LAUNCHES))
            return fn(*args)
        return loss

    cwd = os.getcwd()
    cap = _Capture()
    try:
        pth = os.path.join(tmp, "bunny_seeded.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
        tcal.make_loss = counting
        os.chdir(tmp)              # the run directory goes under results/
        logging.getLogger().addHandler(cap)
        tf.reset_launch_counts()
        t0 = time.time()
        out_path, state, _ = calibrate_network.main([
            "--config", os.path.join(REPO, "configs", "HNeRV",
                                     "Bunny_1280x640_3M.yaml"),
            "--arch", "hnerv", "--data_path", frames_dir, "--vid", "Bunny",
            "--outf", "hnerv", "--ckpt", pth, "--precision",
            *map(str, PRECISION), "--hadamard", "--channel_wise",
            "--batch_size", str(CALIB_BATCH), "--iters_w", str(CALIB_ITERS),
            "--lr", "0.003", "--warmup", "0.2"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(tf.KERNEL_LAUNCHES)
        # every element of the quantization state is finite
        for ln, s in state.items():
            for k, v in s.items():
                assert bool(torch.isfinite(v).all()), (ln, k)
        logging.getLogger().removeHandler(cap)
        results = eval_quantized.main(["--artifact", out_path,
                                       "--data_path", frames_dir])
    finally:
        tcal.make_loss = make_loss
        logging.getLogger().removeHandler(cap)
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    steps = [{k: b[k] - a[k] for k in a} for a, b in zip(snaps, snaps[1:])]
    assert len(snaps) == CALIB_ITERS, len(snaps)
    assert all(d == PER_STEP for d in steps), [d for d in steps
                                               if d != PER_STEP][:3]
    text = "\n".join(cap.lines)
    psnrs = [float(v) for v in re.findall(r"best_pred_seen_psnr: ([\d.]+)",
                                          text)]
    assert len(psnrs) == 4, psnrs          # the four eval blocks
    its = float(re.search(r"\[calib\] phase 2 .*\(([0-9.]+) iters/s\)",
                          text)[1])
    psnr = float(results[0])
    assert math.isfinite(psnr) and abs(round(psnr, 2) - psnrs[-1]) <= 0.01, (
        psnr, psnrs)
    for name in PER_STEP:
        assert launches[name] > 0, (name, launches)
    print(f"  calibrate_network: {CALIB_ITERS} steps at batch {CALIB_BATCH} "
          f"in {wall:.1f} s wall (evals included); phase 2 {its} iters/s; "
          f"every step's launches {PER_STEP}; run launches {launches}")
    print(f"  PSNR fp32 / quant off / quant unopt / quant opt: {psnrs}; "
          f"eval_quantized on the artifact: {psnr:.4f} dB; card {card}")
    return dict(phase2_its=its, wall_s=wall, launches=launches,
                psnr_blocks=psnrs, eval_psnr=psnr, steps=len(snaps))


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


def _serving_phase(torch, tf, cfg, sd, card, frames):
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

    frames_dir = tempfile.mkdtemp(prefix="nq_chip_frames_")
    try:
        _write_frames(frames_dir, rng)
        print("[kernels]")
        records = _kernel_phase(torch, tf, cfg, model)
        print("[kernels: calibration step, batch 2]")
        brecords = _backward_kernel_phase(torch, tf, cfg, model)
        print("[decode]")
        dec = _decode_phase(torch, tf, cfg, sd, model)
        print("[serving]")
        serve = _serving_phase(torch, tf, cfg, sd, card, frames_dir)
        print("[calibration step: gradients, launches, time]")
        grad = _gradient_phase(torch, tf, cfg, sd, frames_dir)
        print("[calibrate]")
        calib = _calibrate_phase(torch, tf, cfg, sd, frames_dir, card)
    finally:
        shutil.rmtree(frames_dir, ignore_errors=True)

    src = "neuroquant_tpu_torch/csrc/{}.cu".format
    tpu = "neuroquant_tpu/ops/tail_fused.py:{}".format
    # the decode's kernels are summed over one decode's launches (batch 1),
    # the calibration's new kernels over one step's (batch 2); "launches"
    # is the count over the calibrate_network run (its steps and its evals'
    # decodes), the main path of this slice
    sources = [("tail_conv_cf", records, tpu(1133), "per decode"),
               ("tail_conv_dw_cf", brecords, tpu(1172), "per step"),
               ("pack_cf", records, tpu(656), "per decode"),
               ("unpack_cf", brecords, tpu(666), "per step"),
               ("unpack_frames", records, tpu(2016), "per decode")]
    kernels = []
    for name, recs, replaces, summed in sources:
        per = recs[name]["per_launch"]
        t_ops = sum(p["bound_ms"] for p in per if p["bound_by"] == "operations")
        t_bytes = sum(p["bound_ms"] for p in per if p["bound_by"] == "bytes")
        err = max(recs[name]["max_abs_err"],
                  brecords.get(name, {"max_abs_err": 0.0})["max_abs_err"])
        kernels.append({
            "name": name, "route": "cuda", "source": src(name),
            "replaces": replaces, "launches": calib["launches"][name],
            "max_abs_err": err,
            "ms": sum(p["ms"] for p in per),
            "plain_ms": sum(p["plain_ms"] for p in per),
            "bound_ms": sum(p["bound_ms"] for p in per),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": sum(p["library_ms"] for p in per),
            "summed": summed,
            "serving_launches": serve["launches"][name],
            "per_decode_launches": dec["launches"][name] // 4,
            "per_step_launches": PER_STEP[name],
            "per_launch": per})
    kernels[0]["calibration_per_launch"] = brecords["tail_conv_cf"][
        "per_launch"]
    # the shape of the JAX width-tiled _unpack_kernel5, outside the sum
    kernels[-1]["width_tiled"] = records["unpack_frames"]["width_tiled"]
    for k in kernels:
        assert k["launches"] > 0, k["name"]
    for k in ("tail_conv_cf", "pack_cf", "unpack_frames"):
        assert serve["launches"][k] > 0, k
    print(f"  total {time.time() - t_start:.1f} s after start; decode "
          f"{dec['decode_ms']:.3f} ms/frame kernel path, "
          f"{dec['plain_decode_ms']:.3f} plain; calibration phase 2 "
          f"{calib['phase2_its']} it/s; card {card}")
    print(json.dumps({"card": card, "decode": dec, "serving": serve,
                      "step": grad, "calibrate": calib}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
