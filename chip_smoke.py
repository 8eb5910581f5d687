#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU, at HNeRV Bunny-3M
(640x1280, configs/HNeRV/Bunny_1280x640_3M.yaml) with seeded random weights.

  python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits non-zero):
  1. build  -- compile neuroquant_tpu_torch/csrc/*.cu with nvcc (sm_90a)
  2. kernels -- every kernel of the decode path against its plain PyTorch
     version on the card, at the shapes the decode gives it (the conv's
     emit z, y and the pair zy, with and without GELU on the input; the
     head is the cout-48 tile with ragged K runs of 37); times of the
     kernel, the plain version and one PyTorch library call of the same
     function (CUDA events, fp32, TF32 off); per conv its bound on the fp32
     pipes and on the tensor cores, and the MACs it executes beside the
     useful ones; per layout kernel (pack_cf, unpack_frames) also the
     card's own time of the kernel and of the library call (torch.profiler),
     and pack_cf at the calibration step's batch 2 too
  3. kernels of the calibration step -- at batch 2: each conv's forward as
     the step launches it (zy where a GELU follows, no GELU on the input),
     dx pass (GELU' epilogue; the prefix's splits K, the head's has runs
     of 3) and dW pass (twice: the same bits), act_in held against the
     plain version too, and unpack_cf, the same way (with its device times)
  4. decode -- 4 embeddings through the kernel path and the plain unpacked
     path; they must agree, with 4 tail_conv_cf, 2 pack_cf and 1
     unpack_frames launches per decode; a profiler window over 20 decodes:
     the card's busy time per decode, its idle share, its time by kernel
  5. serving -- a quantized artifact (Hadamard, channel-wise, max scales,
     precision 6 5 4 5 5 6 6) evaluated through
     ``neuroquant_tpu_torch.methods.eval_quantized.main`` on 8 seeded
     1280x720 PNG frames, with --eval_fps
  6. calibration step -- one phase-2 step's loss and gradients, kernel
     path against the plain unpacked path; its launches; its forward,
     backward and optimizer times; a profiler window; then the same step
     with fq_impl='pallas' (the grouped fake-quant kernels) against
     fq_impl='jnp' on the same kernel tail: loss, gradients, one fq_ada and
     one fq_ada_bwd launch, its times and profiler window
  7. calibrate -- ``neuroquant_tpu_torch.methods.calibrate_network.main``
     at Bunny-3M on the 8 frames from a .pth of the seeded weights, batch 2,
     80 steps (1 phase-1 and 19 phase-2 epochs): every step's launches (8
     tail_conv_cf, 4 tail_conv_dw_cf, 2 pack_cf, 2 unpack_cf), finite
     state, both guards, and the artifact read back by eval_quantized
  8. fake-quant kernels -- the grouped forward (fq_uaq, fq_ada: UAQ,
     AdaRound soft and hard, mixed rounding), one launch for the seven
     Bunny-3M weight layers, against the plain chain on the card: 1e-6 of
     the output's largest value and no flipped rounding decision; the
     backward (fq_uaq_bwd, fq_ada_bwd), one launch, against the closed form
     and autograd through the plain chain; the same without the transform
     and with per-layer scales; both passes' times against their bounds;
     the whole ``quantize_params`` call on both fq_impls, forward alone
     and forward plus backward, one launch each way
  9. calibrate, --fq_impl pallas -- phase 7 again on the fake-quant
     kernels: one fq_uaq and one fq_uaq_bwd launch per phase-1 step, one
     fq_ada and one fq_ada_bwd per phase-2 step, beside the 8 / 4 / 2 / 2,
     the four PSNR blocks within 0.02 dB of phase 7's
 10. bitstream -- ``compress.main`` on that artifact, then
     ``eval_quantized.main --from_bitstream``: the stream decodes to the
     artifact's codes, PSNR within 0.01 dB of the artifact's state eval,
     decode launches 4 / 2 / 1; stream bytes, bpp, the native coder's times

The second-to-last line is one JSON object per kernel: its launches over
the calibrate_network run (phase 7's for the tail's kernels, phase 9's for
the fake-quant entries), its largest error against the plain version, and
its times and bound summed over one decode's launches (the decode's
kernels), one calibration step's (tail_conv_dw_cf, unpack_cf) or one
``quantize_params`` call's grouped launch over its seven layers (fq_uaq,
fq_ada; the backward's fq_uaq_bwd, fq_ada_bwd); per-launch figures under
"per_launch". The last line is {"ok": true, "device": ...}.
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
PEAK_TF32_FLOP_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
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
            "unpack_cf": 2, "unpack_frames": 0, "fq_uaq": 0, "fq_ada": 0,
            "fq_uaq_bwd": 0, "fq_ada_bwd": 0}
# with fq_impl='pallas' a step's quantize_params adds one grouped
# fake-quant launch over its seven layers and one backward launch: fq_uaq
# and fq_uaq_bwd in phase 1, fq_ada and fq_ada_bwd in phase 2
FQ_PHASE1 = dict(PER_STEP, fq_uaq=1, fq_uaq_bwd=1)
FQ_PHASE2 = dict(PER_STEP, fq_ada=1, fq_ada_bwd=1)
# the fake-quant kernel against the plain chain, of the output's largest
# value: its butterfly and quantizer repeat the plain chain's fp32
# operations in their order (the soft form's expf against torch's sigmoid)
FQ_TOL = 1e-6
FQ_LOSS_TOL = 1e-6   # a step's loss, fq_impl pallas against jnp, relative
FQ_GRAD_TOL = 1e-5   # its gradients, of each leaf's largest
# the backward kernel's ddelta and dzp against the closed form and autograd,
# of each channel's sum of the magnitudes of the terms summed: fp32 sums
# over up to 1,600 terms in another order, whose two halves cancel
FQ_SUM_TOL = 1e-5
PSNR_TOL = 0.02      # dB between the two calibrate runs' eval blocks
STREAM_PSNR_TOL = 0.01   # dB, the stream's eval against the state's
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


def _device_ms(fn, n: int = 5, tries: int = 3):
    """Device time of one call of `fn`, summed over the kernels it
    launches (torch.profiler, CUPTI): what the card spends when the host
    does not hold it back. A trace now and then holds no device event: up
    to `tries` windows; None when none has device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / n
    return None


def _layout_record(shape, fn, plain, lib, nbytes):
    """A layout kernel's row: back-to-back ms (CUDA events over 20 calls,
    host time when the host sets the pace) and the card's own time
    (profiler), for the wrapper and for one PyTorch library call of the same
    function; the plain version's ms; the bound by bytes."""
    bound_ms, by = _bound(nbytes, 0)
    return dict(shape=shape, ms=_time_ms(fn), device_ms=_device_ms(fn),
                plain_ms=_time_ms(plain), library_ms=_time_ms(lib),
                library_device_ms=_device_ms(lib), bound_ms=bound_ms,
                bound_by=by, mbytes=nbytes / 1e6)


def _layout_line(rec) -> str:
    def ms(v):
        return "not measured" if v is None else f"{v:.4f}"
    return (f"{rec['ms']:.4f} ms back to back, {ms(rec['device_ms'])} on the "
            f"device (plain {rec['plain_ms']:.4f}; library "
            f"{rec['library_ms']:.4f}, {ms(rec['library_device_ms'])} on the "
            f"device; bound {rec['bound_ms']:.4f} by {rec['bound_by']})")


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _bound_tc(nbytes: float, flops: float) -> float:
    """The bound of a kernel that multiplies on the tensor cores at fp32
    accuracy: three TF32 products per fp32 product, or the bytes."""
    return max(nbytes / PEAK_BYTES_PER_S,
               3 * flops / PEAK_TF32_FLOP_PER_S) * 1e3


def _conv_extra(tf, p, layer, batch, nbytes, flops):
    """What a conv row reports beside its times: the tensor-core bound, the
    MACs the kernel executes beside the useful ones, its K split."""
    steps = tf._conv_steps(tf._k_blocks(p, layer), layer.cin, layer.taps)[0]
    return dict(bound_tc_ms=_bound_tc(nbytes, flops),
                useful_gmac=flops / 2e9,
                executed_gmac=tf.conv_executed_macs(p, layer, batch) / 1e9,
                k_splits=tf._conv_split(layer.cout, p.mp, batch, len(steps)))


def _max_err(got, want):
    """(largest |got - want|, CONV_TOL of want's largest value) over one
    tensor or a tuple of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    tol = CONV_TOL * max(1.0, *(float(b.abs().max()) for b in want))
    return err, tol


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
            for em, act in (("z", False), ("y", False), ("zy", False),
                            ("z", True), ("y", True)):
                ref = tf.conv_cf_ref(x, kk, bias, p, layer, em, act)
                out = tf.conv_cf(x, kk, bias, p, layer, em, act, w_op)
                torch.cuda.synchronize()
                err, tol = _max_err(out, ref)
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
            extra = _conv_extra(tf, p, layer, 1, nbytes, flops)
            records["tail_conv_cf"]["per_launch"].append(dict(
                shape=f"{name} {layer.cin}->{layer.cout} k{layer.side} "
                      f"grid {p.h}x{p.w} emit={emit}",
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, gflop=flops / 1e9,
                mbytes=nbytes / 1e6, **extra))
            print(f"  tail_conv_cf {name}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                  f"F.conv2d {lib_ms:.4f}, bound {bound_ms:.4f} by {by}, "
                  f"on the tensor cores {extra['bound_tc_ms']:.4f}; "
                  f"{flops / 1e9:.2f} GFLOP -> "
                  f"{flops / ms / 1e9:.2f} TFLOP/s; MACs executed "
                  f"{extra['executed_gmac']:.2f} G for "
                  f"{extra['useful_gmac']:.2f} G useful)")

        # batch 1 for the decode's two entries; batch 2, the calibration
        # step's, outside the decode's sum
        for batch, key in ((1, "per_launch"), (CALIB_BATCH,
                                               "calibration_per_launch")):
            for name, p, hw, c in (("prefix entry", pplan, (ph, pw), 64),
                                   ("tail entry", plan, (ph * 4, pw * 4),
                                    53)):
                x = torch.randn((batch, *hw, c), generator=gen, device=dev)
                ref, out = tf.pack_cf_ref(x, p), tf.pack_cf(x, p)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                print(f"  pack_cf {name} {tuple(x.shape)} -> "
                      f"{tuple(out.shape)}: max_abs_err {err:.3e} (tol 0, a "
                      f"copy)")
                assert err == 0.0, (name, err)
                rec = _layout_record(
                    f"{name} {tuple(x.shape)}->{tuple(out.shape)}",
                    lambda: tf.pack_cf(x, p), lambda: tf.pack_cf_ref(x, p),
                    lambda: x.permute(0, 3, 1, 2).contiguous(),
                    4 * (x.numel() + out.numel()))
                records["pack_cf"].setdefault(key, []).append(rec)
                print(f"  pack_cf {rec['shape']}: {_layout_line(rec)} "
                      f"(library: permute+contiguous)")

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
        rec = _layout_record(
            f"{tuple(zw.shape)}->{tuple(outw.shape)} out_bias=tanh",
            lambda: tf.unpack_frames(zw, wplan, wf, 48, "tanh"),
            lambda: tf.unpack_frames_ref(zw, wplan, wf, 48, "tanh"),
            lambda: F.pixel_shuffle(zwl, wf), 4 * (zwl.numel() + outw.numel()))
        records["unpack_frames"]["width_tiled"] = rec
        print(f"  unpack_frames width-tiled plan {rec['shape']}: "
              f"{_layout_line(rec)} (library: pixel_shuffle)")
        ob = cfg["out_bias"]
        zl = torch.randn((1, ch, plan.h, plan.w), generator=gen, device=dev)
        rec = _layout_record(
            f"{tuple(z.shape)}->{tuple(out.shape)} out_bias={ob}",
            lambda: tf.unpack_frames(z, plan, f, ch, ob),
            lambda: tf.unpack_frames_ref(z, plan, f, ch, ob),
            lambda: F.pixel_shuffle(zl, f),
            4 * (ch * plan.h * plan.w + out.numel()))
        records["unpack_frames"]["per_launch"].append(rec)
        print(f"  unpack_frames {rec['shape']}: {_layout_line(rec)} "
              f"(library: pixel_shuffle)")
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
                          "unpack_frames": 4, "fq_uaq": 0,
                          "fq_ada": 0, "fq_uaq_bwd": 0,
                          "fq_ada_bwd": 0}, counts
        e1 = embeds[:1]
        k_ms = _time_ms(lambda: model.decode(e1), iters=20)
        p_ms = _time_ms(lambda: plain.decode(e1), iters=20)
        # the card's busy time per decode and what it spends by kernel; the
        # idle share against the window's wall time (the profiler's own host
        # cost included) and against the decode's time without it
        prof = _profile_steps(torch, lambda: model.decode(e1), n=20,
                              what="decode")
    print(f"  decode latency (batch 1): kernel path {k_ms:.3f} ms, "
          f"plain unpacked path {p_ms:.3f} ms")
    if prof is not None:
        prof["idle_share_of_decode_ms"] = 1 - prof["busy_ms_per_decode"] / k_ms
        print(f"  decode: device busy {prof['busy_ms_per_decode']:.4f} ms per "
              f"decode; idle {100 * prof['idle_share']:.1f}% of the profiled "
              f"window, {100 * prof['idle_share_of_decode_ms']:.1f}% of the "
              f"{k_ms:.3f} ms decode")
    return dict(decode_ms=k_ms, plain_decode_ms=p_ms, max_abs_err=err,
                launches=counts, profile=prof)


def _backward_kernel_phase(torch, tf, cfg, model):
    """The calibration step's kernels at Bunny-3M, batch 2, against their
    plain versions: each conv layer's forward as the step runs it (the pair
    'zy' where a GELU follows, else z; no GELU on the input), its dx pass
    (the transposed layer with the GELU' epilogue; the prefix's splits K)
    and its dW pass; both kernels' act_in, which the step no longer uses,
    held against the plain version too; unpack_cf at both entries. Library
    yardsticks: cuDNN's conv2d, conv2d_input and conv2d_weight on the
    unpacked convs; permute().contiguous()."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    B = CALIB_BATCH
    ph, pw = cfg["crop_h"] // 16, cfg["crop_w"] // 16
    convs, pplan, plan, _, _ = _conv_layers(torch, tf, cfg, model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    records = {k: {"per_launch": [], "max_abs_err": 0.0}
               for k in ("tail_conv_cf", "tail_conv_dw_cf", "unpack_cf")}

    def check(kname, what, got, want):
        err, tol = _max_err(got, want)
        print(f"  {kname} {what}: max_abs_err {err:.3e} (tol {tol:.1e})")
        assert err <= tol, (kname, what, err, tol)
        records[kname]["max_abs_err"] = max(records[kname]["max_abs_err"],
                                            err)

    def record(kname, shape, fn, plain, lib, nbytes, flops, extra=None):
        ms = _time_ms(fn, iters=10)
        plain_ms = _time_ms(plain, iters=3, warmup=1)
        lib_ms = _time_ms(lib, iters=10)
        bound_ms, by = _bound(nbytes, flops)
        extra = extra or {}
        if kname == "unpack_cf":       # a layout kernel: the card's own time
            extra = dict(extra, device_ms=_device_ms(fn),
                         library_device_ms=_device_ms(lib))
        records[kname]["per_launch"].append(dict(
            shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by, gflop=flops / 1e9,
            mbytes=nbytes / 1e6, **extra))
        print(f"  {kname} {shape}: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"library {lib_ms:.4f}, bound {bound_ms:.4f} by {by}; "
              f"{flops / 1e9:.2f} GFLOP -> {flops / ms / 1e9:.2f} TFLOP/s)"
              + "".join(f"; {k} {v:.4f}" if isinstance(v, float)
                        else f"; {k} {v}" for k, v in extra.items()))

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
            # a GELU follows the two middle layers: they emit the pair
            emit = "zy" if name in ("tail L0", "tail L1") else "z"
            check("tail_conv_cf", f"forward {geo} emit={emit}",
                  tf.conv_cf(x, kk, bias, p, layer, emit, False, w_op),
                  tf.conv_cf_ref(x, kk, bias, p, layer, emit))
            if act:
                check("tail_conv_cf", f"forward {geo} emit=z act_in=True",
                      tf.conv_cf(x, kk, bias, p, layer, "z", True, w_op),
                      tf.conv_cf_ref(x, kk, bias, p, layer, "z", True))
            nbytes = 4 * (x.numel() + kk.numel() + layer.cout
                          + g.numel() * len(emit))
            record("tail_conv_cf", f"forward {geo} emit={emit}",
                   lambda: tf.conv_cf(x, kk, bias, p, layer, emit, False,
                                      w_op),
                   lambda: tf.conv_cf_ref(x, kk, bias, p, layer, emit),
                   lambda: F.conv2d(xl, wl, padding=pad), nbytes, flops,
                   _conv_extra(tf, p, layer, B, nbytes, flops))

            lt = layer.transposed()
            kt = tf._kk_transpose(kk).contiguous()
            om = x if act else None
            wt_op = tf.conv_w_operand(kt, p, lt)
            dx_geo = f"dx {geo} out_mul={act}"
            check("tail_conv_cf", dx_geo,
                  tf.conv_cf(g, kt, None, p, lt, w_op=wt_op, out_mul=om),
                  tf.conv_cf_ref(g, kt, None, p, lt, out_mul=om))
            nbytes = 4 * (g.numel() + kt.numel() + x.numel()
                          * (2 if act else 1))
            record("tail_conv_cf", dx_geo,
                   lambda: tf.conv_cf(g, kt, None, p, lt, w_op=wt_op,
                                      out_mul=om),
                   lambda: tf.conv_cf_ref(g, kt, None, p, lt, out_mul=om),
                   lambda: torch.nn.grad.conv2d_input(xl.shape, wl, gl,
                                                      padding=pad),
                   nbytes, flops, _conv_extra(tf, p, lt, B, nbytes, flops))

            blocks = tf._k_blocks(p, layer)
            dkk, db = tf.conv_cf_dw(x, g, p, layer)
            rkk, rdb = tf.conv_cf_dw_ref(x, g, p, layer, False, blocks)
            check("tail_conv_dw_cf", f"dW {geo}", dkk, rkk)
            check("tail_conv_dw_cf", f"db {geo}", db, rdb)
            again = tf.conv_cf_dw(x, g, p, layer)[0]
            assert torch.equal(again, dkk), "dW differs from run to run"
            if act:
                check("tail_conv_dw_cf", f"dW {geo} act_in=True",
                      tf.conv_cf_dw(x, g, p, layer, True)[0],
                      tf.conv_cf_dw_ref(x, g, p, layer, True, blocks)[0])
            nbytes = 4 * (x.numel() + g.numel() + dkk.numel() + db.numel())
            splits, chunk = tf._dw_split(
                tf.K_STEP * (len(tf._k_steps(blocks, layer.cin,
                                             layer.taps)[0]) + 1),
                layer.cout, B * p.mp)
            record("tail_conv_dw_cf", f"dW {geo}",
                   lambda: tf.conv_cf_dw(x, g, p, layer),
                   lambda: tf.conv_cf_dw_ref(x, g, p, layer, False, blocks),
                   lambda: torch.nn.grad.conv2d_weight(xl, wl.shape, gl,
                                                       padding=pad),
                   nbytes, flops,
                   dict(bound_tc_ms=_bound_tc(nbytes, flops),
                        useful_gmac=flops / 2e9,
                        executed_gmac=tf.conv_executed_macs(p, layer, B)
                        / 1e9, position_splits=splits))

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
    share. Then the same step with fq_impl='pallas': the grouped fake-quant
    kernels, forward and backward, give the 'jnp' step's loss and gradients
    on the same kernel tail, with one fq_ada and one fq_ada_bwd launch
    more; both steps' times and profiler windows."""
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
    spec_fq = make_spec("hnerv", cfg, channel_wise=True, scale_method="max",
                        hadamard=True, fq_impl="pallas").with_bits(PRECISION)
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

    def step(model, pk, spec=spec):
        st = fresh()
        loss = make_loss(model, params, spec, "adaround", 2.0, pk)
        total, _ = loss(st, pk["gt"] if pk else frames, emb, 1)
        total.backward()
        torch.cuda.synchronize()
        return float(total.detach()), {(ln, k): st[ln][k].grad
                                       for ln in st for k in st[ln]
                                       if k.endswith("alpha")}

    tf.reset_launch_counts()
    torch.cuda.synchronize()
    held_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = step(kern, pack)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    print(f"  peak device memory of one step on the kernel path: "
          f"{peak_mb:.1f} MiB ({held_mb:.1f} MiB held before it)")
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

    tf.reset_launch_counts()
    loss_f, grads_f = step(kern, pack, spec_fq)
    counts_f = dict(tf.KERNEL_LAUNCHES)
    rel_f = abs(loss_f - loss_k) / abs(loss_k)
    worst_f = max(float((grads_f[key] - grads_k[key]).abs().max())
                  / max(float(grads_k[key].abs().max()), 1e-30)
                  for key in grads_k)
    print(f"  the same step, fq_impl pallas vs jnp on the kernel tail: loss "
          f"{loss_f:.7f} vs {loss_k:.7f} (rel {rel_f:.2e}, tol "
          f"{FQ_LOSS_TOL:.0e}); gradients: worst leaf max|diff| / max|grad| "
          f"{worst_f:.2e} (tol {FQ_GRAD_TOL:.0e}); launches {counts_f}")
    assert counts_f == FQ_PHASE2, counts_f
    assert rel_f <= FQ_LOSS_TOL, (loss_f, loss_k)
    assert worst_f <= FQ_GRAD_TOL, worst_f

    def timed(spec):
        """(one step as a callable, its mean forward, backward and optimizer
        ms over 10 steps): forward, backward, Adam over the alphas."""
        st = fresh()
        leaves = [v for s in st.values() for v in s.values()
                  if v.requires_grad]
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
        return (one, *(1e3 * sum(t[i] for t in times) / len(times)
                       for i in range(3)))

    # the two impls in turns: jnp, pallas, pallas, jnp
    runs = [timed(sp) for sp in (spec, spec_fq, spec_fq, spec)]
    one, fwd, bwd, upd = runs[0]
    for label, (_, f, b, u) in zip(("jnp", "pallas", "pallas", "jnp"), runs):
        print(f"  step, fq_impl {label} (batch {CALIB_BATCH}, mean of 10): "
              f"forward {f:.3f} ms, backward {b:.3f} ms, optimizer {u:.3f} "
              f"ms, total {f + b + u:.3f} ms")
    prof = _profile_steps(torch, one)
    print("  the same window, fq_impl pallas:")
    prof_f = _profile_steps(torch, runs[1][0])
    return dict(loss=loss_k, plain_loss=loss_p, loss_rel_err=rel_loss,
                grad_rel_err=worst, launches=counts, peak_mib=peak_mb,
                held_before_mib=held_mb, forward_ms=fwd,
                backward_ms=bwd, optimizer_ms=upd, profile=prof,
                fq_pallas=dict(
                    loss_rel_err=rel_f, grad_rel_err=worst_f,
                    launches=counts_f,
                    step_ms_jnp=[sum(runs[i][1:]) for i in (0, 3)],
                    step_ms_pallas=[sum(runs[i][1:]) for i in (1, 2)],
                    forward_ms=runs[1][1], backward_ms=runs[1][2],
                    profile=prof_f))


def _profile_steps(torch, one, n=5, what="step"):
    """Device time by kernel name and the device's busy share over n calls
    of `one`, a step or a decode (torch.profiler, CUPTI); 'not measured'
    when the trace has no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        torch.cuda.synchronize()      # a decode returns before the card ends
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
    print(f"  profiler over {n} {what}s: device busy {busy:.1f} ms of "
          f"{wall_ms:.1f} ms wall ({100 * busy / wall_ms:.1f}%); per {what}:")
    for ms, cnt, key in rows[:14]:
        print(f"    {ms:8.4f} ms  x{cnt:<4d} {key[:90]}")
    return {f"wall_ms_per_{what}": wall_ms / n,
            f"busy_ms_per_{what}": busy / n, "busy_share": busy / wall_ms,
            "idle_share": 1 - busy / wall_ms,
            "top": [dict(ms=r[0], launches=r[1], name=r[2][:120])
                    for r in rows[:14]]}


def _calibrate_phase(torch, tf, cfg, sd, frames_dir, card, work, fq_impl):
    """``calibrate_network.main --fq_impl <fq_impl>`` at Bunny-3M on the 8
    seeded frames, from a .pth of the seeded weights, under the directory
    `work`: both phases, the four eval blocks, both guards, the artifact;
    every step's launches (from a count taken at each loss call); the
    artifact read back by ``eval_quantized``."""
    from neuroquant_tpu_torch.methods import calibrate_network, eval_quantized
    from neuroquant_tpu_torch.quantization import calibrate as tcal

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
        pth = os.path.join(work, "bunny_seeded.pth")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
        tcal.make_loss = counting
        os.chdir(work)             # the run directory goes under results/
        logging.getLogger().addHandler(cap)
        tf.reset_launch_counts()
        t0 = time.time()
        out_path, state, _ = calibrate_network.main([
            "--config", os.path.join(REPO, "configs", "HNeRV",
                                     "Bunny_1280x640_3M.yaml"),
            "--arch", "hnerv", "--data_path", frames_dir, "--vid", "Bunny",
            "--outf", f"hnerv_{fq_impl}", "--ckpt", pth, "--precision",
            *map(str, PRECISION), "--hadamard", "--channel_wise",
            "--batch_size", str(CALIB_BATCH), "--iters_w", str(CALIB_ITERS),
            "--lr", "0.003", "--warmup", "0.2", "--fq_impl", fq_impl])
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
    out_path = os.path.join(work, out_path)
    steps = [{k: b[k] - a[k] for k in a} for a, b in zip(snaps, snaps[1:])]
    assert len(snaps) == CALIB_ITERS, len(snaps)
    if fq_impl == "pallas":
        # phase 1's steps quantize on fq_uaq, phase 2's on fq_ada
        phase1, phase2 = FQ_PHASE1, FQ_PHASE2
        n1 = sum(d == phase1 for d in steps)
        assert 0 < n1 < len(steps), (n1, steps[:2])
        # the last diff of phase 1 spans the hand-off between the phases
        # (no kernel runs there), so every diff is one step's
        assert all(d == phase1 for d in steps[:n1]), steps[:n1]
        assert all(d == phase2 for d in steps[n1:]), [
            d for d in steps[n1:] if d != phase2][:3]
        per_step = f"phase 1 ({n1} steps) {phase1}, phase 2 {phase2}"
    else:
        assert all(d == PER_STEP for d in steps), [d for d in steps
                                                   if d != PER_STEP][:3]
        per_step = str(PER_STEP)
    text = "\n".join(cap.lines)
    psnrs = [float(v) for v in re.findall(r"best_pred_seen_psnr: ([\d.]+)",
                                          text)]
    assert len(psnrs) == 4, psnrs          # the four eval blocks
    its = float(re.search(r"\[calib\] phase 2 .*\(([0-9.]+) iters/s\)",
                          text)[1])
    psnr = float(results[0])
    assert math.isfinite(psnr) and abs(round(psnr, 2) - psnrs[-1]) <= 0.01, (
        psnr, psnrs)
    for name, n in launches.items():
        # the evals' decodes launch unpack_frames; the fake-quant entries
        # run only under fq_impl pallas
        assert (n > 0) == (fq_impl == "pallas" or not name.startswith("fq_")
                           ), (name, launches)
    print(f"  calibrate_network --fq_impl {fq_impl}: {CALIB_ITERS} steps at "
          f"batch {CALIB_BATCH} in {wall:.1f} s wall (evals included); phase "
          f"2 {its} iters/s; every step's launches {per_step}; run launches "
          f"{launches}")
    print(f"  PSNR fp32 / quant off / quant unopt / quant opt: {psnrs}; "
          f"eval_quantized on the artifact: {psnr:.4f} dB; card {card}")
    return dict(phase2_its=its, wall_s=wall, launches=launches,
                psnr_blocks=psnrs, eval_psnr=psnr, steps=len(snaps),
                artifact=out_path, fq_impl=fq_impl)


def _fq_kernel_phase(torch, tf, cfg, sd):
    """The grouped fake-quant kernels at the seven Bunny-3M weight shapes,
    with the seeded weights and the scales of ``init_quant_state`` (UAQ)
    and ``adaround_upgrade`` (AdaRound soft and hard, and mixed: AdaRound
    on every other layer, nearest rounding on the rest): the forward, one
    launch for the seven layers, bit for bit against the plain chain with
    no flipped rounding decision; the backward, one launch, against the
    closed form (``fake_quant_vjp_ref``) and autograd through the plain
    chain; the same without the transform and with per-layer scales; each
    pass timed against its bound as the calibration's phases call it
    (phase 1: UAQ, ddelta; phase 2: soft AdaRound, dalpha); then the whole
    ``quantize_params`` call on both fq_impls, forward alone and forward
    plus backward, with its launches. Returns per-kernel records."""
    from neuroquant_tpu_torch.ops import fused_fakequant as ff
    from neuroquant_tpu_torch.ops.hadamard import next_power_of_two
    from neuroquant_tpu_torch.quantization import (
        adaround_upgrade, init_quant_state, make_spec, quantize_params)
    from neuroquant_tpu_torch.quantization.qmodel import _get
    from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

    params = state_dict_from_numpy(sd, "cuda")
    kw = dict(channel_wise=True, scale_method="max", hadamard=True)
    spec = make_spec("hnerv", cfg, **kw).with_bits(PRECISION)
    spec_fq = make_spec("hnerv", cfg, fq_impl="pallas", **kw).with_bits(
        PRECISION)
    uaq = init_quant_state(params, spec)
    ada = adaround_upgrade(params, spec, uaq)
    mixed = adaround_upgrade(params, spec, uaq,
                             only=tuple(spec.layer_names[::2]))
    weights = [_get(params, p)[0] for p in spec.layer_paths]
    records = {k: {"per_launch": [], "max_abs_err": 0.0}
               for k in ("fq_uaq", "fq_ada", "fq_uaq_bwd", "fq_ada_bwd")}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cots = [torch.randn(w.shape, generator=gen, device="cuda")
            for w in weights]

    def group(state, soft, ws=weights, bits=spec.n_bits, names=None):
        names = names or spec.layer_names
        return [(w, state[n]["w_delta"], state[n]["w_zp"],
                 state[n].get("w_alpha"), b, soft)
                for w, n, b in zip(ws, names, bits)]

    def kname(layers):
        return "fq_ada" if any(l[3] is not None for l in layers) else "fq_uaq"

    def check_forward(label, layers, hadamard):
        """One grouped launch against the plain chain, layer by layer:
        (largest error, elements off by a flipped rounding decision, which
        moves a transformed row by delta / sqrt(C) per element)."""
        tf.reset_launch_counts()
        with torch.no_grad():
            outs = ff.fake_quant_group(layers, hadamard)
        torch.cuda.synchronize()
        launched = {k: v for k, v in tf.KERNEL_LAUNCHES.items() if v}
        assert launched == {kname(layers): 1}, (label, launched)
        top, flips, tol = 0.0, 0, 0.0
        for (w, d, z, a, bits, soft), got in zip(layers, outs):
            want = ff.fake_quant_ref(w, d, z, a, bits, hadamard, soft)
            assert got.shape == want.shape, (got.shape, want.shape)
            err = (got - want).abs()
            c = next_power_of_two(w.shape[2]) if hadamard else 1
            flips += int((err > 0.5 * d / math.sqrt(c)).sum())
            top = max(top, float(err.max()))
            tol = max(tol, FQ_TOL * max(1.0, float(want.abs().max())))
        print(f"  forward, {label}: one {kname(layers)} launch for "
              f"{len(layers)} layers; max_abs_err {top:.3e} (tol {tol:.1e}), "
              f"flipped rounding decisions {flips} (must be 0)")
        assert top <= tol and flips == 0, (label, top, tol, flips)
        records[kname(layers)]["max_abs_err"] = max(
            records[kname(layers)]["max_abs_err"], top)

    def check_backward(label, layers, hadamard):
        """One backward launch (every leaf wanted) against the closed form
        and autograd through the plain chain: dw and dalpha within FQ_TOL
        of the leaf's largest value, the reduced ddelta and dzp within
        FQ_SUM_TOL of each channel's sum of the magnitudes of their
        terms."""
        leaves = [[None if t is None else t.detach().clone().requires_grad_()
                   for t in lay[:4]] for lay in layers]
        flat = [t for lv in leaves for t in lv if t is not None]
        tf.reset_launch_counts()
        outs = ff.fake_quant_group(
            [(*lv, *lay[4:]) for lv, lay in zip(leaves, layers)], hadamard)
        got = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(outs, cots)), flat,
            allow_unused=True)
        torch.cuda.synchronize()
        launched = {k: v for k, v in tf.KERNEL_LAUNCHES.items() if v}
        name = kname(layers)
        assert launched == {name: 1, name + "_bwd": 1}, (label, launched)
        got = iter(got)
        worst = {"closed form": 0.0, "autograd": 0.0}
        top, unequal = 0.0, 0
        for lv, (w, d, z, a, bits, soft), cot in zip(leaves, layers, cots):
            mine = [None if t is None else next(got) for t in lv]
            closed = ff.fake_quant_vjp_ref(cot, w, d, z, a, bits, hadamard,
                                           soft)
            sums = ff.fake_quant_vjp_ref(
                cot, w, d, z, a, bits, hadamard, soft,
                sum_like=lambda t, like: ff._sum_like(t.abs(), like))[1:3]
            ins = [t.detach().clone().requires_grad_() for t in (w, d, z)]
            if a is not None and soft:
                ins.append(a.detach().clone().requires_grad_())
            plain = list(torch.autograd.grad(
                ff.fake_quant_ref(*ins[:3], a if len(ins) == 3 else ins[3],
                                  bits, hadamard, soft), ins, cot,
                allow_unused=True)) + [None] * (4 - len(ins))
            for ref_name, ref in (("closed form", closed),
                                  ("autograd", plain)):
                for i, (g, r) in enumerate(zip(mine, ref)):
                    if r is None:
                        assert g is None or not bool(g.any()), (label, i)
                        continue
                    err = (g - r).abs()
                    scale = (sums[i - 1].clamp_min(1e-30) if i in (1, 2)
                             else max(1.0, float(r.abs().max())))
                    tol = FQ_SUM_TOL if i in (1, 2) else FQ_TOL
                    rel = float((err / scale).max())
                    assert rel <= tol, (label, ref_name, i, rel)
                    worst[ref_name] = max(worst[ref_name], rel)
                    if ref_name == "closed form":
                        top = max(top, float(err.max()))
                        if i in (0, 3):
                            unequal += int((g != r).sum())
        print(f"  backward, {label}: one {name}_bwd launch; against the "
              f"closed form {worst['closed form']:.2e}, autograd "
              f"{worst['autograd']:.2e} (of the largest dw / dalpha, tol "
              f"{FQ_TOL:.0e}; of the channel's term magnitudes for ddelta / "
              f"dzp, tol {FQ_SUM_TOL:.0e}); dw and dalpha elements not equal "
              f"to the closed form's bits: {unequal}")
        records[name + "_bwd"]["max_abs_err"] = max(
            records[name + "_bwd"]["max_abs_err"], top)

    # the seven layers in one group: UAQ, soft, hard, mixed
    for label, state, soft in (("uaq", uaq, True), ("adaround soft", ada,
                                                    True),
                               ("adaround hard", ada, False),
                               ("mixed rounding", mixed, True)):
        layers = group(state, soft)
        check_forward(f"7 Bunny-3M layers, {label}", layers, True)
        if label != "adaround hard":
            check_backward(f"7 Bunny-3M layers, {label}", layers, True)
    # without the transform (C = C_in), and with per-layer (0-d) scales
    for hadamard, cw, label in ((False, True, "no transform"),
                                (True, False, "per-layer scales")):
        sp = make_spec("hnerv", cfg, channel_wise=cw, scale_method="max",
                       hadamard=hadamard).with_bits(PRECISION)
        su = init_quant_state(params, sp)
        sa = adaround_upgrade(params, sp, su)
        assert su[sp.layer_names[4]]["w_delta"].dim() == (4 if cw else 0)
        for mode, state, soft in (("uaq", su, True), ("soft", sa, True),
                                  ("hard", sa, False)):
            layers = group(state, soft, bits=sp.n_bits)
            check_forward(f"7 layers, {label}, {mode}", layers, hadamard)
            if mode != "hard":
                check_backward(f"7 layers, {label}, {mode}", layers,
                               hadamard)

    # the passes timed as the calibration's phases call them: the forward
    # reads each weight and writes its result unpadded (AdaRound: the
    # padded alphas too); phase 1's backward reads the gradient and the
    # weight and writes ddelta, phase 2's reads the alphas too and writes
    # dalpha, padded
    n_w = sum(w.numel() for w in weights)
    n_a = sum(ada[n]["w_alpha"].numel() for n in spec.layer_names)
    n_s = 4 * sum(w.shape[3] for w in weights)
    for name, state, need, nbytes in (
            ("fq_uaq", uaq, None, 4 * (2 * n_w + n_s)),
            ("fq_ada", ada, None, 4 * (2 * n_w + n_s + n_a)),
            ("fq_uaq_bwd", uaq, (False, True, False, False),
             4 * (2 * n_w + n_s)),
            ("fq_ada_bwd", ada, (False, False, False, True),
             4 * (2 * n_w + n_s + 2 * n_a))):
        layers = group(state, True)
        if need is None:
            def run():
                with torch.no_grad():
                    return ff.fake_quant_group(layers, True)

            def plain():
                return [ff.fake_quant_ref(w, d, z, a, b, True, s)
                        for w, d, z, a, b, s in layers]
        else:
            def run():
                return ff._backward(layers, True, cots, [need] * len(layers))

            def plain():
                return [ff.fake_quant_vjp_ref(c, w, d, z, a, b, True, s, need)
                        for (w, d, z, a, b, s), c in zip(layers, cots)]
        tf.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        assert tf.KERNEL_LAUNCHES[name] == 1, dict(tf.KERNEL_LAUNCHES)
        bound_ms, by = _bound(nbytes, 0)
        rec = dict(shape="the seven Bunny-3M layers, one launch",
                   ms=_time_ms(run), plain_ms=_time_ms(plain),
                   device_ms=_device_ms(run),
                   plain_device_ms=_device_ms(plain), library_ms=None,
                   bound_ms=bound_ms, bound_by=by, mbytes=nbytes / 1e6)
        records[name]["per_launch"].append(rec)
        share = ("not measured" if rec["device_ms"] is None
                 else f"{100 * bound_ms / rec['device_ms']:.0f}% of the bound")
        print(f"  {name}, 7 layers: {rec['ms']:.4f} ms back to back, "
              f"{rec['device_ms']} ms on the device ({share}); bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB) by {by}; plain "
              f"{rec['plain_ms']:.4f} ms, {rec['plain_device_ms']} on the "
              f"device; no single PyTorch call computes the chain")

    # the whole quantize_params call, 7 layers: what a calibration step pays
    keys = [k for k in params if k.startswith(("decoder.", "head_layer."))]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cot = {k: torch.randn(params[k].shape, generator=gen, device="cuda")
           for k in keys}
    calls = {}
    for mode, state, leaf in (("uaq", uaq, "delta"), ("adaround", ada,
                                                      "alpha")):
        st = {ln: {k: v.clone().requires_grad_(k.endswith(leaf))
                   for k, v in s.items()} for ln, s in state.items()}
        leaves = [v for s in st.values() for v in s.values()
                  if v.requires_grad]

        def forward(sp):
            with torch.no_grad():
                return quantize_params(params, sp, st, mode=mode, soft=True)

        def both(sp):
            out = quantize_params(params, sp, st, mode=mode, soft=True)
            total = sum((out[k] * cot[k]).sum() for k in keys)
            return torch.autograd.grad(total, leaves)

        g_j = both(spec)
        tf.reset_launch_counts()
        g_f = both(spec_fq)
        torch.cuda.synchronize()
        launched = {k: v for k, v in tf.KERNEL_LAUNCHES.items() if v}
        name = "fq_uaq" if mode == "uaq" else "fq_ada"
        assert launched == {name: 1, name + "_bwd": 1}, launched
        worst = max(float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(g_f, g_j))
        assert worst <= FQ_GRAD_TOL, (mode, worst)
        # in turns: jnp, pallas, pallas, jnp
        t = {}
        for label, fn in (("forward", forward), ("forward_backward", both)):
            ms = [_time_ms(lambda: fn(sp), iters=10)
                  for sp in (spec, spec_fq, spec_fq, spec)]
            t[label] = dict(jnp_ms=[ms[0], ms[3]], pallas_ms=[ms[1], ms[2]])
        calls[mode] = dict(t, grad_rel_err=worst, launches=launched)
        print(f"  quantize_params mode={mode}, 7 layers: forward jnp "
              f"{t['forward']['jnp_ms']} ms, pallas "
              f"{t['forward']['pallas_ms']} ms; forward + backward jnp "
              f"{t['forward_backward']['jnp_ms']} ms, pallas "
              f"{t['forward_backward']['pallas_ms']} ms; launches "
              f"{launched}; gradients pallas vs jnp {worst:.2e} (tol "
              f"{FQ_GRAD_TOL:.0e})")
    records["quantize_params"] = calls
    return records


def _bitstream_phase(torch, tf, calib, frames_dir, card):
    """``compress.main`` on the calibration's artifact, then
    ``eval_quantized.main --from_bitstream`` on the stream."""
    from neuroquant_tpu_torch.coding import codec
    from neuroquant_tpu_torch.methods import compress, eval_quantized

    art = calib["artifact"]
    t0 = time.time()
    so = codec.build_native()
    print(f"  range coder built/loaded in {time.time() - t0:.2f} s: "
          f"{os.path.relpath(so, REPO)}")
    report = compress.main(["--artifact", art, "--data_path", frames_dir])
    stream_path = report["bitstream"]
    assert stream_path == art + ".nqtb" and os.path.exists(stream_path)
    with open(art, "rb") as f:
        codes = pickle.load(f)["int_codes"]
    n_sym = sum(int(np.asarray(c["w"]).size + np.asarray(c["b"]).size)
                for c in codes.values())
    t0 = time.perf_counter()
    stream = codec.compress_artifact(codes)
    t1 = time.perf_counter()
    back = codec.decompress_artifact(stream)
    t2 = time.perf_counter()
    with open(stream_path, "rb") as f:
        assert f.read() == stream
    for name, c in codes.items():
        assert np.array_equal(back[name]["w"], np.asarray(c["w"])), name
        assert np.array_equal(back[name]["b"], np.asarray(c["b"])), name
    assert report["weight_stream_bytes"] == len(stream)
    assert report["pixels"] == N_FRAMES * 640 * 1280, report
    tf.reset_launch_counts()
    results = eval_quantized.main(["--artifact", art, "--data_path",
                                   frames_dir, "--from_bitstream",
                                   stream_path])
    torch.cuda.synchronize()
    launches = dict(tf.KERNEL_LAUNCHES)
    psnr = float(results[0])
    assert math.isfinite(psnr), psnr
    assert abs(psnr - calib["eval_psnr"]) <= STREAM_PSNR_TOL, (
        psnr, calib["eval_psnr"])
    # every decode call is 4 conv, 2 pack_cf and 1 unpack_frames launches;
    # a stream decodes without any fake-quant
    n = launches["unpack_frames"]
    assert n > 0, launches
    assert launches == {"tail_conv_cf": 4 * n, "tail_conv_dw_cf": 0,
                        "pack_cf": 2 * n, "unpack_cf": 0, "unpack_frames": n,
                        "fq_uaq": 0, "fq_ada": 0, "fq_uaq_bwd": 0,
                        "fq_ada_bwd": 0}, launches
    print(f"  stream {len(stream)} bytes for {n_sym} symbols, bpp "
          f"{report['bpp']} (embeddings {report['embed_bits']} bits); native "
          f"coder encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s wall (host)")
    print(f"  eval_quantized --from_bitstream: PSNR {psnr:.4f} dB vs "
          f"{calib['eval_psnr']:.4f} from the artifact's state (tol "
          f"{STREAM_PSNR_TOL}); decode launches {launches}; card {card}")
    return dict(report=report, symbols=n_sym, encode_s=t1 - t0,
                decode_s=t2 - t1, psnr=psnr, launches=launches)


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
        # per kernel: registers, static shared memory, spills (ptxas -v)
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("   ", line.strip())
        elif "Compiling entry function" in line and "tail_conv" in line:
            print("   ", line.strip()[:160])

    cfg = validate_config(get_config(os.path.join(
        REPO, "configs", "HNeRV", "Bunny_1280x640_3M.yaml")), "hnerv")
    cfg["workers"] = 0
    rng = np.random.RandomState(SEED)
    model = build_model("hnerv", cfg, device="cuda")
    sd = _seeded_state_dict(model, rng)
    model.load_state_dict(state_dict_from_numpy(sd, "cuda"), strict=True)
    model.eval()

    frames_dir = tempfile.mkdtemp(prefix="nq_chip_frames_")
    work = tempfile.mkdtemp(prefix="nq_chip_calib_")
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
        calib = _calibrate_phase(torch, tf, cfg, sd, frames_dir, card, work,
                                 "jnp")
        print("[kernels: fake-quant]")
        frecords = _fq_kernel_phase(torch, tf, cfg, sd)
        print("[calibrate, --fq_impl pallas]")
        calib_fq = _calibrate_phase(torch, tf, cfg, sd, frames_dir, card,
                                    work, "pallas")
        worst = max(abs(a - b) for a, b in zip(calib_fq["psnr_blocks"],
                                               calib["psnr_blocks"]))
        print(f"  PSNR blocks, fq_impl pallas vs jnp at --iters_w "
              f"{CALIB_ITERS}: {calib_fq['psnr_blocks']} vs "
              f"{calib['psnr_blocks']} (max diff {worst:.3f} dB, tol "
              f"{PSNR_TOL}); phase 2 it/s: pallas {calib_fq['phase2_its']}, "
              f"jnp {calib['phase2_its']}; card {card}")
        assert worst <= PSNR_TOL, (calib_fq["psnr_blocks"],
                                   calib["psnr_blocks"])
        print("[bitstream]")
        stream = _bitstream_phase(torch, tf, calib_fq, frames_dir, card)
    finally:
        shutil.rmtree(frames_dir, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)

    src = "neuroquant_tpu_torch/csrc/{}.cu".format
    tpu = "neuroquant_tpu/ops/tail_fused.py:{}".format
    fq = "neuroquant_tpu/ops/pallas_fakequant.py:{}".format
    # the decode's kernels are summed over one decode's launches (batch 1),
    # the calibration's kernels over one step's (batch 2), the fake-quant
    # entries over one quantize_params call's seven layers; "launches" is
    # the count over a calibrate_network run (its steps and its evals): the
    # fq_impl jnp run for the tail's kernels, the fq_impl pallas run, which
    # the bitstream is made from, for the fake-quant entries
    sources = [("tail_conv_cf", records, tpu(1133), "per decode", calib),
               ("tail_conv_dw_cf", brecords, tpu(1172), "per step", calib),
               ("pack_cf", records, tpu(656), "per decode", calib),
               ("unpack_cf", brecords, tpu(666), "per step", calib),
               ("unpack_frames", records, tpu(2016), "per decode", calib),
               ("fq_uaq", frecords, fq(69), "per quantize_params call",
                calib_fq),
               ("fq_ada", frecords, fq(83), "per quantize_params call",
                calib_fq),
               # the JAX package's backward is the VJP of its plain chain
               # (no Pallas kernel); here it is a kernel of its own
               ("fq_uaq_bwd", frecords, fq(213) + " _uaq_bwd (jnp VJP)",
                "per quantize_params backward", calib_fq),
               ("fq_ada_bwd", frecords, fq(238) + " _ada_bwd (jnp VJP)",
                "per quantize_params backward", calib_fq)]
    kernels = []
    for name, recs, replaces, summed, run in sources:
        per = recs[name]["per_launch"]
        t_ops = sum(p["bound_ms"] for p in per if p["bound_by"] == "operations")
        t_bytes = sum(p["bound_ms"] for p in per if p["bound_by"] == "bytes")
        err = max(recs[name]["max_abs_err"],
                  brecords.get(name, {"max_abs_err": 0.0})["max_abs_err"])
        is_fq = name.startswith("fq_")
        kernels.append({
            "name": name, "route": "cuda",
            "source": src("fq_hadamard" if is_fq else name),
            "replaces": replaces, "launches": run["launches"][name],
            "fq_pallas_run_launches": calib_fq["launches"][name],
            "max_abs_err": err,
            "ms": sum(p["ms"] for p in per),
            "plain_ms": sum(p["plain_ms"] for p in per),
            "bound_ms": sum(p["bound_ms"] for p in per),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            # no single PyTorch call computes the fused fake-quant chain
            "library_ms": (None if is_fq
                           else sum(p["library_ms"] for p in per)),
            "summed": summed,
            **({"bound_tc_ms": sum(p["bound_tc_ms"] for p in per)}
               if name.startswith("tail_conv") else {}),
            **({"device_ms": sum(p["device_ms"] or 0.0 for p in per),
                "plain_device_ms": sum(p["plain_device_ms"] or 0.0
                                       for p in per)} if is_fq else {}),
            **({"device_ms": sum(p["device_ms"] or 0.0 for p in per),
                "library_device_ms": sum(p["library_device_ms"] or 0.0
                                         for p in per)}
               if name in ("pack_cf", "unpack_cf", "unpack_frames") else {}),
            "serving_launches": serve["launches"][name],
            "per_decode_launches": dec["launches"][name] // 4,
            # the fake-quant entries: per step of the phase that runs them
            "per_step_launches": (
                FQ_PHASE1[name] + FQ_PHASE2[name] if is_fq
                else PER_STEP[name]),
            "per_launch": per})
    kernels[0]["calibration_per_launch"] = brecords["tail_conv_cf"][
        "per_launch"]
    # the shape of the JAX width-tiled _unpack_kernel5, outside the sum;
    # pack_cf at the calibration step's batch, outside the decode's sum
    kernels[4]["width_tiled"] = records["unpack_frames"]["width_tiled"]
    kernels[2]["calibration_per_launch"] = records["pack_cf"][
        "calibration_per_launch"]
    for k in kernels:
        assert k["launches"] > 0, k["name"]
    for k in ("tail_conv_cf", "pack_cf", "unpack_frames"):
        assert serve["launches"][k] > 0, k
    print(f"  total {time.time() - t_start:.1f} s after start; decode "
          f"{dec['decode_ms']:.3f} ms/frame kernel path, "
          f"{dec['plain_decode_ms']:.3f} plain; calibration phase 2 "
          f"{calib['phase2_its']} it/s; card {card}")
    print(json.dumps({"card": card, "decode": dec, "serving": serve,
                      "step": grad, "calibrate": calib,
                      "quantize_params": frecords["quantize_params"],
                      "calibrate_fq_pallas": calib_fq, "bitstream": stream}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
