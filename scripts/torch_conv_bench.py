#!/usr/bin/env python3
"""Times of the port's two conv kernels (tail_conv_cf, tail_conv_dw_cf) at
every shape the HNeRV and NeRV Bunny-3M main paths launch, on one NVIDIA
GPU.

  python3 scripts/torch_conv_bench.py [--dtype fp32|bf16] [--root DIR]...
                                      [--check] [--models] [--out FILE]

Each --root is a checkout of this repository (default: the one this script
lies in); with several, their kernels are timed in turns inside the one
process (first, second, ..., second, first), so two commits are compared on
one card: unpack the other commit with ``git archive`` into a directory
and name both. --check also holds every launch against the plain version
(fp32: CONV_TOL of chip_smoke.py; bf16: phase 19's gate, a conv output
within one bf16 unit beyond CONV_TOL of the largest, dW and db within 1e-5
of the largest). Prints one line per shape and root, the card's name and
power limit first, each beside cuDNN's call of the same function in the
same dtype (F.conv2d, conv2d_input, conv2d_weight on the unpacked layer,
TF32 off in fp32: `library_ms`) and the bound (fp32: three TF32 products
a FLOP at 495 TFLOP/s, the kernels' 3xTF32, or the bytes at 3.35 TB/s),
then the sums per decode and per step of each model, and writes the rows
as JSON to --out.

Decode shapes are batch 1 (emit y or z), calibration shapes batch 2:
forward as the step launches it, the dx pass with its GELU' epilogue, the
dW pass. A root whose ``conv_cf`` knows no emit='zy' (before the pair was
added) is timed with the step it ran then: emit z, act_in on the input.

--dtype bf16 times the bf16 instantiations at the HNeRV shapes and at
PNeRV Bunny-3M's block (104 -> 400 at 320x640) and head (400 -> 16)
(in place of NeRV's), against cuDNN's bf16 calls and the bf16 bound (bf16
FLOPs at 989 TFLOP/s or bf16 bytes at 3.35 TB/s), with the host's
microseconds per wrapper call (the time to enqueue it, the card's queue
not full). The sums: per decode (the batch-1 forwards) and per
calibration step (the batch-2 forwards and dx passes; the dW passes).

--models times what the kernels serve instead of the kernels, each root
in turns: HNeRV Bunny-3M's decode at batch 1 in fp32 and under the bf16
matmul precision (CUDA events over 20 decodes, and the host's ms to
enqueue one), and one phase-2 calibration step at batch 2 in fp32 and
bf16, as chip_smoke.py's phase 19 runs it (its ``_bf16_step``: fp32 /
bf16 / bf16 / fp32, 10 steps each). Both are host-bound in bf16 and the
host slows after a profiler window in the process, so compare roots in
separate processes in turns (A B B A), one --root each.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

CONV_TOL = 1e-4
DW_TOL = 1e-5
PEAK_BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
PEAK_TF32_FLOP_PER_S = 495e12   # and TF32
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time_ms(torch, fn, iters=10, warmup=2):
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


def _host_us(torch, fn, calls=30, reps=3):
    """Host microseconds per call: the time to enqueue `calls` calls after
    the card's queue has drained, the least of `reps` tries."""
    best = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        us = (t1 - t0) / calls * 1e6
        best = us if best is None else min(best, us)
    return best


def _load(root):
    """Import neuroquant_tpu_torch.ops.tail_fused from `root`, apart from
    any copy imported before."""
    for name in [m for m in sys.modules
                 if m.startswith("neuroquant_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        tf = importlib.import_module("neuroquant_tpu_torch.ops.tail_fused")
        importlib.import_module("neuroquant_tpu_torch.ops._cuda").lib()
    finally:
        sys.path.remove(root)
    return tf


def _close(got, want):
    """fp32: the largest error over CONV_TOL of the largest value."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        tol = CONV_TOL * max(1.0, float(b.abs().max()))
        assert err <= tol, (err, tol)
        worst = max(worst, err / tol)
    return worst


def _close_bf16(torch, got, want):
    """bf16: the largest distance in bf16 units beyond CONV_TOL of the
    largest value (1 at most), or for fp32 dW and db the largest error
    over DW_TOL of the largest value."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if got[0].dtype == torch.float32:
            err = float((a - b).abs().max())
            tol = DW_TOL * float(b.abs().max())
            assert err <= tol, (err, tol)
            worst = max(worst, err / tol)
            continue
        allow = CONV_TOL * max(1.0, float(b.abs().max()))

        def spacing(t):
            _, e = torch.frexp(t)
            return torch.ldexp(torch.ones_like(t), e - 8)
        diff = (a - b).abs()
        units = diff / torch.maximum(spacing(a), spacing(b))
        beyond = units[diff > allow]
        u = float(beyond.max()) if beyond.numel() else 0.0
        assert u <= 1.0, u
        worst = max(worst, u)
    return worst


def _hnerv_layers(tf):
    """(model, name, plan, layer, real cin, real cout, decode emit, followed
    by a GELU, library conv (cin, h, w, cout, k)) of HNeRV Bunny-3M's four
    kernel-path convs."""
    pplan = tf._prefix_plan(40, 80, 5, 64, 848)
    plan, _ = tf.plan_geometry(160, 320, [(5, 53, 176, 2), (5, 44, 148, 2)],
                               (3, 37, 3))
    return [("hnerv", "prefix", pplan, pplan.layers[0], 64, 848, "z", False,
             (64, 40, 80, 848, 5)),
            ("hnerv", "L0", plan, plan.layers[0], 53, 176, "y", True,
             (53, 160, 320, 176, 5)),
            ("hnerv", "L1", plan, plan.layers[1], None, None, "y", True,
             (44, 320, 640, 148, 5)),
            ("hnerv", "head", plan, plan.layers[2], None, None, "z", False,
             (37, 640, 1280, 3, 3))]


def _nerv_layers(tf):
    """NeRV Bunny-3M's four kernel-path convs (the fused prefix block 36 ->
    24 x 16 at 40x80, the tail's 24 -> 96 (f=1), 96 -> 384 (f=2) and head
    384 -> 48 (f=4) at 160x320), as :func:`_hnerv_layers`."""
    import os

    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.models import tail_plan_for

    cfg = get_config(os.path.join(HERE, "configs", "NeRV",
                                  "Bunny_1280x640_3M.yaml"))
    pplan = tf._prefix_plan(40, 80, 3, 36, 384)
    plan = tail_plan_for("nerv", cfg)[0]
    return [("nerv", "prefix", pplan, pplan.layers[0], 36, 384, "z", False,
             (36, 40, 80, 384, 3)),
            ("nerv", "L0", plan, plan.layers[0], 24, 96, "y", True,
             (24, 160, 320, 96, 3)),
            ("nerv", "L1", plan, plan.layers[1], None, None, "y", True,
             (24, 320, 640, 96, 3)),
            ("nerv", "head", plan, plan.layers[2], None, None, "z", False,
             (24, 640, 1280, 3, 3))]


def _pnerv_layers(tf):
    """PNeRV Bunny-3M's two tail convs (its post-fusion block 100 -> 400 at
    320x640, f=1, and the head, f=2), as :func:`_hnerv_layers`."""
    plan, _ = tf.plan_geometry(320, 640, [(3, 100, 400, 2)], (3, 100, 3))
    return [("pnerv", "block", plan, plan.layers[0], 100, 400, "y", True,
             (100, 320, 640, 400, 3)),
            ("pnerv", "head", plan, plan.layers[1], None, None, "z", False,
             (100, 640, 1280, 3, 3))]


def _all_cases(torch, tf, check, dtype):
    """(name, useful GFLOP, run, plain or None, library or None, bytes)
    per main-path launch."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    has_zy = "zy" in getattr(tf, "_EMITS", ())
    bf16 = dtype == "bf16"
    dt = torch.bfloat16 if bf16 else torch.float32
    layers = _hnerv_layers(tf) + (_pnerv_layers(tf) if bf16 else
                                  _nerv_layers(tf))
    out = []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def add_layer(model, name, p, layer, cin, cout, demit, nxt, lib):
        mask = tf.border_mask(p, device=dev)
        kk = (rand(layer.side, layer.side, layer.cin, layer.cout)
              * 0.05).to(dt)
        bias = (rand(layer.cout, 1) * 0.1).to(dt)
        w_op = tf.conv_w_operand(kk, p, layer)
        lt = layer.transposed()
        kt = tf._kk_transpose(kk).contiguous()
        wt_op = tf.conv_w_operand(kt, p, lt)
        blocks = tf._k_blocks(p, layer)
        lcin, lh, lw, lcout, lk = lib
        wl = (rand(lcout, lcin, lk, lk) * 0.05).to(dt)
        for batch in (1, 2):
            x = (rand(batch, layer.cin, p.mp) * mask).to(dt).contiguous()
            gfl = tf.conv_cf_flops(p, layer, batch, cin, cout) / 1e9
            xl = rand(batch, lcin, lh, lw).to(dt)
            xb, wb = x.numel() * x.element_size(), kk.numel() * 2
            if batch == 1:
                out.append((
                    f"{model} decode {name} emit={demit}", gfl,
                    lambda x=x, e=demit: tf.conv_cf(x, kk, bias, p, layer, e,
                                                    False, w_op),
                    lambda x=x, e=demit: tf.conv_cf_ref(x, kk, bias, p, layer,
                                                        e, False, blocks),
                    lambda xl=xl: F.conv2d(xl, wl, padding=lk // 2),
                    xb + wb + x.element_size() * layer.cout * p.mp))
                continue
            g = (rand(batch, layer.cout, p.mp) * mask).to(dt).contiguous()
            gl = rand(batch, lcout, lh, lw).to(dt)
            act = layer.gelu_in
            if has_zy:
                emit, a = ("zy" if nxt else "z"), False
            else:
                emit, a = "z", act
            out.append((
                f"{model} step forward {name} emit={emit} act_in={a}", gfl,
                lambda x=x, e=emit, a=a: tf.conv_cf(x, kk, bias, p, layer, e,
                                                    a, w_op),
                lambda x=x, e=emit, a=a: tf.conv_cf_ref(x, kk, bias, p, layer,
                                                        e, a, blocks),
                lambda xl=xl: F.conv2d(xl, wl, padding=lk // 2),
                xb + wb + g.numel() * g.element_size() * len(emit)))
            om = x if act else None
            out.append((
                f"{model} step dx {name} out_mul={act}", gfl,
                lambda g=g, om=om: tf.conv_cf(g, kt, None, p, lt, w_op=wt_op,
                                              out_mul=om),
                lambda g=g, om=om: tf.conv_cf_ref(
                    g, kt, None, p, lt, blocks=tf._k_blocks(p, lt),
                    out_mul=om),
                lambda xl=xl, gl=gl: torch.nn.grad.conv2d_input(
                    xl.shape, wl, gl, padding=lk // 2),
                g.numel() * g.element_size() + wb
                + xb * (2 if om is not None else 1)))
            out.append((
                f"{model} step dW {name} act_in={a}", gfl,
                lambda x=x, g=g, a=a: tf.conv_cf_dw(x, g, p, layer, a),
                lambda x=x, g=g, a=a: tf.conv_cf_dw_ref(x, g, p, layer, a,
                                                        blocks),
                lambda xl=xl, gl=gl: torch.nn.grad.conv2d_weight(
                    xl, wl.shape, gl, padding=lk // 2),
                xb + g.numel() * g.element_size()
                + 4 * (kk.numel() + layer.cout)))
    for spec in layers:
        add_layer(*spec)
    if not check:
        out = [(n, f, run, None, lib, nb) for n, f, run, _, lib, nb in out]
    return out


def _cases(torch, tf, check):
    """The fp32 cases as (name, useful GFLOP, run, plain or None), and the
    fp32 check (scripts/torch_conv_variants.py reads them)."""
    return ([c[:4] for c in _all_cases(torch, tf, check, "fp32")], _close)


def _bound_ms(gflop, nbytes, bf16=True):
    """The least time: bf16 FLOPs at 989 TFLOP/s, or fp32 FLOPs as three
    TF32 products each at 495 TFLOP/s (the kernels' 3xTF32), against the
    bytes at 3.35 TB/s."""
    t_ops = (gflop * 1e9 / PEAK_BF16_FLOP_PER_S if bf16 else
             3 * gflop * 1e9 / PEAK_TF32_FLOP_PER_S) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _sums(names, ms_of):
    """Per model: the decode (batch-1 forwards), the step's forwards and dx
    passes, the step's dW passes."""
    out = {}
    for n in names:
        model, kind = n.split()[0], n.split()[1]
        key = (f"{model} per decode" if kind == "decode" else
               f"{model} per step, dW" if " dW " in n else
               f"{model} per step, forward and dx")
        out[key] = out.get(key, 0.0) + ms_of(n)
    return out


def _models(torch, root, rounds):
    """One turn of --models at `root`: {decode fp32 / bf16 ms, host ms to
    enqueue a decode, calibration step fp32 / bf16 ms}."""
    import numpy as np
    import tempfile
    import shutil

    sys.path.insert(0, HERE)
    import chip_smoke as cs

    for name in [m for m in sys.modules
                 if m.startswith("neuroquant_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    frames = tempfile.mkdtemp(prefix="nq_bench_frames_")
    try:
        from neuroquant_tpu_torch.config import get_config, validate_config
        from neuroquant_tpu_torch.models import build_model
        from neuroquant_tpu_torch.ops import precision
        from neuroquant_tpu_torch.ops import tail_fused as tf
        from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy
        from neuroquant_tpu_torch.utils.device import resolve_device

        resolve_device("cuda")
        cfg = validate_config(get_config(os.path.join(HERE, cs.HNERV_CONFIG)),
                              "hnerv")
        cfg["workers"] = 0
        model = build_model("hnerv", cfg, device="cuda")
        sd = cs._seeded_state_dict(model, np.random.RandomState(cs.SEED))
        model.load_state_dict(state_dict_from_numpy(sd, "cuda"), strict=True)
        model.eval()
        cs._write_frames(frames, np.random.RandomState(cs.SEED))
        img = torch.rand((1, cfg["crop_h"], cfg["crop_w"], 3),
                         generator=torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        out = {}
        with torch.no_grad():
            emb = model.encode(img)
            for mode in ("default", "bfloat16"):
                with precision.matmul_precision(mode):
                    out[f"decode_{mode}_ms"] = _time_ms(
                        torch, lambda: model.decode(emb), 20, 3)
                    out[f"decode_{mode}_host_ms"] = _host_us(
                        torch, lambda: model.decode(emb), 10) / 1e3
        for _ in range(rounds):
            step = cs._bf16_step(torch, tf, cfg, sd, frames, "hnerv", True)
            out.setdefault("step_fp32_ms", []).extend(step["fp32_ms"])
            out.setdefault("step_bf16_ms", []).extend(step["bf16_ms"])
        return out
    finally:
        sys.path.remove(root)
        shutil.rmtree(frames, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--models", action="store_true")
    ap.add_argument("--out", default=os.path.join(HERE, "results",
                                                  "conv_bench.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_conv_bench: needs one CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    bf16 = args.dtype == "bf16"
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    rows = []
    order = list(range(len(roots)))
    order = order + order[::-1]
    per_root, lib_ms, host = {}, {}, {}
    for ri in ([] if args.models else order):
        tf = _load(roots[ri])
        cases = _all_cases(torch, tf, args.check and ri not in per_root,
                           args.dtype)
        times = per_root.setdefault(ri, {})
        for name, gfl, run, ref, lib, nbytes in cases:
            worst = None
            with torch.no_grad():
                if ref is not None:
                    worst = (_close_bf16(torch, run(), ref()) if bf16
                             else _close(run(), ref()))
                ms = _time_ms(torch, run, args.iters)
                if bf16:
                    host.setdefault((ri, name), []).append(
                        _host_us(torch, run))
                if name not in lib_ms:
                    lib_ms[name] = _time_ms(torch, lib, args.iters)
            times.setdefault(name, []).append(ms)
            line = (f"  [{ri}] {name}: {ms:.4f} ms, {gfl / ms:.2f} TFLOP/s "
                    f"useful")
            row = dict(root=roots[ri], shape=name, ms=ms, useful_gflop=gfl,
                       card=card)
            bound, by = _bound_ms(gfl, nbytes, bf16)
            line += (f"; cuDNN {args.dtype} {lib_ms[name]:.4f} ms "
                     f"({gfl / lib_ms[name]:.2f} TFLOP/s); bound "
                     f"{bound:.4f} by {by} ({100 * bound / ms:.1f}%)")
            row.update(library_ms=lib_ms[name], bound_ms=bound, bound_by=by)
            if bf16:
                line += f"; host {host[(ri, name)][-1]:.1f} us a call"
                row.update(host_us=host[(ri, name)][-1])
            if worst is not None:
                line += (f", error {worst:.3f} of tolerance" if not bf16 else
                         f", error {worst:.3f} (bf16 units or of 1e-5)")
            print(line)
            sys.stdout.flush()
            rows.append(row)
    summary = {}
    for ri, times in per_root.items():
        print(f"root [{ri}] {roots[ri]}")
        for name, ms in times.items():
            print(f"  {name}: " + " ".join(f"{m:.4f}" for m in ms)
                  + ("" if not bf16 else
                     "; host us " + " ".join(
                         f"{u:.1f}" for u in host[(ri, name)])))
        for turn in range(len(next(iter(times.values()), []))):
            sums = _sums(times, lambda n: times[n][turn])
            for key, v in sums.items():
                print(f"  sum {key}, turn {turn + 1}: {v:.4f} ms")
                summary.setdefault(roots[ri], {}).setdefault(
                    key, []).append(v)
    for key, v in _sums(lib_ms, lambda n: lib_ms[n]).items():
        print(f"cuDNN {args.dtype} sum {key}: {v:.4f} ms")
        summary.setdefault(f"cuDNN {args.dtype}", {})[key] = v
    models = []
    if args.models:
        for ri in order:
            turn = _models(torch, roots[ri], 1)
            print(f"[{ri}] {roots[ri]}: " + ", ".join(
                f"{k} " + (" / ".join(f"{v:.3f}" for v in val)
                           if isinstance(val, list) else f"{val:.3f}")
                for k, val in turn.items()))
            sys.stdout.flush()
            models.append(dict(root=roots[ri], **turn))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, dtype=args.dtype, rows=rows,
                       sums=summary, models=models), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
