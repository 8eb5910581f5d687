#!/usr/bin/env python3
"""Times of the port's three layout kernels (pack_cf, unpack_cf,
unpack_frames) at every shape the HNeRV Bunny-3M main path launches them
with, and at the plan whose JAX unpack is the width-tiled _unpack_kernel5,
on one NVIDIA GPU.

  python3 scripts/torch_layout_bench.py [--root DIR]... [--check] [--sweep]
                                        [--decode] [--out FILE]

Each --root is a checkout of this repository (default: the one this script
lies in); with several, they are timed in turns inside the one process
(first, second, ..., second, first), so two commits are compared on one
card: unpack the other commit with ``git archive`` into a directory and
name both. Per shape and root:
- ms: CUDA events around back-to-back wrapper calls (what a caller pays
  per call when the host, not the card, sets the pace);
- device_ms: the card's own time per call, summed over the kernels it
  launches (torch.profiler);
- host_us: a host clock over 1,000 wrapper calls with no synchronisation
  between them (the enqueue cost);
- library_ms, library_device_ms and library_host_us: one PyTorch call of
  the same function (permute().contiguous(), F.pixel_shuffle).
Then, in every pass, one wrapper call's host cost split into its parts:
route and checks, allocation, stream lookup, the launcher's ctypes call without
a launch (the batch-0 early return) and the launch itself. --check holds
every output against the plain version (exact; out_img 1e-6). --sweep
times the newest root's pack_cf, unpack_cf and unpack_frames launchers
directly at other tiles than the wrappers choose. --decode times a batch-1 HNeRV
Bunny-3M decode (seeded random weights) per root and pass: back-to-back
ms and the card's busy ms, so the decode is compared on one card too.
Prints the card's name and power
limit first and writes every row as JSON to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CALLS = 1000


def _time_ms(torch, fn, iters=20, warmup=3):
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


def _device_ms(torch, fn, n=10, tries=3):
    """The card's time per call of `fn`, summed over its kernels (a trace
    now and then holds no device event: up to `tries` windows)."""
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


def _host_us(torch, fn, calls=HOST_CALLS):
    """Host microseconds per call, no synchronisation between calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def _load(root):
    """Import the root's tail_fused and build its kernels, apart from any
    copy imported before."""
    for name in [m for m in sys.modules
                 if m.startswith("neuroquant_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        tf = importlib.import_module("neuroquant_tpu_torch.ops.tail_fused")
        cu = importlib.import_module("neuroquant_tpu_torch.ops._cuda")
        cu.lib()
    finally:
        sys.path.remove(root)
    return tf, cu


def _cases(torch, tf):
    """(kernel, shape label, run, plain, library, bytes moved)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pplan = tf._prefix_plan(40, 80, 5, 64, 848)
    plan, f = tf.plan_geometry(160, 320, [(5, 53, 176, 2), (5, 44, 148, 2)],
                               (3, 37, 3))
    wplan, wf = tf.plan_geometry(4, 480, [(3, 17, 224, 4)], (3, 14, 3))
    out = []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for label, p, c in (("prefix entry", pplan, 64), ("tail entry", plan,
                                                        53)):
        for b in (1, 2):
            x = rand(b, p.h, p.w, c)
            nbytes = 4 * (x.numel() + b * tf._r8(c) * p.mp)
            out.append(("pack_cf", f"{label} {tuple(x.shape)} batch {b}",
                        lambda x=x, p=p: tf.pack_cf(x, p),
                        lambda x=x, p=p: tf.pack_cf_ref(x, p),
                        lambda x=x: x.permute(0, 3, 1, 2).contiguous(),
                        nbytes))
        g = rand(2, tf._r8(c), p.mp)
        xl = rand(2, c, p.h, p.w)
        out.append(("unpack_cf", f"{label} {tuple(g.shape)} batch 2",
                    lambda g=g, p=p, c=c: tf.unpack_cf(g, p, c),
                    lambda g=g, p=p, c=c: tf.unpack_cf_ref(g, p, c),
                    lambda xl=xl: xl.permute(0, 2, 3, 1).contiguous(),
                    4 * 2 * xl.numel()))
    for label, p, ff, b in (("decode", plan, f, 1), ("width-tiled plan",
                                                      wplan, wf, 2)):
        z = rand(b, p.layers[-1].cout, p.mp)
        zl = rand(b, 48, p.h, p.w)
        out.append(("unpack_frames", f"{label} {tuple(z.shape)} tanh",
                    lambda z=z, p=p, ff=ff: tf.unpack_frames(z, p, ff, 48,
                                                             "tanh"),
                    lambda z=z, p=p, ff=ff: tf.unpack_frames_ref(z, p, ff, 48,
                                                                 "tanh"),
                    lambda zl=zl, ff=ff: F.pixel_shuffle(zl, ff),
                    4 * 2 * zl.numel()))
    return out


def _decode(torch):
    """A batch-1 HNeRV Bunny-3M decode with seeded random weights (the
    loaded root's own model code): back-to-back ms over 50 decodes, and the
    card's busy ms per decode over 20 (profiler)."""
    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model

    cfg = validate_config(get_config(os.path.join(
        HERE, "configs", "HNeRV", "Bunny_1280x640_3M.yaml")), "hnerv")
    torch.manual_seed(0)
    model = build_model("hnerv", cfg, device="cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    e = torch.randn((1, *model.cfg.embed_hw, cfg["enc_channel"][-1]),
                    generator=gen, device="cuda")
    with torch.no_grad():
        ms = _time_ms(torch, lambda: model.decode(e), iters=50, warmup=5)
        busy = _device_ms(torch, lambda: model.decode(e), n=20)
    return dict(decode_ms=ms, busy_ms=busy,
                idle_share=None if busy is None else 1 - busy / ms)


def _import_cuda():
    """The import statement an older wrapper ran on every call."""
    from neuroquant_tpu_torch.ops import _cuda  # noqa: F401


def _host_split(torch, tf, cu):
    """One wrapper call's host cost by part, for pack_cf at the tail entry
    and unpack_frames at the decode (the root's own checks and launcher;
    both ways of allocating and of finding the stream)."""
    dev = torch.device("cuda")
    plan, f = tf.plan_geometry(160, 320, [(5, 53, 176, 2), (5, 44, 148, 2)],
                               (3, 37, 3))
    x = torch.randn((1, 160, 320, 53), device=dev)
    z = torch.randn((1, 48, plan.mp), device=dev)
    lib = cu.lib()
    rows = {}
    for name, t, shape, out_shape, fn in (
            ("pack_cf", x, (1, 160, 320, 53), (1, 56, plan.mp),
             lib.nq_pack_cf),
            ("unpack_frames", z, (1, 48, plan.mp), (1, 640, 1280, 3),
             lib.nq_unpack_frames)):
        out = torch.empty(out_shape, device=dev)
        zeros = [0.0 if a is ctypes.c_float else 0 for a in fn.argtypes]
        if len(fn.argtypes) in (4, 5):          # a parameter block
            if name == "pack_cf":
                prm = tf._pack_cf_launch(1, plan.h, plan.w, plan.pad,
                                         plan.tm, 53)[2]
                args = (x.data_ptr(), out.data_ptr(), prm)
            else:
                launch = tf._unpack_frames_launch(1, 48, plan.h, plan.w,
                                                  plan.pad, plan.tm, f, 48,
                                                  "tanh")
                args = (z.data_ptr(), out.data_ptr(), launch[3], launch[4])
        elif name == "pack_cf":                 # one int per argument
            args = (x.data_ptr(), out.data_ptr(), 1, 160, 320, 53, 56,
                    plan.pad, plan.mp)
        else:
            args = (z.data_ptr(), out.data_ptr(), 1, 48, plan.mp, 160, 320,
                    plan.pad, f, 3, 1, 0.0)
        stream = torch.cuda.current_stream().cuda_stream
        run = {"pack_cf": lambda: tf.pack_cf(x, plan),
               "unpack_frames": lambda: tf.unpack_frames(z, plan, f, 48,
                                                         "tanh")}[name]
        part = {
            "wrapper call": run,
            "route": lambda: tf._route(t, name),
            "checks": lambda: tf._check(t, name, shape),
            "torch.empty(device=t.device)": lambda: torch.empty(
                out_shape, dtype=t.dtype, device=t.device),
            "t.new_empty": lambda: t.new_empty(out_shape),
            "torch.cuda.current_stream().cuda_stream":
                lambda: torch.cuda.current_stream().cuda_stream,
            "raw current stream": lambda: torch._C._cuda_getCurrentRawStream(
                torch._C._cuda_getDevice()),
            "import _cuda inside the call": _import_cuda,
            "ctypes call, no launch": lambda: fn(*zeros),
            "ctypes call with the launch": lambda: fn(*args, stream),
            "data_ptr x2": lambda: (t.data_ptr(), out.data_ptr()),
        }
        rows[name] = {k: _host_us(torch, v) for k, v in part.items()}
        rows[name]["launch"] = (rows[name]["ctypes call with the launch"]
                                - rows[name]["ctypes call, no launch"])
    return rows


def _sweep(torch, tf, cu):
    """Device ms of the newest launchers at other tiles than the wrappers'
    (pack_cf and unpack_cf: positions per block; unpack_frames: columns and
    output rows per block)."""
    dev = torch.device("cuda")
    lib = cu.lib()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    pplan = tf._prefix_plan(40, 80, 5, 64, 848)
    plan, f = tf.plan_geometry(160, 320, [(5, 53, 176, 2), (5, 44, 148, 2)],
                               (3, 37, 3))
    wplan, wf = tf.plan_geometry(4, 480, [(3, 17, 224, 4)], (3, 14, 3))
    for label, p, c in (("prefix entry", pplan, 64), ("tail entry", plan,
                                                        53)):
        for b in (1, 2):
            x = torch.randn((b, p.h, p.w, c), device=dev)
            out = torch.empty((b, tf._r8(c), p.mp), device=dev)
            for tm in (8, 16, 32, 64, 128):
                if tf._pack_cf_smem(tm, c) > tf.LAYOUT_SMEM or p.mp % tm:
                    continue
                prm, addr = tf._c_ints(b, p.h, p.w, c, tf._r8(c), p.pad,
                                       p.mp, tm, 0, 0)
                ms = _device_ms(torch, lambda: lib.nq_pack_cf(
                    x.data_ptr(), out.data_ptr(), addr, stream))
                rows.append(dict(kernel="pack_cf", shape=f"{label} batch {b}",
                                 tile=tm, device_ms=ms))
                print(f"  sweep pack_cf {label} batch {b} tm={tm}: {ms}")
    for label, p, c in (("prefix entry", pplan, 64), ("tail entry", plan,
                                                        53)):
        g = torch.randn((2, tf._r8(c), p.mp), device=dev)
        out = torch.empty((2, p.h, p.w, c), device=dev)
        for tq in (8, 16, 32, 64, 128):
            if tf._unpack_cf_smem(tq, p.w, p.pad, c) > tf.LAYOUT_SMEM:
                continue
            prm, addr = tf._c_ints(2, p.h, p.w, c, tf._r8(c), p.pad, p.mp,
                                   tq, 0, 0)
            ms = _device_ms(torch, lambda: lib.nq_unpack_cf(
                g.data_ptr(), out.data_ptr(), addr, stream))
            rows.append(dict(kernel="unpack_cf", shape=f"{label} batch 2",
                             tile=tq, device_ms=ms))
            print(f"  sweep unpack_cf {label} batch 2 tq={tq}: {ms}")
    for label, p, ff, b in (("decode", plan, f, 1), ("decode", plan, f, 2),
                            ("width-tiled plan", wplan, wf, 2)):
        z = torch.randn((b, 48, p.mp), device=dev)
        out = torch.empty((b, p.h * ff, p.w * ff, 3), device=dev)
        for tx in (28, 60, 108, 124):
            for fu in (1, 2, 4):
                prm, addr = tf._c_ints(b, 48, p.mp, p.h, p.w, p.pad, ff, 3, 1,
                                       tx, fu, 0, 0)
                ms = _device_ms(torch, lambda: lib.nq_unpack_frames(
                    z.data_ptr(), out.data_ptr(), addr, 0.0, stream))
                rows.append(dict(kernel="unpack_frames",
                                 shape=f"{label} batch {b}", tile=tx,
                                 rows_per_block=fu, device_ms=ms))
                print(f"  sweep unpack_frames {label} batch {b} tx={tx} "
                      f"fu={fu}: {ms}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--decode", action="store_true",
                    help="also time a Bunny-3M decode per root and pass")
    ap.add_argument("--out", default=os.path.join(HERE, "results",
                                                  "layout_bench.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_layout_bench: needs one CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False       # as the entry points
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    order = list(range(len(roots)))
    order = order + order[::-1]
    rows, splits, sweep, decodes = [], {}, [], []
    for ri in order:
        tf, cu = _load(roots[ri])
        first = ri not in splits
        if args.decode:
            dec = dict(root=roots[ri], card=card, **_decode(torch))
            decodes.append(dec)
            print(f"  [{ri}] decode batch 1: {dec['decode_ms']:.4f} ms, card "
                  f"busy {dec['busy_ms']} ms, idle share {dec['idle_share']}")
        with torch.no_grad():
            for kernel, shape, run, plain, libcall, nbytes in _cases(torch,
                                                                    tf):
                if args.check and first:
                    got, want = run(), plain()
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    tol = 1e-6 if kernel == "unpack_frames" else 0.0
                    assert got.shape == want.shape and err <= tol, (
                        kernel, shape, err)
                row = dict(root=roots[ri], kernel=kernel, shape=shape,
                           ms=_time_ms(torch, run),
                           device_ms=_device_ms(torch, run),
                           host_us=_host_us(torch, run),
                           library_ms=_time_ms(torch, libcall),
                           library_device_ms=_device_ms(torch, libcall),
                           library_host_us=_host_us(torch, libcall),
                           bound_ms=nbytes / 3.35e12 * 1e3, card=card)
                rows.append(row)
                print(f"  [{ri}] {kernel} {shape}: {row['ms']:.4f} ms back "
                      f"to back, device {row['device_ms']}, host "
                      f"{row['host_us']:.2f} us/call; library "
                      f"{row['library_ms']:.4f} ms, device "
                      f"{row['library_device_ms']}, host "
                      f"{row['library_host_us']:.2f} us/call; bound "
                      f"{row['bound_ms']:.4f}")
                sys.stdout.flush()
            # in every pass: the host's speed drifts between passes
            split = _host_split(torch, tf, cu)
            splits.setdefault(ri, []).append(split)
            for name, parts in split.items():
                print(f"  [{ri}] host split, {name}: " + ", ".join(
                    f"{k} {v:.2f} us" for k, v in parts.items()))
    if args.sweep:
        with torch.no_grad():
            sweep = _sweep(torch, *_load(roots[-1]))
    for ri in range(len(roots)):
        print(f"root [{ri}] {roots[ri]}")
        for r in rows:
            if r["root"] == roots[ri]:
                print(f"  {r['kernel']} {r['shape']}: ms {r['ms']:.4f} "
                      f"device {r['device_ms']} host_us {r['host_us']:.2f}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, rows=rows, host_split={
            roots[k]: v for k, v in splits.items()}, sweep=sweep,
            decodes=decodes), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
