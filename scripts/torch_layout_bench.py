#!/usr/bin/env python3
"""Times of the port's three layout kernels (pack_cf, unpack_cf,
unpack_frames) at every shape the HNeRV Bunny-3M main path launches them
with, at the plan whose JAX unpack is the width-tiled _unpack_kernel5, and
at PNeRV Bunny-3M's entry (c = 100) and sigmoid head, on one NVIDIA GPU.

  python3 scripts/torch_layout_bench.py [--dtype fp32|bf16] [--root DIR]...
                                        [--check] [--sweep] [--decode]
                                        [--out FILE]

--dtype picks the instantiations: fp32 (rows 3-6 of PERF.md's kernel
table) or bf16 (rows 3b-6b: pack_cf from fp32 at batch 1 and from bf16 at
batch 2, unpack_cf back to bf16 and to fp32 at batch 2, PNeRV's c = 100
entry too, unpack_frames from bf16 to fp32 and to bf16 frames), at the
shapes chip_smoke.py's phases launch them. The closing summary gives each
shape's byte bound beside its times.

Each --root is a checkout of this repository (default: the one this script
lies in); with several, they are timed in turns inside the one process
(first, second, ..., second, first), so two commits are compared on one
card: unpack the other commit with ``git archive`` into a directory and
name both. Per shape and root:
- ms: CUDA events around back-to-back wrapper calls (what a caller pays
  per call when the host, not the card, sets the pace);
- hot_ms and cold_ms: the card's own time per call
  (``neuroquant_tpu_torch.utils.profiling.hot_cold``). N calls are queued
  behind ``torch.cuda._sleep`` so that the host has enqueued them all
  before the card starts, and CUDA events around them are divided by N;
  a window the host did not fill in time is taken again behind a longer
  sleep, and reads None if it never is. Hot: the same input every call,
  so it stays in the 50 MB L2 as on the main path, where the kernel
  before has just written it. Cold: a rotation of inputs and outputs of
  more than 128 MB in all, so every call reads from device memory and the
  byte bound holds;
- host_us: a host clock over 1,000 wrapper calls with no synchronisation
  between them (the enqueue cost);
- the same readings for one PyTorch call near the same function (named in
  ``library``, with the bytes it moves): permute + contiguous (+ the cast)
  for pack_cf and unpack_cf, F.pixel_shuffle for unpack_frames. None of
  them writes a border ring, a channel pad or applies out_img.
Then, in every pass, one wrapper call's host cost split into its parts
(route, checks, the launch record, allocation, stream lookup, the
launcher's ctypes call without a launch and with it, the count), for
pack_cf at the tail entry and unpack_frames at the decode, in each
instantiation of --dtype. --check holds every output against the plain
version (exact; unpack_frames' fp32 frames 1e-6, bf16 frames one bf16
unit). --sweep times the newest root's launchers directly at other tiles
than the wrappers choose (hot, by events). --decode times a batch-1 HNeRV
Bunny-3M decode (seeded random weights; with --dtype bf16 under the bf16
matmul precision) per root and pass: back-to-back ms and the card's busy
ms (profiler; the host runs slower after a profiler window, so take the
host split from a run without --decode). Prints the card's name and
power limit first and writes every row as JSON to --out.
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
# the event method, from the checkout this script lies in whatever --root
sys.path.insert(0, HERE)
from neuroquant_tpu_torch.utils.profiling import hot_cold, queued_ms  # noqa: E402
sys.path.remove(HERE)

HOST_CALLS = 1000
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def _fmt(v):
    return "not measured" if v is None else f"{v:.4f}"


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


def _device_ms(torch, fn, n=20):
    """The card's busy time per call of `fn`, summed over its kernels
    (torch.profiler); None when a trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
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


def _host_us(torch, fn, calls=HOST_CALLS, repeats=3):
    """Host microseconds per call, no synchronisation between calls: the
    least of `repeats` runs of `calls` calls."""
    for _ in range(10):
        fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / calls


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


def _plans(tf):
    """(prefix plan, tail plan and f, width-tiled plan and f, PNeRV's plan
    and f) at Bunny-3M."""
    return (tf._prefix_plan(40, 80, 5, 64, 848),
            tf.plan_geometry(160, 320, [(5, 53, 176, 2), (5, 44, 148, 2)],
                             (3, 37, 3)),
            tf.plan_geometry(4, 480, [(3, 17, 224, 4)], (3, 14, 3)),
            tf.plan_geometry(320, 640, [(3, 100, 400, 2)], (3, 100, 3)))


def _name(dt) -> str:
    return str(dt)[6:]


def _transpose(x, dims, dtype):
    """The library call of pack_cf and unpack_cf: x permuted, in `dtype`,
    contiguous (``.to`` of the permuted view launches nothing when the
    dtype is x's own, so that case takes ``.contiguous()``)."""
    import torch

    y = x.permute(*dims)
    if dtype is x.dtype:
        return y.contiguous()
    return y.to(dtype, memory_format=torch.contiguous_format)


def _cases(torch, tf, dtype):
    """One dict per kernel and shape: make(i) -> inputs, run(inputs) -> the
    wrapper's output, plain(inputs), lib_make(i) -> the library call's
    inputs, lib(inputs), the kernel's and the library's bytes, the check's
    tolerance ("exact", "1e-6" or "unit")."""
    import torch.nn.functional as F

    f32, bf = torch.float32, torch.bfloat16
    dev = torch.device("cuda")
    pplan, (plan, f), (wplan, wf), (nplan, nf) = _plans(tf)

    def rand(seed, shape, dt):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).to(dt)

    out = []

    def pack(label, p, c, b, src, dst):
        shape = (b, p.h, p.w, c)
        es, ed = torch.finfo(src).bits // 8, torch.finfo(dst).bits // 8
        out.append(dict(
            kernel="pack_cf",
            shape=f"{label} {shape} {_name(src)} -> {_name(dst)} batch {b}",
            make=lambda i: rand(i, shape, src),
            run=lambda x: tf.pack_cf(x, p, dst),
            plain=lambda x: tf.pack_cf_ref(x, p, dst),
            lib_make=lambda i: rand(i, shape, src),
            lib=lambda x: _transpose(x, (0, 3, 1, 2), dst),
            library="permute(0, 3, 1, 2) + cast, contiguous: no ring, no pad",
            nbytes=es * b * c * p.h * p.w + ed * b * tf._r8(c) * p.mp,
            lib_nbytes=(es + ed) * b * c * p.h * p.w, tol="exact"))

    def unpack(label, p, c, b, src, dst):
        shape = (b, tf._r8(c), p.mp)
        lshape = (b, c, p.h, p.w)
        es, ed = torch.finfo(src).bits // 8, torch.finfo(dst).bits // 8
        out.append(dict(
            kernel="unpack_cf",
            shape=f"{label} {shape} {_name(src)} -> {_name(dst)} batch {b}",
            make=lambda i: rand(i, shape, src),
            run=lambda g: tf.unpack_cf(g, p, c, dst),
            plain=lambda g: tf.unpack_cf_ref(g, p, c, dst),
            lib_make=lambda i: rand(i, lshape, src),
            lib=lambda x: _transpose(x, (0, 2, 3, 1), dst),
            library="permute(0, 2, 3, 1) + cast, contiguous: dense input",
            nbytes=(es + ed) * b * c * p.h * p.w,
            lib_nbytes=(es + ed) * b * c * p.h * p.w, tol="exact"))

    def frames(label, p, ff, b, ob, src, dst):
        cp = p.layers[-1].cout
        ch = 3 * ff * ff
        shape = (b, cp, p.mp)
        lshape = (b, ch, p.h, p.w)
        es, ed = torch.finfo(src).bits // 8, torch.finfo(dst).bits // 8
        out.append(dict(
            kernel="unpack_frames",
            shape=f"{label} {shape} {_name(src)} -> {_name(dst)} {ob}",
            make=lambda i: rand(i, shape, src),
            run=lambda z: tf.unpack_frames(z, p, ff, ch, ob, dst),
            plain=lambda z: tf.unpack_frames_ref(z, p, ff, ch, ob, dst),
            lib_make=lambda i: rand(i, lshape, src),
            lib=lambda x: F.pixel_shuffle(x, ff),
            library=f"F.pixel_shuffle on dense {_name(src)} NCHW: no "
                    f"border slice, no out_img, {_name(src)} NCHW out",
            nbytes=(es + ed) * b * ch * p.h * p.w,
            lib_nbytes=2 * es * b * ch * p.h * p.w,
            tol="unit" if dst is bf else "1e-6"))

    if dtype == "fp32":
        for label, p, c in (("prefix entry", pplan, 64),
                            ("tail entry", plan, 53)):
            for b in (1, 2):
                pack(label, p, c, b, f32, f32)
            unpack(label, p, c, 2, f32, f32)
        frames("decode", plan, f, 1, "tanh", f32, f32)
        frames("width-tiled plan", wplan, wf, 2, "tanh", f32, f32)
        pack("PNeRV entry", nplan, 100, 1, f32, f32)
        frames("PNeRV head", nplan, nf, 1, "sigmoid", f32, f32)
        return out
    # rows 3b-6b as chip_smoke.py's phase 19 launches them, then PNeRV's
    for label, p, c in (("prefix entry", pplan, 64), ("tail entry", plan,
                                                        53)):
        pack(label, p, c, 1, f32, bf)
        pack(label, p, c, 2, bf, bf)
    for dst in (bf, f32):
        for label, p, c in (("prefix entry", pplan, 64),
                            ("tail entry", plan, 53),
                            ("PNeRV entry", nplan, 100)):
            unpack(label, p, c, 2, bf, dst)
    for dst in (f32, bf):
        frames("decode", plan, f, 1, "tanh", bf, dst)
    for dst in (f32, bf):
        frames("width-tiled plan", wplan, wf, 2, "tanh", bf, dst)
    pack("PNeRV entry", nplan, 100, 1, f32, bf)
    pack("PNeRV entry", nplan, 100, 2, bf, bf)
    frames("PNeRV head", nplan, nf, 1, "sigmoid", bf, f32)
    frames("PNeRV head", nplan, nf, 1, "sigmoid", bf, bf)
    return out


def _check(torch, case, x, first):
    """The case's output against its plain version at its tolerance, and
    against `first` (the first root's output on the same input, None in
    the first root). Returns (max abs error, output, whether it equals
    `first` bit for bit)."""
    got, want = case["run"](x), case["plain"](x)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, case["shape"]
    err = float((got.float() - want.float()).abs().max())
    if case["tol"] == "exact":
        ok = torch.equal(got, want)
    elif case["tol"] == "1e-6":
        ok = err <= 1e-6
    else:                       # one bf16 unit at the element
        _, e = torch.frexp(want.float())
        unit = torch.ldexp(torch.ones_like(want, dtype=torch.float32), e - 8)
        ok = bool(((got.float() - want.float()).abs() <= unit).all())
    assert ok, (case["kernel"], case["shape"], err)
    return err, got, None if first is None else bool(torch.equal(got, first))


def _measure(torch, case):
    """The row of one case: back-to-back, hot and cold ms of the wrapper and
    of the library call, host us of both."""
    x = case["make"](0)
    xl = case["lib_make"](0)
    run, lib = case["run"], case["lib"]
    hot, cold = hot_cold(case["make"], run, case["nbytes"])
    lhot, lcold = hot_cold(case["lib_make"], lib, case["lib_nbytes"])
    torch.cuda.empty_cache()
    return dict(
        kernel=case["kernel"], shape=case["shape"],
        ms=_time_ms(torch, lambda: run(x)), hot_ms=hot, cold_ms=cold,
        host_us=_host_us(torch, lambda: run(x)),
        library=case["library"], library_ms=_time_ms(torch, lambda: lib(xl)),
        library_hot_ms=lhot, library_cold_ms=lcold,
        library_host_us=_host_us(torch, lambda: lib(xl)),
        mbytes=case["nbytes"] / 1e6, library_mbytes=case["lib_nbytes"] / 1e6,
        bound_ms=case["nbytes"] / PEAK_BYTES_PER_S * 1e3)


def _decode(torch, dtype):
    """A batch-1 HNeRV Bunny-3M decode with seeded random weights (the
    loaded root's own model code; bf16: under the bf16 matmul precision):
    back-to-back ms over 50 decodes, and the card's busy ms per decode over
    20 (profiler)."""
    import contextlib

    from neuroquant_tpu_torch.config import get_config, validate_config
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.ops import precision

    cfg = validate_config(get_config(os.path.join(
        HERE, "configs", "HNeRV", "Bunny_1280x640_3M.yaml")), "hnerv")
    torch.manual_seed(0)
    model = build_model("hnerv", cfg, device="cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    e = torch.randn((1, *model.cfg.embed_hw, cfg["enc_channel"][-1]),
                    generator=gen, device="cuda")
    ctx = (precision.matmul_precision("bfloat16") if dtype == "bf16"
           else contextlib.nullcontext())
    with ctx, torch.no_grad():
        ms = _time_ms(torch, lambda: model.decode(e), iters=50, warmup=5)
        busy = _device_ms(torch, lambda: model.decode(e), n=20)
    return dict(decode_ms=ms, busy_ms=busy,
                idle_share=None if busy is None else 1 - busy / ms)


def _captured_launch(tf, run):
    """(launch count name, launcher, its arguments without the stream) of
    one wrapper call, caught at the root's own `_launch`."""
    seen = []
    orig = tf._launch
    tf._launch = lambda name, fn, *args: seen.append((name, fn, args))
    try:
        run()
    finally:
        tf._launch = orig
    assert len(seen) == 1, seen
    return seen[0]


def _host_split(torch, tf, dtype):
    """One wrapper call's host cost by part (each the least of five runs
    of 1,000 calls), for pack_cf at the tail entry and unpack_frames at the
    decode in each instantiation of `dtype`, bf16 beside fp32 (the root's
    own checks, launch record and launcher)."""
    f32, bf = torch.float32, torch.bfloat16
    dev = torch.device("cuda")
    _, (plan, f), _, _ = _plans(tf)
    # bf16: beside the fp32 instantiation at the same shape
    pairs = {"fp32": ((f32, f32),),
             "bf16": ((f32, f32), (f32, bf), (bf, bf))}[dtype]
    fpairs = {"fp32": ((f32, f32),),
              "bf16": ((f32, f32), (bf, f32), (bf, bf))}[dtype]
    rows, jobs = {}, []
    for src, dst in pairs:
        x = torch.randn((1, 160, 320, 53), device=dev).to(src)
        jobs.append((f"pack_cf {_name(src)} -> {_name(dst)}", "pack_cf", x,
                     (1, 56, plan.mp), dst,
                     lambda x=x, dst=dst: tf.pack_cf(x, plan, dst),
                     lambda src=src, dst=dst: tf._pack_cf_launch(
                         1, plan.h, plan.w, plan.pad, plan.tm, 53, src,
                         dst)))
    for src, dst in fpairs:
        z = torch.randn((1, 48, plan.mp), device=dev).to(src)
        jobs.append((f"unpack_frames {_name(src)} -> {_name(dst)}",
                     "unpack_frames", z, (1, 640, 1280, 3), dst,
                     lambda z=z, dst=dst: tf.unpack_frames(z, plan, f, 48,
                                                           "tanh", dst),
                     lambda src=src, dst=dst: tf._unpack_frames_launch(
                         1, 48, plan.h, plan.w, plan.pad, plan.tm, f, 48,
                         "tanh", src, dst)))
    for label, name, t, out_shape, dst, run, record in jobs:
        count, fn, args = _captured_launch(tf, run)
        zeros = [0.0 if a is ctypes.c_float else 0 for a in fn.argtypes]
        out = torch.empty(out_shape, device=dev, dtype=dst)
        stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        part = {
            "wrapper call": run,
            "route": lambda t=t, name=name: tf._route(t, name),
            "checks": lambda t=t, name=name: tf._check(t, name,
                                                       tuple(t.shape),
                                                       t.dtype),
            "launch record (cached)": record,
            "t.new_empty": lambda t=t, s=out_shape, d=dst: t.new_empty(
                s, dtype=d),
            "raw current stream": lambda: torch._C._cuda_getCurrentRawStream(
                torch._C._cuda_getDevice()),
            "ctypes call, no launch": lambda fn=fn, z=zeros: fn(*z),
            "ctypes call with the launch": lambda fn=fn, a=args, s=stream:
                fn(*a, s),
            "data_ptr x2": lambda t=t, o=out: (t.data_ptr(), o.data_ptr()),
            "count": lambda c=count: tf.KERNEL_LAUNCHES.__setitem__(
                c, tf.KERNEL_LAUNCHES[c] + 1),
        }
        rows[label] = {k: _host_us(torch, v, repeats=5)
                       for k, v in part.items()}
        rows[label]["launch"] = (rows[label]["ctypes call with the launch"]
                                 - rows[label]["ctypes call, no launch"])
    return rows


def _sweep(torch, tf, dtype):
    """Hot device ms of the newest root's launchers at other tiles than the
    wrappers': pack_cf and unpack_cf (positions per block), unpack_frames
    (columns and output rows per block); bf16: :func:`_sweep_bf16`."""
    if dtype == "bf16":
        return _sweep_bf16(torch, tf)
    dev = torch.device("cuda")
    lib = tf._cuda.lib()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    pplan, (plan, f), (wplan, wf), _ = _plans(tf)

    def ms(fn):
        return queued_ms([fn])
    for label, p, c in (("prefix entry", pplan, 64), ("tail entry", plan,
                                                        53)):
        for b in (1, 2):
            x = torch.randn((b, p.h, p.w, c), device=dev)
            out = torch.empty((b, tf._r8(c), p.mp), device=dev)
            for tm in (8, 16, 32, 64, 128):
                if tf._pack_cf_smem(tm, c) > tf.LAYOUT_SMEM or p.mp % tm:
                    continue
                prm, addr = tf._c_ints(b, p.h, p.w, c, tf._r8(c), p.pad,
                                       p.mp, tm, 0, 0,
                                       tf._pack_cf_smem(tm, c))
                t = ms(lambda: lib.nq_pack_cf(x.data_ptr(), out.data_ptr(),
                                              addr, stream))
                rows.append(dict(kernel="pack_cf", shape=f"{label} batch {b}",
                                 tile=tm, hot_ms=t))
                print(f"  sweep pack_cf {label} batch {b} tm={tm}: {_fmt(t)}")
    for label, p, c in (("prefix entry", pplan, 64), ("tail entry", plan,
                                                        53)):
        g = torch.randn((2, tf._r8(c), p.mp), device=dev)
        out = torch.empty((2, p.h, p.w, c), device=dev)
        for tq in (8, 16, 32, 64, 128):
            if tf._unpack_cf_smem(tq, p.w, p.pad, c) > tf.LAYOUT_SMEM:
                continue
            prm, addr = tf._c_ints(2, p.h, p.w, c, tf._r8(c), p.pad, p.mp,
                                   tq, 0, 0)
            t = ms(lambda: lib.nq_unpack_cf(g.data_ptr(), out.data_ptr(),
                                            addr, stream))
            rows.append(dict(kernel="unpack_cf", shape=f"{label} batch 2",
                             tile=tq, hot_ms=t))
            print(f"  sweep unpack_cf {label} batch 2 tq={tq}: {_fmt(t)}")
    for label, p, ff, b in (("decode", plan, f, 1), ("decode", plan, f, 2),
                            ("width-tiled plan", wplan, wf, 2)):
        z = torch.randn((b, 48, p.mp), device=dev)
        out = torch.empty((b, p.h * ff, p.w * ff, 3), device=dev)
        for tx in (28, 60, 108, 124):
            for fu in (1, 2, 4):
                prm, addr = tf._c_ints(
                    b, 48, p.mp, p.h, p.w, p.pad, ff, 3, 1, tx, fu, 0, 0, 0,
                    4 * fu * 3 * ff * (-(-tx // 4) * 4 + 4))
                t = ms(lambda: lib.nq_unpack_frames(
                    z.data_ptr(), out.data_ptr(), addr, stream))
                rows.append(dict(kernel="unpack_frames",
                                 shape=f"{label} batch {b}", tile=tx,
                                 rows_per_block=fu, hot_ms=t))
                print(f"  sweep unpack_frames {label} batch {b} tx={tx} "
                      f"fu={fu}: {_fmt(t)}")
    return rows


def _sweep_bf16(torch, tf):
    """Hot and cold device ms of the bf16 launchers at other tiles than the
    wrappers choose: pack_cf (positions per tile) at the tail, prefix and
    PNeRV entries from fp32 at batch 1 and from bf16 at batch 2, unpack_cf
    (positions per tile) at the same entries from bf16 at batch 2 to bf16
    and to fp32, unpack_frames (columns per tile of one output row; at the widest also
    out_img's offset form) at the decode to fp32 and bf16 frames and on
    the width-tiled plan."""
    f32, bf = torch.float32, torch.bfloat16
    dev = torch.device("cuda")
    lib = tf._cuda.lib()
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    _, (plan, f), (wplan, wf), _ = _plans(tf)
    rows = []

    def timed(make, call, per_call_bytes):
        return hot_cold(make, lambda a: call(*a), per_call_bytes)

    pplan, nplan = _plans(tf)[0], _plans(tf)[3][0]
    for label, p, c, b, src in (("tail entry", plan, 53, 1, f32),
                                ("tail entry", plan, 53, 2, bf),
                                ("prefix entry", pplan, 64, 1, f32),
                                ("prefix entry", pplan, 64, 2, bf),
                                ("PNeRV entry", nplan, 100, 1, f32),
                                ("PNeRV entry", nplan, 100, 2, bf)):
        isz, c8 = src.itemsize, tf._r8(c)
        tc = tf._TYPE_CODES[src]
        nbytes = isz * b * c * p.h * p.w + 2 * b * c8 * p.mp

        def make(i, b=b, src=src, p=p, c=c, c8=c8):
            g = torch.Generator(device=dev).manual_seed(i)
            return (torch.randn((b, p.h, p.w, c), generator=g,
                                device=dev).to(src),
                    torch.empty((b, c8, p.mp), device=dev, dtype=bf))
        for tm in (16, 32, 64, 128, 256):
            smem = tf._pack_cf_bf16_smem(tm, c, isz)
            if smem > tf.SMEM_PER_BLOCK or p.mp % tm:
                continue
            prm, addr = tf._c_ints(b, p.h, p.w, c, c8, p.pad, p.mp, tm, tc,
                                   1, smem)
            hot, cold = timed(make, lambda x, o, a=addr: lib.nq_pack_cf(
                x.data_ptr(), o.data_ptr(), a, stream), nbytes)
            rows.append(dict(kernel="pack_cf_bf16", shape=label, batch=b,
                             src=_name(src), tile=tm, hot_ms=hot,
                             cold_ms=cold))
            print(f"  sweep pack_cf {label} {_name(src)} -> bf16 batch {b} "
                  f"tm={tm}: hot {_fmt(hot)} cold {_fmt(cold)}")
    for label, p, c in (("tail entry", plan, 53),
                        ("prefix entry", pplan, 64),
                        ("PNeRV entry", nplan, 100)):
        c8 = tf._r8(c)
        for dst in (bf, f32):
            nbytes = (2 + dst.itemsize) * 2 * c * p.h * p.w

            def make(i, p=p, c=c, c8=c8, dst=dst):
                gen = torch.Generator(device=dev).manual_seed(i)
                return (torch.randn((2, c8, p.mp), generator=gen,
                                    device=dev).to(bf),
                        torch.empty((2, p.h, p.w, c), device=dev,
                                    dtype=dst))
            for tq in (32, 56, 64, 104, 128, 200, 256):
                smem = tf._unpack_cf_bf16_smem(tq, p.w, p.pad, c)
                if smem > tf.SMEM_PER_BLOCK:
                    continue
                prm, addr = tf._c_ints(2, p.h, p.w, c, c8, p.pad, p.mp, tq,
                                       1, tf._TYPE_CODES[dst], smem)
                hot, cold = timed(make, lambda g, o, a=addr: lib.nq_unpack_cf(
                    g.data_ptr(), o.data_ptr(), a, stream), nbytes)
                rows.append(dict(kernel="unpack_cf_bf16", shape=label,
                                 batch=2, dst=_name(dst), tile=tq,
                                 hot_ms=hot, cold_ms=cold))
                print(f"  sweep unpack_cf {label} bf16 -> {_name(dst)} batch "
                      f"2 tq={tq}: hot {_fmt(hot)} cold {_fmt(cold)}")
    for label, p, ff, b in (("decode", plan, f, 1),
                            ("width-tiled plan", wplan, wf, 2)):
        g = 3 * ff
        for dst in (f32, bf):
            nbytes = (2 + dst.itemsize) * b * 3 * ff * ff * p.h * p.w

            def make(i, p=p, ff=ff, b=b, dst=dst):
                gen = torch.Generator(device=dev).manual_seed(i)
                return (torch.randn((b, 48, p.mp), generator=gen,
                                    device=dev).to(bf),
                        torch.empty((b, p.h * ff, p.w * ff, 3), device=dev,
                                    dtype=dst))
            for tx in (64, 80, 160, 240, 320):
                smem = tf._unpack_frames_bf16_smem(g, tx)
                if tx > p.w or smem > tf.SMEM_PER_BLOCK:
                    continue
                # out_img's mode: tanh, and at the widest tile the offset
                # form, whose few operations show what tanh costs
                for mode in (1, 2) if tx == 320 else (1,):
                    prm, addr = tf._c_ints(b, 48, p.mp, p.h, p.w, p.pad, ff,
                                           3, mode, tx, 1, 1,
                                           tf._TYPE_CODES[dst], 0, smem)
                    hot, cold = timed(
                        make, lambda z, o, a=addr: lib.nq_unpack_frames(
                            z.data_ptr(), o.data_ptr(), a, stream), nbytes)
                    rows.append(dict(kernel="unpack_frames_bf16",
                                     shape=label, dst=_name(dst), tile=tx,
                                     mode=mode, hot_ms=hot, cold_ms=cold))
                    print(f"  sweep unpack_frames {label} -> {_name(dst)} "
                          f"tx={tx} mode={mode}: hot {_fmt(hot)} cold "
                          f"{_fmt(cold)}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
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
    rows, splits, sweep, decodes, firsts = [], {}, [], [], {}
    for ri in order:
        tf, _ = _load(roots[ri])
        first = ri not in splits
        if args.decode:
            dec = dict(root=roots[ri], card=card, dtype=args.dtype,
                       **_decode(torch, args.dtype))
            decodes.append(dec)
            print(f"  [{ri}] decode batch 1 ({args.dtype}): "
                  f"{dec['decode_ms']:.4f} ms, card busy {dec['busy_ms']} "
                  f"ms, idle share {dec['idle_share']}")
        with torch.no_grad():
            for case in _cases(torch, tf, args.dtype):
                err = same = None
                if args.check and first:
                    key = (case["kernel"], case["shape"])
                    err, got, same = _check(torch, case, case["make"](0),
                                            firsts.get(key))
                    firsts.setdefault(key, got)
                    # the fp32 instantiations are not redesigned: their
                    # outputs stay those of the first root, bit for bit
                    assert same is not False or args.dtype != "fp32", key
                row = dict(root=roots[ri], card=card, max_abs_err=err,
                           same_as_first_root=same, **_measure(torch, case))
                rows.append(row)
                print(f"  [{ri}] {row['kernel']} {row['shape']}: "
                      f"{row['ms']:.4f} ms back to back, hot "
                      f"{_fmt(row['hot_ms'])}, cold {_fmt(row['cold_ms'])}, "
                      f"host {row['host_us']:.2f} us/call; library "
                      f"{row['library_ms']:.4f}, hot "
                      f"{_fmt(row['library_hot_ms'])}, cold "
                      f"{_fmt(row['library_cold_ms'])}, host "
                      f"{row['library_host_us']:.2f} us; bound "
                      f"{row['bound_ms']:.4f} ({row['mbytes']:.2f} MB; "
                      f"library {row['library_mbytes']:.2f} MB)"
                      + ("" if err is None else f"; checked, max_abs_err "
                         f"{err:.3e}")
                      + ("" if same is None else f"; bit for bit the first "
                         f"root's: {same}"))
                sys.stdout.flush()
            # in every pass: the host's speed drifts between passes
            split = _host_split(torch, tf, args.dtype)
            splits.setdefault(ri, []).append(split)
            for label, parts in split.items():
                print(f"  [{ri}] host split, {label}: " + ", ".join(
                    f"{k} {v:.2f} us" for k, v in parts.items()))
    if args.sweep:
        with torch.no_grad():
            sweep = _sweep(torch, _load(roots[-1])[0], args.dtype)
    for ri in range(len(roots)):
        print(f"root [{ri}] {roots[ri]}")
        for r in rows:
            if r["root"] == roots[ri]:
                print(f"  {r['kernel']} {r['shape']}: ms {r['ms']:.4f} hot "
                      f"{_fmt(r['hot_ms'])} cold {_fmt(r['cold_ms'])} "
                      f"(library {_fmt(r['library_hot_ms'])} / "
                      f"{_fmt(r['library_cold_ms'])}) bound "
                      f"{r['bound_ms']:.4f} host_us {r['host_us']:.2f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, dtype=args.dtype, rows=rows, host_split={
            roots[k]: v for k, v in splits.items()}, sweep=sweep,
            decodes=decodes), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
