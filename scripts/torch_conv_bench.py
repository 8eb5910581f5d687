#!/usr/bin/env python3
"""Times of the port's two conv kernels (tail_conv_cf, tail_conv_dw_cf) at
every shape the HNeRV Bunny-3M main path launches, on one NVIDIA GPU.

  python3 scripts/torch_conv_bench.py [--root DIR]... [--check] [--out FILE]

Each --root is a checkout of this repository (default: the one this script
lies in); with several, their kernels are timed in turns inside the one
process (first, second, ..., second, first), so two commits are compared on
one card: unpack the other commit with ``git archive`` into a directory
and name both. --check also holds every launch against the plain version
(CONV_TOL of chip_smoke.py). Prints one line per shape and root, the card's
name and power limit first, and writes the rows as JSON to --out.

Decode shapes are batch 1 (emit y or z), calibration shapes batch 2:
forward as the step launches it, the dx pass with its GELU' epilogue, the
dW pass. A root whose ``conv_cf`` knows no emit='zy' (before the pair was
added) is timed with the step it ran then: emit z, act_in on the input.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

CONV_TOL = 1e-4
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


def _cases(torch, tf, check):
    """(name, useful GFLOP, run, check or None) per main-path launch."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pplan = tf._prefix_plan(40, 80, 5, 64, 848)
    plan, _ = tf.plan_geometry(160, 320, [(5, 53, 176, 2), (5, 44, 148, 2)],
                               (3, 37, 3))
    has_zy = "zy" in getattr(tf, "_EMITS", ())
    layers = [("prefix", pplan, pplan.layers[0], 64, 848, "z"),
              ("L0", plan, plan.layers[0], 53, 176, "y"),
              ("L1", plan, plan.layers[1], None, None, "y"),
              ("head", plan, plan.layers[2], None, None, "z")]
    out = []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def close(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst = 0.0
        for a, b in zip(got, want):
            err = float((a - b).abs().max())
            tol = CONV_TOL * max(1.0, float(b.abs().max()))
            assert err <= tol, (err, tol)
            worst = max(worst, err / tol)
        return worst

    def add_layer(name, p, layer, cin, cout, demit):
        mask = tf.border_mask(p, device=dev)
        kk = rand(layer.side, layer.side, layer.cin, layer.cout) * 0.05
        bias = rand(layer.cout, 1) * 0.1
        w_op = tf.conv_w_operand(kk, p, layer)
        lt = layer.transposed()
        kt = tf._kk_transpose(kk).contiguous()
        wt_op = tf.conv_w_operand(kt, p, lt)
        blocks = tf._k_blocks(p, layer)
        for batch in (1, 2):
            x = (rand(batch, layer.cin, p.mp) * mask).contiguous()
            gfl = tf.conv_cf_flops(p, layer, batch, cin, cout) / 1e9
            if batch == 1:
                out.append((
                    f"decode {name} emit={demit}", gfl,
                    lambda x=x, e=demit: tf.conv_cf(x, kk, bias, p, layer, e,
                                                    False, w_op),
                    lambda x=x, e=demit: tf.conv_cf_ref(x, kk, bias, p, layer,
                                                        e, False, blocks)))
                continue
            g = (rand(batch, layer.cout, p.mp) * mask).contiguous()
            nxt = name in ("L0", "L1")      # followed by a GELU
            act = layer.gelu_in
            if has_zy:
                emit, a = ("zy" if nxt else "z"), False
            else:
                emit, a = "z", act
            out.append((
                f"step forward {name} emit={emit} act_in={a}", gfl,
                lambda x=x, e=emit, a=a: tf.conv_cf(x, kk, bias, p, layer, e,
                                                    a, w_op),
                lambda x=x, e=emit, a=a: tf.conv_cf_ref(x, kk, bias, p, layer,
                                                        e, a, blocks)))
            om = x if act else None
            out.append((
                f"step dx {name} out_mul={act}", gfl,
                lambda g=g, om=om: tf.conv_cf(g, kt, None, p, lt, w_op=wt_op,
                                              out_mul=om),
                lambda g=g, om=om: tf.conv_cf_ref(
                    g, kt, None, p, lt, blocks=tf._k_blocks(p, lt),
                    out_mul=om)))
            out.append((
                f"step dW {name} act_in={a}", gfl,
                lambda x=x, g=g, a=a: tf.conv_cf_dw(x, g, p, layer, a),
                lambda x=x, g=g, a=a: tf.conv_cf_dw_ref(x, g, p, layer, a,
                                                        blocks)))
    for spec in layers:
        add_layer(*spec)
    if not check:
        out = [(n, f, run, None) for n, f, run, _ in out]
    return out, close


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
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
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    rows = []
    order = list(range(len(roots)))
    order = order + order[::-1]
    per_root = {}
    for ri in order:
        tf = _load(roots[ri])
        cases, close = _cases(torch, tf, args.check and ri not in per_root)
        times = per_root.setdefault(ri, {})
        for name, gfl, run, ref in cases:
            worst = None
            with torch.no_grad():
                if ref is not None:
                    worst = close(run(), ref())
                ms = _time_ms(torch, run, args.iters)
            times.setdefault(name, []).append(ms)
            print(f"  [{ri}] {name}: {ms:.4f} ms, {gfl / ms:.2f} TFLOP/s "
                  f"useful" + ("" if worst is None else
                               f", error {worst:.3f} of tolerance"))
            sys.stdout.flush()
            rows.append(dict(root=roots[ri], shape=name, ms=ms,
                             useful_gflop=gfl, card=card))
    for ri, times in per_root.items():
        print(f"root [{ri}] {roots[ri]}")
        for name, ms in times.items():
            print(f"  {name}: " + " ".join(f"{m:.4f}" for m in ms))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
