#!/usr/bin/env python3
"""Times of the grouped fake-quant kernels (csrc/fq_hadamard.cu) at the
seven HNeRV Bunny-3M weight layers, as a calibration calls them, on one
NVIDIA GPU:

  python3 scripts/torch_fq_bench.py [--root DIR] [--out FILE]

Seeded random weights at the layers' shapes, max scales in the Hadamard
domain, 5 bits, and alphas made as ``adaround_upgrade`` makes them (in the
transform's domain, C_in the fastest axis). Four passes: the forward, one
launch for the seven layers, UAQ and soft AdaRound; the backward, one
launch, UAQ wanting ddelta (phase 1) and soft AdaRound wanting dalpha
(phase 2). Per pass: the card's own time (torch.profiler, the kernel
alone), back-to-back ms of the wrapper call (CUDA events), the bound
(bytes over 3.35 TB/s: each input read once, each output written once)
and the share of it reached; every result is checked first (the forward
bit for bit against the plain chain, dalpha against the closed form).
The card is kept busy for ~2 s first: a card's time for these ~0.03 ms
kernels drifts within a process, later passes reading faster. --root
names an older checkout (unpacked with ``git archive``) whose fake-quant
kernel launches once per layer (``fused_fake_quant_hwio``): its forward
is timed the same way, before and after this tree's, and the backward
that its autograd
Functions took, the plain chain recomputed and differentiated by autograd,
beside this tree's backward kernel. Prints the card's name and power limit
first and writes the rows as JSON to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BUNNY = [(1, 1, 16, 92), (1, 1, 92, 1925), (3, 3, 77, 1024),
         (5, 5, 64, 848), (5, 5, 53, 176), (5, 5, 44, 148), (3, 3, 37, 3)]
BITS = 5


def _device_ms(torch, fn, name="", n=20, tries=3):
    """The card's time per call of the kernels whose name holds `name`
    (every kernel it launches by default)."""
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
                 if getattr(e, "device_type", None) == DeviceType.CUDA
                 and name in e.key)
        if us > 0:
            return us / 1e3 / n
    return None


def _time_ms(torch, fn, iters=50):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _warm(torch, seconds=2.0):
    """Keep the card busy for a while, so that the first timed pass does
    not meet it idle."""
    import time

    x = torch.randn((4096, 4096), device="cuda")
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(10):
            x = torch.tanh(x @ x * 1e-3)
        torch.cuda.synchronize()


def _layers(torch, ff, Q, fwht, pad):
    gen = torch.Generator(device="cuda").manual_seed(0)
    uaq, ada, cots = [], [], []
    for kh, kw, cin, cout in BUNNY:
        w = (torch.randn((cout, cin, kh, kw), generator=gen, device="cuda")
             * 0.05).permute(2, 3, 1, 0)
        dom = fwht(pad(w), axis=2)
        d, z = Q.init_weight_scale(dom, BITS, True, "max")
        a = Q.adaround_init_alpha(dom, d)
        uaq.append((w, d, z, None, BITS, True))
        ada.append((w, d, z, a, BITS, True))
        cots.append(torch.randn(w.shape, generator=gen, device="cuda"))
    return uaq, ada, cots


def _passes(torch, ff, uaq, ada, cots):
    """(label, kernel name, call, bytes, check) of the four passes."""
    n_w = sum(lay[0].numel() for lay in uaq)
    n_a = sum(lay[3].numel() for lay in ada)
    n_s = 4 * sum(lay[0].shape[3] for lay in uaq)

    def fwd(layers):
        def run():
            with torch.no_grad():
                return ff.fake_quant_group(layers, True)
        return run

    def bwd(layers, need):
        return lambda: ff._backward(layers, True, cots, [need] * len(layers))

    def check_fwd(layers, outs):
        for (w, d, z, a, b, s), out in zip(layers, outs):
            assert torch.equal(out, ff.fake_quant_ref(w, d, z, a, b, True, s))

    def check_bwd(layers, need, grads):
        i = need.index(True)
        for (w, d, z, a, b, s), g, c in zip(layers, grads, cots):
            want = ff.fake_quant_vjp_ref(c, w, d, z, a, b, True, s, need)[i]
            got = g[i]
            if i == 3:
                assert torch.equal(got, want)
            else:
                mag = ff.fake_quant_vjp_ref(
                    c, w, d, z, a, b, True, s, need,
                    sum_like=lambda t, like: ff._sum_like(t.abs(), like))[i]
                assert bool(((got - want).abs() <= 1e-5 * mag).all())

    phase1, phase2 = (False, True, False, False), (False, False, False, True)
    return [
        ("forward uaq", "fq_kernel", fwd(uaq), 4 * (2 * n_w + n_s),
         lambda o: check_fwd(uaq, o)),
        ("forward adaround soft", "fq_kernel", fwd(ada),
         4 * (2 * n_w + n_s + n_a), lambda o: check_fwd(ada, o)),
        ("backward uaq, ddelta", "fq_kernel", bwd(uaq, phase1),
         4 * (2 * n_w + n_s), lambda o: check_bwd(uaq, phase1, o)),
        ("backward adaround soft, dalpha", "fq_kernel", bwd(ada, phase2),
         4 * (2 * n_w + n_s + 2 * n_a), lambda o: check_bwd(ada, phase2, o))]


def _load(root):
    """The root's fused_fakequant module, apart from any copy imported
    before, with its kernels built."""
    import importlib

    for name in [m for m in sys.modules
                 if m.startswith("neuroquant_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        ff = importlib.import_module("neuroquant_tpu_torch.ops.fused_fakequant")
        importlib.import_module("neuroquant_tpu_torch.ops._cuda").lib()
    finally:
        sys.path.remove(root)
    return ff


def _older(torch, root, uaq, ada, cots, card):
    """The older checkout's per-layer forward and its Functions' backward
    (the plain chain recomputed under autograd), with this tree's inputs."""
    ff = _load(root)
    n_w = sum(lay[0].numel() for lay in uaq)
    n_a = sum(lay[3].numel() for lay in ada)
    n_s = 4 * sum(lay[0].shape[3] for lay in uaq)
    rows = []

    def fwd(layers):
        def run():
            with torch.no_grad():
                return [ff.fused_fake_quant_hwio(w, d, z, b, True, a, s)
                        for w, d, z, a, b, s in layers]
        return run

    def recompute(layers, leaf):
        def run():
            out = []
            for (w, d, z, a, b, s), c in zip(layers, cots):
                t = (d if leaf == "delta" else a).detach().requires_grad_()
                y = ff.fake_quant_ref(w, t if leaf == "delta" else d, z,
                                      t if leaf == "alpha" else a, b, True, s)
                out.append(torch.autograd.grad(y, t, c))
            return out
        return run

    for label, run, nbytes in (
            ("forward uaq, one launch a layer", fwd(uaq), 4 * (2 * n_w + n_s)),
            ("forward adaround soft, one launch a layer", fwd(ada),
             4 * (2 * n_w + n_s + n_a)),
            ("backward uaq, ddelta: the plain chain recomputed",
             recompute(uaq, "delta"), 4 * (2 * n_w + n_s)),
            ("backward adaround soft, dalpha: the plain chain recomputed",
             recompute(ada, "alpha"), 4 * (2 * n_w + n_s + 2 * n_a))):
        run()
        torch.cuda.synchronize()
        dev = _device_ms(torch, run)
        bound = nbytes / 3.35e12 * 1e3
        rows.append(dict(card=card, root=root, kernel=label, device_ms=dev,
                         ms=_time_ms(torch, run, 20), bound_ms=bound,
                         mbytes=nbytes / 1e6))
        print(f"  [{root}] {label}: device {dev} ms; "
              f"{rows[-1]['ms']:.4f} ms back to back; bound {bound:.4f}",
              flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=os.path.join(HERE, "results",
                                                  "fq_bench.json"))
    args = ap.parse_args()
    import torch

    from neuroquant_tpu_torch.ops import fused_fakequant as ff
    from neuroquant_tpu_torch.ops import quant as Q
    from neuroquant_tpu_torch.ops.hadamard import fwht, pad_cin_to_pow2

    if not torch.cuda.is_available():
        print("torch_fq_bench: needs one CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    uaq, ada, cots = _layers(torch, ff, Q, fwht, pad_cin_to_pow2)
    _warm(torch)
    rows = []
    if args.root:
        rows += _older(torch, os.path.abspath(args.root), uaq, ada, cots,
                       card)
        ff = _load(HERE)
    for label, kname, run, nbytes, check in _passes(torch, ff, uaq, ada,
                                                     cots):
        check(run())
        torch.cuda.synchronize()
        dev = _device_ms(torch, run, kname)
        bound = nbytes / 3.35e12 * 1e3
        row = dict(card=card, root=HERE, kernel=label, device_ms=dev,
                   ms=_time_ms(torch, run), bound_ms=bound,
                   mbytes=nbytes / 1e6,
                   share=None if not dev else bound / dev)
        rows.append(row)
        print(f"  {label}: device {dev} ms ("
              f"{'-' if not dev else f'{100 * bound / dev:.0f}%'} of the "
              f"bound {bound:.4f}, {nbytes / 1e6:.1f} MB); "
              f"{row['ms']:.4f} ms back to back", flush=True)
    if args.root:
        rows += _older(torch, os.path.abspath(args.root), uaq, ada, cots,
                       card)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
