#!/usr/bin/env python3
"""Why the bf16 unpack_cf kernel is built the way it is, measured: builds
``scripts/unpack_cf_variants.cu`` (the kernel's design and its variants,
listed in that file's header) with nvcc and times each mode at the three
bf16 entries chip_smoke.py's phase 19 launches, the Bunny-3M prefix
(40x80, c = 64) and tail (160x320, c = 53) entries and PNeRV's c = 100
entry, all at batch 2, to bf16 and to fp32, over a range of tiles. Per
mode and tile: the card's own time hot and cold by the event method
(``neuroquant_tpu_torch.utils.profiling.hot_cold``) and, for the modes
that compute the function, whether the output equals ``unpack_cf_ref``
bit for bit. Needs one NVIDIA GPU and nvcc; the library lands in
``neuroquant_tpu_torch/_build/variants/``.

  python3 scripts/torch_unpack_cf_variants.py [--modes 0,2,3,4,50]
                                              [--tiles 64,128,200,256]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# the modes that compute unpack_cf (the rest time a part of it)
EXACT = (0, 1, 5, 12, 13, 14, 22, 23, 24, 30, 31, 32, 33, 34, 40)
ALL_MODES = EXACT[:3] + (2, 3, 4) + EXACT[3:] + (50,)


def _build():
    from neuroquant_tpu_torch.ops import _cuda

    out = os.path.join(_cuda.BUILD_ROOT, "variants")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libunpack_cf_variants.so")
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
                        _cuda.CSRC, os.path.join(HERE, "scripts",
                                                 "unpack_cf_variants.cu"),
                        "-o", so], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.exp_unpack.argtypes = [i, i, p, p] + [i] * 8 + [p]
    lib.exp_unpack.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(map(str, ALL_MODES)))
    ap.add_argument("--tiles", default="32,56,64,104,128,136,200,256")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_unpack_cf_variants: needs one CUDA device",
              file=sys.stderr)
        return 2
    from neuroquant_tpu_torch.ops import tail_fused as tf
    from neuroquant_tpu_torch.utils.profiling import hot_cold

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    lib = _build()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    modes = [int(m) for m in args.modes.split(",")]
    tiles = [int(t) for t in args.tiles.split(",")]
    entries = (
        ("prefix entry", tf._prefix_plan(40, 80, 5, 64, 848), 64),
        ("tail entry", tf.plan_geometry(160, 320, [(5, 53, 176, 2),
                                                   (5, 44, 148, 2)],
                                        (3, 37, 3))[0], 53),
        ("PNeRV entry", tf.plan_geometry(320, 640, [(3, 100, 400, 2)],
                                         (3, 100, 3))[0], 100))
    for label, p, c in entries:
        c8 = tf._r8(c)
        for dt in (torch.bfloat16, torch.float32):
            nbytes = (2 + dt.itemsize) * 2 * c * p.h * p.w

            def make(i, p=p, c=c, c8=c8, dt=dt):
                g = torch.Generator(device=dev).manual_seed(i)
                return (torch.randn((2, c8, p.mp), generator=g,
                                    device=dev).to(torch.bfloat16),
                        torch.empty((2, p.h, p.w, c), device=dev, dtype=dt))
            g0, o0 = make(0)
            want = tf.unpack_cf_ref(g0, p, c, dt)
            for mode in modes:
                if mode == 50 and dt is not torch.bfloat16:
                    continue        # the copy floor: same bytes in and out
                for tq in (tiles if mode != 50 else (264, 528)):
                    if (tf._unpack_cf_bf16_smem(tq, p.w, p.pad, c) + 256
                            > tf.SMEM_PER_BLOCK // 2):
                        continue

                    def run(g, o, mode=mode, tq=tq):
                        return lib.exp_unpack(
                            mode, int(dt is torch.bfloat16), g.data_ptr(),
                            o.data_ptr(), 2, p.h, p.w, c, c8, p.pad, p.mp,
                            tq, stream)
                    o0.fill_(float("nan"))
                    assert run(g0, o0) == 0, (mode, tq)
                    torch.cuda.synchronize()
                    exact = (bool(torch.equal(o0, want)) if mode in EXACT
                             else None)
                    hot, cold = hot_cold(make, lambda a, f=run: f(*a),
                                         nbytes)
                    print(f"{label} -> {str(dt)[6:]} mode {mode} tq {tq}: "
                          f"hot {hot} cold {cold} exact {exact}", flush=True)
                    assert exact is not False, (label, dt, mode, tq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
