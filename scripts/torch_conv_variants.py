#!/usr/bin/env python3
"""Why the fp32 dW kernel multiplies the way it does, measured: builds
``neuroquant_tpu_torch/csrc`` once as the library builds it and once per
variant macro of ``csrc/nq_mma.cuh`` (NQ_SPLIT_RNA, NQ_ACC_IN_TC,
NQ_ONE_TF32), and at every dW shape of ``torch_conv_bench.py`` prints
each build's time and its largest error as a share of CONV_TOL (over 1:
the variant fails the tolerance). Needs one NVIDIA GPU and nvcc. The
fp32 conv (forward and dx) no longer multiplies through nq_mma.cuh: it
runs 3xTF32 on wgmma (csrc/tail_conv_cf.cu), and these macros do not
touch it.

  python3 scripts/torch_conv_variants.py [--iters N]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

VARIANTS = [(), ("-DNQ_SPLIT_RNA",), ("-DNQ_ACC_IN_TC",), ("-DNQ_ONE_TF32",),
            ()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch

    import torch_conv_bench as bench
    from neuroquant_tpu_torch.ops import _cuda
    from neuroquant_tpu_torch.ops import tail_fused as tf

    if not torch.cuda.is_available():
        print("torch_conv_variants: needs one CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    base = _cuda.NVCC_FLAGS
    for flags in VARIANTS:
        _cuda.NVCC_FLAGS = base + flags
        _cuda.lib.cache_clear()
        _cuda.lib()
        label = " ".join(flags) or "library build"
        cases, _ = bench._cases(torch, tf, True)
        for name, _, run, ref in cases:
            if " dW " not in name:
                continue
            with torch.no_grad():
                got, want = run(), ref()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                share = max(
                    float((a - b).abs().max())
                    / (bench.CONV_TOL * max(1.0, float(b.abs().max())))
                    for a, b in zip(got, want))
                ms = bench._time_ms(torch, run, args.iters)
            print(f"[{label}] {name}: {ms:.4f} ms, error {share:.3f} of "
                  f"tolerance", flush=True)
    _cuda.NVCC_FLAGS = base
    return 0


if __name__ == "__main__":
    sys.exit(main())
