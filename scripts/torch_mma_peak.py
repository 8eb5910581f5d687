#!/usr/bin/env python3
"""The card's peak rate for mma.sync.m16n8k8 TF32, the instruction the two
conv kernels multiply with: builds scripts/mma_peak.cu with nvcc (sm_90a)
into a temporary directory, launches warps that do nothing but independent
products from registers, and prints TFLOP/s of TF32 products and what that
leaves for an fp32-accurate product made of three of them. Needs one
NVIDIA GPU and nvcc.

  python3 scripts/torch_mma_peak.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mma_peak: needs one CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(HERE))
    from neuroquant_tpu_torch.ops import _cuda

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libmma_peak.so")
        subprocess.run([_cuda._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", so,
                        os.path.join(HERE, "mma_peak.cu")], check=True)
        lib = ctypes.CDLL(so)
        lib.nq_mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
        lib.nq_mma_peak.restype = ctypes.c_float
        iters = 20000
        for per_sm in (1, 2, 4):
            for chains in (8, 16):
                blocks = sms * per_sm
                out = torch.empty(blocks * 256, device="cuda")
                ms = lib.nq_mma_peak(out.data_ptr(), blocks, iters, chains)
                assert ms > 0, "launch failed"
                flops = 2.0 * 16 * 8 * 8 * chains * iters * 8 * blocks
                tf = flops / ms / 1e9
                print(f"{per_sm} block(s) of 8 warps per SM, {chains} "
                      f"independent products in flight per warp: {ms:.3f} "
                      f"ms, {tf:.1f} TFLOP/s TF32, {tf / 3:.1f} TFLOP/s as "
                      f"3xTF32")
    return 0


if __name__ == "__main__":
    sys.exit(main())
