"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. A missing
GPU is an error, never a silent fall back to the CPU: a decode timed on the
CPU would be reported as if it were the card's.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises when there
    is none); ``"cpu"`` -> the CPU; a ``torch.device`` passes through after
    the same check.

    On a CUDA device it also turns TF32 off for cuDNN and matmuls: the port
    computes in fp32, as the JAX package on the CPU and the tests that hold
    the two together do, and PyTorch's default lets cuDNN's fp32
    convolutions (the encoder, decoder[0], the unfused prefix blocks) round
    their operands to TF32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def synchronize(device) -> None:
    """Wait for `device`'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
