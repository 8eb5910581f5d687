"""Per-image quality metrics on NHWC frames in [0, 1] and the calibration
loss (the evaluation and calibration part of ``neuroquant_tpu/metrics.py``)."""

from __future__ import annotations

import torch

from neuroquant_tpu_torch.ops.msssim import ms_ssim


def psnr_fn_single(output, gt):
    """Per-image PSNR over a batch: -10 log10(mse + 1e-9)."""
    err = (output - gt) ** 2
    mse = err.reshape(err.shape[0], -1).mean(dim=1)
    return -10.0 * torch.log10(mse + 1e-9)


def msssim_fn_single(output, gt):
    """Per-image MS-SSIM over a batch; frames too small for the 5-level
    pyramid (a side <= 160) score 0, as in the reference."""
    if min(output.shape[1], output.shape[2]) <= 160:
        return torch.zeros(output.shape[0], dtype=torch.float32,
                           device=output.device)
    return ms_ssim(output, gt, data_range=1.0, size_average=False)


def lp_loss(pred, tgt, p: float = 2.0, reduction: str = "none"):
    """L_p calibration loss. With reduction='none' it sums over the channel
    axis (the last of an NHWC image, axis 1 otherwise) and means over the
    rest; else the plain mean."""
    diff = pred - tgt
    if p == 2.0:
        d = diff * diff
    elif p == 1.0:
        d = torch.abs(diff)
    else:
        d = torch.abs(diff) ** p
    if reduction == "none":
        if d.dim() == 4:
            return d.sum(dim=-1).mean()
        return d.sum(dim=1).mean()
    return d.mean()
