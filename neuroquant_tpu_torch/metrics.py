"""Quality metrics and training losses on NHWC frames in [0, 1] (the
counterpart of ``neuroquant_tpu/metrics.py``): per-image PSNR with the
reference's 1e-9 epsilon, SSIM and MS-SSIM with pytorch_msssim's defaults,
the staged-output helpers, the l1/l2/ssim and Fusion1..12 training losses
of ``--loss``, the calibration loss and the RGB <-> YCbCr transforms."""

from __future__ import annotations

import torch

from neuroquant_tpu_torch.ops.msssim import ms_ssim, ssim


def psnr_fn_single(output, gt):
    """Per-image PSNR over a batch: -10 log10(mse + 1e-9)."""
    err = (output - gt) ** 2
    mse = err.reshape(err.shape[0], -1).mean(dim=1)
    return -10.0 * torch.log10(mse + 1e-9)


def psnr_fn_batch(output_list, gt):
    """Stacked per-image PSNR of a list of outputs, (len, batch)."""
    return torch.stack([psnr_fn_single(o, gt) for o in output_list], dim=0)


def msssim_fn_single(output, gt):
    """Per-image MS-SSIM over a batch; frames too small for the 5-level
    pyramid (a side <= 160) score 0, as in the reference."""
    if min(output.shape[1], output.shape[2]) <= 160:
        return torch.zeros(output.shape[0], dtype=torch.float32,
                           device=output.device)
    return ms_ssim(output, gt, data_range=1.0, size_average=False)


def msssim_fn_batch(output_list, gt):
    return torch.stack([msssim_fn_single(o, gt) for o in output_list], dim=0)


def psnr_fn(output_list, target_list):
    """Staged-output PSNR: per (output, target) stage one PSNR over the
    whole batch, broadcast to (batch, num_stage)."""
    cols = []
    for output, target in zip(output_list, target_list):
        mse = torch.mean((output - target) ** 2)
        psnr = -10.0 * torch.log10(mse + 1e-9)
        cols.append(psnr.reshape(1, 1).expand(output.shape[0], 1))
    return torch.cat(cols, dim=1)


def msssim_fn(output_list, target_list):
    """Staged-output MS-SSIM, one value per stage broadcast to (batch,
    num_stage); stages with a height under 160 score 0."""
    vals = []
    for output, target in zip(output_list, target_list):
        if output.shape[-3] >= 160:
            vals.append(ms_ssim(output, target, data_range=1.0,
                                size_average=True).reshape(1))
        else:
            vals.append(torch.zeros(1, dtype=torch.float32,
                                    device=output.device))
    row = torch.cat(vals, dim=0).reshape(1, -1)
    return row.expand(output_list[-1].shape[0], row.shape[1])


def psnr2(img1, img2):
    """Elementwise PSNR map clamped to [0, 50]."""
    mse = (img1 - img2) ** 2
    return torch.clamp(-10.0 * torch.log10(mse), 0.0, 50.0)


def _flat_mean(x):
    return x.reshape(x.shape[0], -1).mean(dim=1)


def loss_fn(pred, target, loss_type: str = "l2", batch_average: bool = True):
    """Training loss by name (NHWC in [0, 1]); no gradient reaches the
    target."""
    target = target.detach()
    l2 = lambda: _flat_mean((pred - target) ** 2)           # noqa: E731
    l1 = lambda: _flat_mean(torch.abs(pred - target))       # noqa: E731
    dssim = lambda: 1.0 - ssim(pred, target, data_range=1.0,  # noqa: E731
                               size_average=False)
    dmssim = lambda: 1.0 - ms_ssim(pred, target,            # noqa: E731
                                   data_range=1.0, size_average=False)

    table = {
        "l2": lambda: l2(),
        "l1": lambda: l1(),
        "ssim": lambda: dssim(),
        "Fusion1": lambda: 0.3 * l2() + 0.7 * dssim(),
        "Fusion2": lambda: 0.3 * l1() + 0.7 * dssim(),
        "Fusion3": lambda: 0.5 * l2() + 0.5 * dssim(),
        "Fusion4": lambda: 0.5 * l1() + 0.5 * dssim(),
        "Fusion5": lambda: 0.7 * l2() + 0.3 * dssim(),
        "Fusion6": lambda: 0.7 * l1() + 0.3 * dssim(),
        "Fusion7": lambda: 0.7 * l2() + 0.3 * l1(),
        "Fusion8": lambda: 0.5 * l2() + 0.5 * l1(),
        "Fusion9": lambda: 0.9 * l1() + 0.1 * dssim(),
        "Fusion10": lambda: 0.7 * l1() + 0.3 * dmssim(),
        "Fusion11": lambda: 0.9 * l1() + 0.1 * dmssim(),
        "Fusion12": lambda: 0.8 * l1() + 0.2 * dmssim(),
    }
    if loss_type not in table:
        raise KeyError(f"unknown loss type {loss_type!r}")
    loss = table[loss_type]()
    return loss.mean() if batch_average else loss


def lp_loss(pred, tgt, p: float = 2.0, reduction: str = "none"):
    """L_p calibration loss. With reduction='none' it sums over the channel
    axis and means over the rest; else the plain mean. The channel axis of
    a 4-D tensor is its last: a 4-D input must be NHWC (an NCHW tensor
    would be summed over its width, and the loss's scale against
    AdaRound's regularizer would change). Of any other rank, axis 1."""
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


def rgb_to_ycbcr(image):
    """NHWC RGB -> YCbCr (the reference's coefficients)."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) * 0.564 + 0.5
    cr = (r - y) * 0.713 + 0.5
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr_to_rgb(image):
    y, cb, cr = image[..., 0], image[..., 1] - 0.5, image[..., 2] - 0.5
    r = y + 1.403 * cr
    g = y - 0.714 * cr - 0.344 * cb
    b = y + 1.773 * cb
    return torch.stack([r, g, b], dim=-1)
