"""SSIM / MS-SSIM on NHWC tensors, the algorithm of ``pytorch_msssim`` as
``neuroquant_tpu/ops/msssim.py`` implements it: 11-tap Gaussian window
(sigma 1.5), K=(0.01, 0.03), valid separable filtering, 5 levels with
weights [0.0448, 0.2856, 0.3001, 0.2363, 0.1333], and 2x2 average pooling
with zero padding on odd sides.

The Gaussian filter is a sum of shifted slices in fp32 rather than a
convolution: the variance terms are E[x^2] - E[x]^2, which cancel badly
under the TF32 arithmetic cuDNN may pick for fp32 convolutions on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gauss_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter(x, win):
    """Separable valid-padding Gaussian blur of NHWC x, per channel."""
    k = len(win)
    h, w = x.shape[1] - k + 1, x.shape[2] - k + 1
    y = sum(float(win[i]) * x[:, i:i + h] for i in range(k))
    return sum(float(win[i]) * y[:, :, i:i + w] for i in range(k))


def _avg_pool2(x):
    """F.avg_pool2d(x, 2, padding=[h%2, w%2]) with count_include_pad, NHWC."""
    ph, pw = x.shape[1] % 2, x.shape[2] % 2
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, padding=[ph, pw],
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def _ssim_maps(x, y, data_range, win, k=(0.01, 0.03)):
    c1 = (k[0] * data_range) ** 2
    c2 = (k[1] * data_range) ** 2
    mu1 = _gaussian_filter(x, win)
    mu2 = _gaussian_filter(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _gaussian_filter(x * x, win) - mu1_sq
    sigma2_sq = _gaussian_filter(y * y, win) - mu2_sq
    sigma12 = _gaussian_filter(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2)), cs_map.mean(dim=(1, 2))


def ssim(x, y, data_range: float = 1.0, size_average: bool = True,
         win_size: int = 11, win_sigma: float = 1.5, k=(0.01, 0.03)):
    """Single-scale SSIM. x, y: NHWC in [0, data_range]."""
    ssim_pc, _ = _ssim_maps(x, y, data_range,
                            _gauss_window(win_size, win_sigma), k)
    per_image = ssim_pc.mean(dim=-1)
    return per_image.mean() if size_average else per_image


def ms_ssim(x, y, data_range: float = 1.0, size_average: bool = True,
            win_size: int = 11, win_sigma: float = 1.5,
            weights=_MS_WEIGHTS, k=(0.01, 0.03)):
    """Multi-scale SSIM. Smallest side must exceed (win_size-1) * 2**4."""
    assert x.shape == y.shape, (x.shape, y.shape)
    levels = len(weights)
    assert min(x.shape[1], x.shape[2]) > (win_size - 1) * 2 ** (levels - 1), (
        f"image too small for {levels}-level ms-ssim: {tuple(x.shape)}")
    win = _gauss_window(win_size, win_sigma)
    mcs = []
    for i in range(levels):
        ssim_pc, cs_pc = _ssim_maps(x, y, data_range, win, k)
        if i < levels - 1:
            mcs.append(torch.relu(cs_pc))
            x, y = _avg_pool2(x), _avg_pool2(y)
    stack = torch.stack(mcs + [torch.relu(ssim_pc)], dim=0)   # (levels, N, C)
    w = torch.tensor(weights, dtype=stack.dtype, device=stack.device)
    per_image = torch.prod(stack ** w[:, None, None], dim=0).mean(dim=-1)
    return per_image.mean() if size_average else per_image
