"""Depth-to-space with ``nn.PixelShuffle`` channel semantics on NHWC tensors:
out[n, h*rh+i, w*rw+j, c] = in[n, h, w, c*rh*rw + i*rw + j]."""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r) -> torch.Tensor:
    """(N, H, W, C*rh*rw) -> (N, H*rh, W*rw, C). `r` is an int or (rh, rw)."""
    rh, rw = (r, r) if isinstance(r, int) else r
    if rh == 1 and rw == 1:
        return x
    n, h, w, crr = x.shape
    c = crr // (rh * rw)
    assert c * rh * rw == crr, (crr, rh, rw)
    x = x.reshape(n, h, w, c, rh, rw).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * rh, w * rw, c)

