"""Plain reference of NeRV (Chen et al., NeurIPS 2021): a frame's index t
of N, normalised to t / N, embedded as [sin, cos](pos * base^l * pi) for
l < level (the bases in float32, then positions, products, sin and cos in
float64, cast to float32: NeuroQuant's table over the frame grid), then
the decoder of ``common.py``, decoder[0]'s output spread over the
(crop_h / prod(strides), crop_w / prod(strides)) grid. fp32."""

from __future__ import annotations

import math

import torch

from nqbench.reference import common


def fc(cfg):
    s = 1
    for x in cfg["dec_strides"]:
        s *= int(x)
    return int(cfg["crop_h"]) // s, int(cfg["crop_w"]) // s


def encode(sd, cfg, index, n_frames: int, tf32=False):
    """(B,) integer frame indices -> (B, 1, 1, 2 * level)."""
    level = int(cfg["level"])
    bases = ((float(cfg["base"]) ** torch.arange(level, dtype=torch.float32))
             * math.pi).double().to(index.device)
    pos = index.to(torch.float64)[:, None] / n_frames
    v = pos * bases
    pe = torch.cat([torch.sin(v), torch.cos(v)], -1).float()
    return pe.reshape(-1, 1, 1, 2 * level)


def decode(sd, cfg, embed, tf32=False):
    return common.decode(sd, cfg, embed, fc(cfg), tf32)


def embed(sd, cfg, frames, index, n_frames: int, tf32=False):
    """The embedding of a batch of the clip: its indices, encoded."""
    return encode(sd, cfg, index, n_frames, tf32)
