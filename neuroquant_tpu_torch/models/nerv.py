"""NeRV: frame index -> position encoding -> conv/pixel-shuffle decoder (the
counterpart of ``neuroquant_tpu/models/nerv.py``; NHWC). The decoder is the
one HNeRV shares (``models/decoder.py``); its layer 0 is decoder[0]'s 1x1
conv and a (fc_h, fc_w) block-to-space shuffle, (2, 4) at Bunny, which the
JAX package runs as one transposed conv (an XLA layout choice)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from neuroquant_tpu_torch.models.decoder import DecoderShape, NeRVDecoder
from neuroquant_tpu_torch.models.layers import PositionEncoding


@dataclasses.dataclass(frozen=True)
class NeRVConfig(DecoderShape):
    crop_h: int
    crop_w: int
    base: float
    level: int
    dec_in_channel: int
    dec_kernels: Tuple[int, ...]
    dec_strides: Tuple[int, ...]
    channel_reduce: float
    channel_lbound: int
    dec_norm: str
    dec_acts: str
    out_bias: str
    n_frames: int = 0           # > 0: the encoding's exact table (layers.py)
    packed_tail: str = "auto"   # 'auto' | 'off' | explicit block index
    fused_tail: str = "auto"    # 'off' decodes unpacked; else the kernels
    fused_prefix: str = "auto"  # 'off' keeps the last prefix block a conv

    @classmethod
    def from_cfg(cls, cfg: dict) -> "NeRVConfig":
        return cls(
            crop_h=cfg["crop_h"], crop_w=cfg["crop_w"],
            base=float(cfg["base"]), level=int(cfg["level"]),
            dec_in_channel=int(cfg["dec_in_channel"]),
            dec_kernels=tuple(cfg["dec_kernels"]),
            dec_strides=tuple(cfg["dec_strides"]),
            channel_reduce=float(cfg["channel_reduce"]),
            channel_lbound=int(cfg["channel_lbound"]),
            dec_norm=cfg["dec_norm"], dec_acts=cfg["dec_acts"],
            out_bias=str(cfg["out_bias"]),
            n_frames=int(cfg.get("n_frames", 0)),
            packed_tail=str(cfg.get("packed_tail", "auto")),
            fused_tail=str(cfg.get("fused_tail", "auto")),
            fused_prefix=str(cfg.get("fused_prefix", "auto")),
        )

    @property
    def fc_h(self) -> int:
        return self.crop_h // int(np.prod(self.dec_strides))

    @property
    def fc_w(self) -> int:
        return self.crop_w // int(np.prod(self.dec_strides))


class NeRV(NeRVDecoder):
    """Normalized frame indices (B,) -> NHWC frames. The encoder has no
    parameters; decoder[0] takes its 2*level channels."""

    def __init__(self, cfg: NeRVConfig):
        super().__init__(cfg, PositionEncoding(cfg.base, cfg.level,
                                               cfg.n_frames), 2 * cfg.level)

    def model_input(self, frames, norm_idx):
        """NeRV takes the frames' normalized indices."""
        return norm_idx

    def encode(self, norm_idx):
        """(B,) normalized frame indices -> (B, 1, 1, 2*level), in the
        decoder's dtype."""
        return self.encoder(norm_idx).to(self.decoder[0].weight.dtype)
