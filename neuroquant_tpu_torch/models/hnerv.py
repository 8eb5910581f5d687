"""HNeRV: ConvNeXt content encoder -> tiny embedding -> conv/pixel-shuffle
decoder (the counterpart of ``neuroquant_tpu/models/hnerv.py``; NHWC). The
decoder is the one NeRV shares (``models/decoder.py``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from neuroquant_tpu_torch.models.decoder import DecoderShape, NeRVDecoder
from neuroquant_tpu_torch.models.layers import Conv2d, ConvNeXt


@dataclasses.dataclass(frozen=True)
class HNeRVConfig(DecoderShape):
    crop_h: int
    crop_w: int
    stage_block: int
    enc_strides: Tuple[int, ...]
    enc_channel: Tuple[int, ...]
    dec_in_channel: int
    dec_kernels: Tuple[int, ...]
    dec_strides: Tuple[int, ...]
    channel_reduce: float
    channel_lbound: int
    dec_norm: str
    dec_acts: str
    out_bias: str
    packed_tail: str = "auto"   # 'auto' | 'off' | explicit block index
    fused_tail: str = "auto"    # 'off' decodes unpacked; else the kernels
    fused_prefix: str = "auto"  # 'off' keeps the last prefix block a conv

    @classmethod
    def from_cfg(cls, cfg: dict) -> "HNeRVConfig":
        assert list(cfg["enc_strides"]) == list(cfg["dec_strides"]), \
            "HNeRV requires enc_strides == dec_strides"
        return cls(
            crop_h=cfg["crop_h"], crop_w=cfg["crop_w"],
            stage_block=int(cfg["stage_block"]),
            enc_strides=tuple(cfg["enc_strides"]),
            enc_channel=tuple(cfg["enc_channel"]),
            dec_in_channel=int(cfg["dec_in_channel"]),
            dec_kernels=tuple(cfg["dec_kernels"]),
            dec_strides=tuple(cfg["dec_strides"]),
            channel_reduce=float(cfg["channel_reduce"]),
            channel_lbound=int(cfg["channel_lbound"]),
            dec_norm=cfg["dec_norm"], dec_acts=cfg["dec_acts"],
            out_bias=str(cfg["out_bias"]),
            packed_tail=str(cfg.get("packed_tail", "auto")),
            fused_tail=str(cfg.get("fused_tail", "auto")),
            fused_prefix=str(cfg.get("fused_prefix", "auto")),
        )

    @property
    def fc_h(self) -> int:
        return int(np.prod(self.enc_strides)) // int(np.prod(self.dec_strides))

    fc_w = fc_h

    @property
    def embed_hw(self) -> Tuple[int, int]:
        s = int(np.prod(self.enc_strides))
        return self.crop_h // s, self.crop_w // s


class HNeRV(NeRVDecoder):
    def __init__(self, cfg: HNeRVConfig):
        super().__init__(cfg, ConvNeXt(cfg.stage_block, cfg.enc_strides,
                                       cfg.enc_channel), cfg.enc_channel[-1])

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's init: the decoder's (``NeRVDecoder``), then
        truncated N(0, 0.02) and zero biases in the encoder (LayerNorms
        stay at ones/zeros, gamma at 1e-6)."""
        super().reset_parameters(generator)
        for m in self.encoder.modules():
            if isinstance(m, (Conv2d, nn.Linear)):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-2.0, b=2.0,
                                      generator=generator)
                nn.init.zeros_(m.bias)
