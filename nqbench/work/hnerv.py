"""HNeRV's shapes: the ConvNeXt encoder (a downsampling conv a stage, then
per block a 7x7 depthwise conv and two linears, 4x wide) and the decoder's
entry, the embedding grid crop / prod(strides) with enc_channel[-1]
channels and no block-to-space."""

from __future__ import annotations

import functools
import sys

from nqbench import work


def encoder_convs(cfg) -> list:
    h, w, c = int(cfg["crop_h"]), int(cfg["crop_w"]), 3
    out = []
    for i, (s, d) in enumerate(zip(cfg["enc_strides"], cfg["enc_channel"])):
        s, d = int(s), int(d)
        out.append(work.conv(h, w, s, c, d, stride=s, name=f"down.{i}"))
        h, w, c = h // s, w // s, d
        for j in range(int(cfg["stage_block"])):
            out += [work.conv(h, w, 7, d, d, groups=d, name=f"dw.{i}.{j}"),
                    work.conv(h, w, 1, d, 4 * d, name=f"pw1.{i}.{j}"),
                    work.conv(h, w, 1, 4 * d, d, name=f"pw2.{i}.{j}")]
    return out


def decoder_entry(cfg):
    s = 1
    for x in cfg["enc_strides"]:
        s *= int(x)
    return (int(cfg["crop_h"]) // s, int(cfg["crop_w"]) // s,
            int(cfg["enc_channel"][-1]), (1, 1))


_self = sys.modules[__name__]
decode_flops = functools.partial(work.decode_flops, _self)
step_flops = functools.partial(work.step_flops, _self)
tail_least_s = functools.partial(work.tail_least_s, _self)
