"""NeRV's shapes: no learned encoder (the position encoding has no
weights); decoder[0] takes the 2 * level encoding of one position and
spreads its output over the (crop / prod(strides)) grid."""

from __future__ import annotations

import functools
import sys

from nqbench import work


def encoder_convs(cfg) -> list:
    return []


def decoder_entry(cfg):
    s = 1
    for x in cfg["dec_strides"]:
        s *= int(x)
    return (1, 1, 2 * int(cfg["level"]),
            (int(cfg["crop_h"]) // s, int(cfg["crop_w"]) // s))


_self = sys.modules[__name__]
decode_flops = functools.partial(work.decode_flops, _self)
step_flops = functools.partial(work.step_flops, _self)
tail_least_s = functools.partial(work.tail_least_s, _self)
