"""Useful work of a configuration, from its shapes alone: the FLOPs and the
bytes each conv (and linear, as a 1x1 conv) of the algorithm needs, each
input read once and each output written once. A packed layer's extra
executed MACs are not the algorithm's work and are not counted.

``work/<arch>.py`` gives ``encoder_convs(cfg)`` (what the encoder computes
that has weights) and ``decoder_entry(cfg)`` (decoder[0]'s input grid and
channels, and its block-to-space factor); the rest is shared."""

from __future__ import annotations

from nqbench import core

BYTES = 4       # fp32


def module(cell):
    return core.module("work", cell.arch)


def conv(hi, wi, k, cin, cout, stride=1, groups=1, name=""):
    """A conv's shapes: input grid (hi, wi), output grid at `stride`."""
    return {"name": name, "hi": hi, "wi": wi, "h": hi // stride,
            "w": wi // stride, "k": k, "cin": cin, "cout": cout,
            "groups": groups}


def flops(c, batch: int) -> float:
    return (2.0 * batch * c["h"] * c["w"] * c["k"] ** 2
            * (c["cin"] // c["groups"]) * c["cout"])


def nbytes(c, batch: int) -> float:
    """One pass's bytes: forward, input gradient and weight gradient each
    read two of (input, weight, output) and write the third."""
    x = batch * c["hi"] * c["wi"] * c["cin"]
    y = batch * c["h"] * c["w"] * c["cout"]
    wt = c["k"] ** 2 * (c["cin"] // c["groups"]) * c["cout"]
    return float(BYTES * (x + y + wt))


def least_s(c, batch: int, dtype="float32") -> float:
    """One pass's least time on the card: the larger of its FLOPs over the
    peak and its bytes over the memory's rate."""
    return max(flops(c, batch) / core.PEAK_FLOPS[dtype],
               nbytes(c, batch) / core.PEAK_BYTES_S)


def decoder_channels(cfg) -> list:
    chans, c = [], int(cfg["dec_in_channel"])
    for _ in cfg["dec_strides"]:
        c = int(max(round(c / float(cfg["channel_reduce"])),
                    int(cfg["channel_lbound"])))
        chans.append(c)
    return chans


def decoder_convs(cfg, entry) -> list:
    """decoder[0], one conv a NeRVBlock (before its PixelShuffle), the
    head; `entry` = (h, w, cin, (fc_h, fc_w))."""
    h, w, cin, (fh, fw) = entry
    d0 = int(cfg["dec_in_channel"])
    out = [conv(h, w, 1, cin, d0 * fh * fw, name="decoder.0")]
    h, w, c = h * fh, w * fw, d0
    for i, (k, s, co) in enumerate(zip(cfg["dec_kernels"], cfg["dec_strides"],
                                       decoder_channels(cfg))):
        out.append(conv(h, w, int(k), c, co * int(s) ** 2,
                        name=f"decoder.{i + 1}"))
        h, w, c = h * int(s), w * int(s), co
    out.append(conv(h, w, 3, c, 3, name="head_layer"))
    return out


def _all(arch_mod, cfg):
    enc = arch_mod.encoder_convs(cfg)
    return enc, decoder_convs(cfg, arch_mod.decoder_entry(cfg))


def decode_flops(arch_mod, cfg, batch: int) -> float:
    """A decode of `batch` frames from their embeddings."""
    return sum(flops(c, batch) for c in _all(arch_mod, cfg)[1])


def step_flops(arch_mod, cfg, batch: int, kind: str) -> float:
    """One training step: forward, input gradient and weight gradient of
    every conv that learns. 'calib' trains the decoder's quantizers on
    fixed embeddings; 'train' the whole model on frames. No input gradient
    reaches the step's own input."""
    enc, dec = _all(arch_mod, cfg)
    convs = dec if kind == "calib" else enc + dec
    total = 3 * sum(flops(c, batch) for c in convs)
    return total - flops(convs[0], batch)


def tail_least_s(arch_mod, cfg, batch: int, n_tail: int, passes) -> float:
    """The least card time of the decoder's last `n_tail` convs (the head
    the last), each pass in `passes` once."""
    dec = _all(arch_mod, cfg)[1]
    return len(passes) * sum(least_s(c, batch) for c in dec[-n_tail:])
