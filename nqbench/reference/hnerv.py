"""Plain reference of HNeRV (Chen et al., CVPR 2023): the ConvNeXt content
encoder (a downsampling conv and layer norm a stage, then ConvNeXt blocks:
7x7 depthwise conv, layer norm, 4x linear, GELU, linear, layer scale,
residual), whose last stage is the frame's embedding, and the decoder of
``common.py`` with a (1, 1) block-to-space after decoder[0]. fp32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nqbench.reference import common


def _ln(x, w, b, eps=1e-6):
    """Layer norm over the last (channel) axis of an NHWC tensor."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _conv_nhwc(x, w, b, stride=1, padding=0, groups=1, tf32=False):
    return common.conv(x.permute(0, 3, 1, 2), w, b, stride, padding, groups,
                       tf32).permute(0, 2, 3, 1)


def encode(sd, cfg, frames, tf32=False):
    """NHWC frames in [0, 1] -> the NHWC embedding."""
    x = frames
    strides = cfg["enc_strides"]
    for i, s in enumerate(strides):
        p = f"encoder.downsample_layers.{i}"
        if i == 0:
            x = _conv_nhwc(x, sd[f"{p}.0.weight"], sd[f"{p}.0.bias"],
                           stride=s, tf32=tf32)
            x = _ln(x, sd[f"{p}.1.weight"], sd[f"{p}.1.bias"])
        else:
            x = _ln(x, sd[f"{p}.0.weight"], sd[f"{p}.0.bias"])
            x = _conv_nhwc(x, sd[f"{p}.1.weight"], sd[f"{p}.1.bias"],
                           stride=s, tf32=tf32)
        for j in range(int(cfg["stage_block"])):
            q = f"encoder.stages.{i}.{j}"
            c = x.shape[-1]
            y = _conv_nhwc(x, sd[f"{q}.dwconv.weight"], sd[f"{q}.dwconv.bias"],
                           padding=3, groups=c, tf32=tf32)
            y = _ln(y, sd[f"{q}.norm.weight"], sd[f"{q}.norm.bias"])
            y = common.linear(y, sd[f"{q}.pwconv1.weight"],
                              sd[f"{q}.pwconv1.bias"], tf32)
            y = common.linear(F.gelu(y), sd[f"{q}.pwconv2.weight"],
                              sd[f"{q}.pwconv2.bias"], tf32)
            x = x + sd[f"{q}.gamma"] * y
    return x


def decode(sd, cfg, embed, tf32=False):
    return common.decode(sd, cfg, embed, (1, 1), tf32)


def embed(sd, cfg, frames, index, n_frames: int, tf32=False):
    """The embedding of a batch of the clip: its frames, encoded."""
    return encode(sd, cfg, frames, tf32)
