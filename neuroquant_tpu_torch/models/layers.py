"""Model primitives for HNeRV, NeRV and PNeRV on NHWC tensors, with the
reference's torch parameter names (the counterpart of
``neuroquant_tpu/models/layers.py``).

Parameters keep torch's layouts (OIHW conv weights, (out, in) Linear
weights), so a reference ``.pth`` or a checkpoint written by the JAX
``save_pth`` loads with ``strict=True``. Activations stay NHWC as in the
JAX package: a conv permutes to NCHW, which for an NHWC-contiguous tensor is
PyTorch's channels-last layout, and back. Convs, linears and KFc's
products follow ``ops/precision.py`` (bf16 operands under ``regress
--matmul_precision bfloat16``).
"""

from __future__ import annotations

import contextlib
import functools
import math
from functools import lru_cache
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from neuroquant_tpu_torch.ops import precision
from neuroquant_tpu_torch.ops.pixelshuffle import pixel_shuffle
from neuroquant_tpu_torch.ops.tail_fused import (  # noqa: F401 (out_img)
    _by_pieces, out_img, prefix_cf_to_nhwc, prepare_prefix_block,
    run_fused_prefix_block)


class Conv2d(nn.Module):
    """NHWC conv with an OIHW ``weight`` and torch's default init."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        nn.init.uniform_(self.weight, -bound, bound, generator=generator)
        if self.bias is not None:
            nn.init.uniform_(self.bias, -bound, bound, generator=generator)

    def hwio(self):
        """The kernel as an HWIO view (the JAX layout)."""
        return self.weight.permute(2, 3, 1, 0)

    def forward(self, x):
        y = precision.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                             self.stride, self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class PixelShuffle(nn.Module):
    """``nn.PixelShuffle`` channel semantics on NHWC tensors."""

    def __init__(self, r):
        super().__init__()
        self.r = r

    def forward(self, x):
        return pixel_shuffle(x, self.r)


class UpsampleConv(nn.Sequential):
    """Conv to C_out*r*r channels, then PixelShuffle(r): the reference's
    ``nn.Sequential(Conv2d, PixelShuffle)``, hence the key ``conv.0``."""

    def __init__(self, cin: int, out_channel: int, kernel_size: int, r: int,
                 bias: bool = True):
        super().__init__(
            Conv2d(cin, out_channel * r * r, kernel_size,
                   padding=(kernel_size - 1) // 2, bias=bias),
            PixelShuffle(r))


def activation(act_type: str):
    """Activation by name; 'gelu' is the exact-erf GELU."""
    table = {
        "relu": F.relu,
        "leaky": functools.partial(F.leaky_relu, negative_slope=0.01),
        "leaky01": functools.partial(F.leaky_relu, negative_slope=0.1),
        "relu6": F.relu6,
        "gelu": F.gelu,
        "sin": torch.sin,
        "swish": F.silu,
        "softplus": F.softplus,
        "hardswish": F.hardswish,
    }
    if act_type not in table:
        raise KeyError(f"Unknown activation function {act_type}.")
    return table[act_type]


def _gelu_tangent(x, dx):
    """The exact-erf GELU and its tangent, (Phi(x) + x phi(x)) dx."""
    cdf = 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return F.gelu(x), (cdf + x * pdf) * dx


def _leaky_tangent(slope):
    def rule(x, dx):
        # jnp.where(x >= 0, x, slope * x): slope 1 at 0, as jax.jvp takes
        return (torch.where(x >= 0, x, slope * x),
                torch.where(x >= 0, dx, slope * dx))
    return rule


def _relu_tangent(x, dx):
    return F.relu(x), dx * (x > 0).to(dx.dtype)


def _relu6_tangent(x, dx):
    return F.relu6(x), dx * ((x > 0) & (x < 6)).to(dx.dtype)


def _swish_tangent(x, dx):
    s = torch.sigmoid(x)
    return x * s, dx * s + x * (dx * (s * (1.0 - s)))


def _softplus_tangent(x, dx):
    # F.softplus is x above 20, where jax's logaddexp(x, 0) rounds to x in
    # fp32 too and its tangent exp(x - softplus(x)) to 1, as sigmoid does
    return F.softplus(x), dx * torch.sigmoid(x)


def _hardswish_tangent(x, dx):
    # jax.nn.hard_swish, x * (relu6(x + 3) / 6), by the product rule: 0 at
    # -3 and 1 at 3, where relu6' is 0
    hs = F.relu6(x + 3.0) / 6.0
    m = ((x + 3.0 > 0) & (x + 3.0 < 6)).to(dx.dtype)
    return x * hs, dx * hs + x * (m * dx / 6.0)


_TANGENTS = {
    "relu": _relu_tangent,
    "leaky": _leaky_tangent(0.01),
    "leaky01": _leaky_tangent(0.1),
    "relu6": _relu6_tangent,
    "gelu": _gelu_tangent,
    "sin": lambda x, dx: (torch.sin(x), torch.cos(x) * dx),
    "swish": _swish_tangent,
    "softplus": _softplus_tangent,
    "hardswish": _hardswish_tangent,
}


class _TangentPieces(torch.autograd.Function):
    """(x, dx) -> an activation and its tangent, computed piece by piece
    (``tail_fused._by_pieces``), keeping only x and dx for the backward,
    which recomputes each piece's rule under autograd: the same values and
    gradients with each temporary a piece in size (``--remat``)."""

    @staticmethod
    def forward(ctx, x, dx, rule, piece):
        ctx.save_for_backward(x, dx)
        ctx.rule, ctx.piece = rule, piece
        return _by_pieces(piece, rule, x, dx)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gd):
        x, dx = ctx.saved_tensors

        def vjp(xp, dxp, gyp, gdp):
            with torch.enable_grad():
                xp = xp.detach().requires_grad_(True)
                dxp = dxp.detach().requires_grad_(True)
                return torch.autograd.grad(ctx.rule(xp, dxp), (xp, dxp),
                                           (gyp, gdp))
        return (*_by_pieces(ctx.piece, vjp, x, dx, gy.contiguous(),
                            gd.contiguous()), None, None)


def _tangent(act_type: str, x, dx, piece=None):
    if dx is None:
        return activation(act_type)(x), None
    if piece is None:
        return _TANGENTS[act_type](x, dx)
    return _TangentPieces.apply(x, dx, _TANGENTS[act_type], piece)


def activation_tangent(act_type: str):
    """``rule(x, dx, piece=None) -> (act(x), act'(x) * dx)``: the
    activation with its tangent (dx None: no tangent, None back), in
    first-order autograd ops, so that a gradient of the tangent is a
    Hessian-vector product (``decode_jvp``). The derivative at a kink is
    the one ``jax.jvp`` takes: relu 0 at 0, leaky and leaky01 1 at 0,
    relu6 0 at 0 and 6, hardswish 0 at -3 and 1 at 3. With a `piece` size
    (``tail_fused.PIECE`` under ``--remat``) it runs piece by piece
    (:class:`_TangentPieces`). A partial of a module function, so that a
    model holding it pickles (a data-parallel rank returns its model)."""
    if act_type not in _TANGENTS:
        raise KeyError(f"Unknown activation function {act_type}.")
    return functools.partial(_tangent, act_type)


class LayerNorm(nn.Module):
    """Layer norm over the channel (last) axis, eps 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


_BATCH_GROUP = None     # the process group a batch spans (batch_over)


@contextlib.contextmanager
def batch_over(group):
    """Inside, every :class:`BatchNorm2d` takes its statistics over the
    frames of all the ranks of `group` (a data-parallel step, whose batch
    is split over the ranks), as the JAX package's one program over a
    mesh does; None: this process's batch."""
    global _BATCH_GROUP
    prev, _BATCH_GROUP = _BATCH_GROUP, group
    try:
        yield
    finally:
        _BATCH_GROUP = prev


def _batch_norm_over(x, weight, bias, eps, group):
    """Batch norm of NHWC `x` with the statistics of the whole batch split
    over `group`'s ranks: the channel sums and the frame count, then the
    squared deviations, each summed over the ranks by an all-reduce that
    autograd differentiates (its backward sums the ranks' gradients)."""
    from torch.distributed.nn.functional import all_reduce

    c = x.shape[-1]
    local = torch.cat([x.sum((0, 1, 2)), x.new_full((1,), x.numel() // c)])
    total = all_reduce(local, group=group)
    mean = total[:c] / total[c]
    d = x - mean
    var = all_reduce((d * d).sum((0, 1, 2)), group=group) / total[c]
    return d * torch.rsqrt(var + eps) * weight + bias


class BatchNorm2d(nn.Module):
    """torch ``BatchNorm2d(track_running_stats=False)`` on NHWC tensors:
    always the batch's statistics (biased variance), so a frame's output
    depends on the other frames of its batch; inside :func:`batch_over`
    the batch is every rank's. Parameters ``weight`` and ``bias`` only."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if _BATCH_GROUP is not None:
            return _batch_norm_over(x, self.weight, self.bias, self.eps,
                                    _BATCH_GROUP)
        y = F.batch_norm(x.permute(0, 3, 1, 2), None, None, self.weight,
                         self.bias, training=True, eps=self.eps)
        return y.permute(0, 2, 3, 1)


class InstanceNorm2d(nn.Module):
    """torch ``InstanceNorm2d`` default on NHWC tensors: each image's and
    channel's statistics over H and W (biased variance), no affine, no
    parameters."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps)


def norm_layer(norm_type: str, ch_width: int) -> nn.Module:
    """A NeRVBlock's norm by name (the JAX ``norm_layer``): 'none' (no
    parameters), 'batch' (:class:`BatchNorm2d`) or 'instance'."""
    if norm_type == "none":
        return nn.Identity()
    if norm_type == "batch":
        return BatchNorm2d(ch_width)
    if norm_type == "instance":
        return InstanceNorm2d()
    raise NotImplementedError(norm_type)


def norm_tangent(norm: nn.Module, x, dx):
    """A NeRVBlock's norm and its tangent (dx None: None back), in
    first-order autograd ops. With x^ = (x - mean) r, r = 1/sqrt(var +
    eps), over the statistics' axes (the batch and the image for
    :class:`BatchNorm2d`, the image for :class:`InstanceNorm2d`): dx^ = r
    (dxc - x^ mean(x^ dxc)), dxc = dx - mean(dx), times the batch norm's
    weight. The statistics are this process's batch (stage 2 runs in one
    process)."""
    y = norm(x)
    if dx is None or isinstance(norm, nn.Identity):
        return y, dx
    dims = (0, 1, 2) if isinstance(norm, BatchNorm2d) else (1, 2)
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, correction=0)
    r = torch.rsqrt(var + norm.eps)
    xh = (x - mean) * r
    dxc = dx - dx.mean(dim=dims, keepdim=True)
    dy = r * (dxc - xh * (xh * dxc).mean(dim=dims, keepdim=True))
    return y, (dy * norm.weight if isinstance(norm, BatchNorm2d) else dy)


def norms_over_batch(model) -> bool:
    """Whether `model` holds a :class:`BatchNorm2d` (PNeRV's shortcuts, a
    decoder's ``dec_norm: batch``), so that a frame's output depends on its
    batch."""
    return any(isinstance(m, BatchNorm2d) for m in model.modules())


class KFcBias(nn.Module):
    """PNeRV's Kronecker fully-connected upsampler, per channel c:
    ``w_L[c] @ x[c] @ w_R[c] + b_c[c] * (b_h @ b_w)``, (B, ih, iw, C) ->
    (B, oh, ow, C). Parameters in the reference's shapes: w_L (1, C, oh,
    ih), w_R (1, C, iw, ow), b_h (oh, 1), b_w (1, ow), b_c (C, 1)."""

    def __init__(self, in_height: int, in_width: int, out_height: int,
                 out_width: int, channels: int):
        super().__init__()
        c, ih, iw, oh, ow = (channels, in_height, in_width, out_height,
                             out_width)
        self.w_L = nn.Parameter(torch.empty(1, c, oh, ih))
        self.w_R = nn.Parameter(torch.empty(1, c, iw, ow))
        self.b_h = nn.Parameter(torch.zeros(oh, 1))
        self.b_w = nn.Parameter(torch.zeros(1, ow))
        self.b_c = nn.Parameter(torch.zeros(c, 1))

    def reset_parameters(self, generator=None):
        """kaiming_normal_(mode='fan_out', relu) of the reference's (C, m,
        n) tensors: std sqrt(2 / (C * n)); zero biases."""
        for w in (self.w_L, self.w_R):
            std = math.sqrt(2.0 / (w.shape[1] * w.shape[-1]))
            nn.init.normal_(w, 0.0, std, generator=generator)
        for b in (self.b_h, self.b_w, self.b_c):
            nn.init.zeros_(b)

    def forward(self, x):
        c, oh, ow = self.w_L.shape[1], self.w_L.shape[2], self.w_R.shape[3]
        b = (self.b_c @ (self.b_h @ self.b_w).reshape(1, oh * ow)).reshape(
            c, oh, ow)
        y = precision.einsum("coh,bchw->bcow", self.w_L[0],
                             x.permute(0, 3, 1, 2))
        y = precision.einsum("bcow,cwq->bcoq", y, self.w_R[0]) + b
        return y.permute(0, 2, 3, 1).contiguous()


class NeRVBlock(nn.Module):
    """Conv(cin, cout*s*s, k, pad=(k-1)//2) -> PixelShuffle(s) -> norm ->
    act, the norm by ``dec_norm`` (:func:`norm_layer`) under the name
    torch's reference block gives it (``norm``: keys ``{block}.norm.weight``
    and ``.bias`` for a batch norm)."""

    def __init__(self, cin: int, out_channel: int, kernel_size: int,
                 stride: int, norm: str = "none", act: str = "gelu"):
        super().__init__()
        self.out_channel, self.kernel_size, self.stride = (
            out_channel, kernel_size, stride)
        self.conv = UpsampleConv(cin, out_channel, kernel_size, stride)
        self.norm = norm_layer(norm, out_channel)
        self.act_fn = activation(act)
        self.act_tangent = activation_tangent(act)

    def conv_params(self):
        """(HWIO kernel, bias) of the block's conv."""
        return self.conv[0].hwio(), self.conv[0].bias

    def after_conv(self, x, dx=None, piece=None):
        """Shuffle, norm and activation of the conv's output x and its
        tangent dx (None: none)."""
        x = pixel_shuffle(x, self.stride)
        dx = None if dx is None else pixel_shuffle(dx, self.stride)
        x, dx = norm_tangent(self.norm, x, dx)
        return self.act_tangent(x, dx, piece)

    def forward(self, x):
        return self.act_fn(self.norm(self.conv(x)))


@lru_cache(maxsize=16)
def _pe_table(base: float, level: int, n_frames: int, device: str):
    """The (n_frames, 2*level) encoding of the frame grid idx / n_frames on
    `device`, made once: the reference's float32 bases ``base **
    arange(level) * pi``, float64 positions, products and sin/cos, cast to
    float32."""
    bases = ((base ** torch.arange(level)) * math.pi).double()
    pos = torch.arange(n_frames, dtype=torch.float64)[:, None] / n_frames
    v = pos * bases
    return torch.cat([torch.sin(v), torch.cos(v)], dim=-1).float().to(device)


class PositionEncoding(nn.Module):
    """NeRV's index embedding, [sin, cos](pos * base**arange(level) * pi)
    -> (B, 1, 1, 2*level), parameter-free.

    With n_frames > 0 (pos on the grid idx / n_frames, the only positions
    the pipeline evaluates) each frame's row comes from a table with the
    reference's exact semantics (:func:`_pe_table`), bit for bit the JAX
    package's; the row is clip(round(pos * n_frames), 0, n_frames - 1),
    half to even. Without n_frames the plain fp32 formula runs, for any
    pos."""

    def __init__(self, base: float, level: int, n_frames: int = 0):
        super().__init__()
        self.base, self.level, self.n_frames = float(base), int(level), \
            int(n_frames)

    def forward(self, pos):
        pos = pos.to(torch.float32).reshape(-1, 1)
        b = pos.shape[0]
        if self.n_frames > 0:
            table = _pe_table(self.base, self.level, self.n_frames,
                              str(pos.device))
            idx = torch.clamp(torch.round(pos[:, 0] * self.n_frames),
                              0, self.n_frames - 1).to(torch.int64)
            return table[idx].reshape(b, 1, 1, -1)
        bases = (self.base ** torch.arange(self.level, dtype=torch.float32,
                                           device=pos.device)) * math.pi
        v = pos * bases
        return torch.cat([torch.sin(v), torch.cos(v)], dim=-1).reshape(
            b, 1, 1, -1)


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LN -> Linear 4x -> GELU -> Linear -> gamma -> residual."""

    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x):
        y = self.norm(self.dwconv(x))
        y = precision.linear(y, self.pwconv1.weight, self.pwconv1.bias)
        y = precision.linear(F.gelu(y), self.pwconv2.weight,
                             self.pwconv2.bias)
        return x + self.gamma * y


class ConvNeXt(nn.Module):
    """Stage pyramid: (downsample conv + LN) then stage_blocks ConvNeXt
    blocks per stage; returns the last stage."""

    def __init__(self, stage_blocks: int, strds: Sequence[int],
                 dims: Sequence[int], in_chans: int = 3):
        super().__init__()
        down = []
        for i, (s, d) in enumerate(zip(strds, dims)):
            if i == 0:
                down.append(nn.Sequential(Conv2d(in_chans, d, s, stride=s),
                                          LayerNorm(d)))
            else:
                down.append(nn.Sequential(LayerNorm(dims[i - 1]),
                                          Conv2d(dims[i - 1], d, s, stride=s)))
        self.downsample_layers = nn.ModuleList(down)
        self.stages = nn.ModuleList(
            nn.Sequential(*[ConvNeXtBlock(d) for _ in range(stage_blocks)])
            for d in dims)

    def forward(self, x):
        for down, stage in zip(self.downsample_layers, self.stages):
            x = stage(down(x))
        return x


def _build(key, build):
    return build()


def fuses_prefix_block(blocks, t: int, impl, fused_prefix: str,
                       dec_norm: str) -> bool:
    """Whether the last prefix block, blocks[t-1], runs on the tail
    kernels (see :func:`run_prefix_blocks`)."""
    return (str(fused_prefix) != "off" and t >= 1 and impl is not None
            and dec_norm == "none" and blocks[t - 1].kernel_size % 2 == 1)


def run_prefix_blocks(blocks, t: int, x, impl, *, fused_prefix: str,
                      dec_norm: str, memo=_build):
    """Run the decode prefix blocks[:t] on NHWC x. With the fused tail the
    LAST prefix block, nearly all of the prefix's FLOPs, runs its conv as
    a 1-layer channels-first plan on the tail kernels (pack_cf +
    tail_conv_cf); its PixelShuffle becomes one relabel of that output.
    ``memo(key, build)`` returns ``build()``, the block's packed weights,
    or a copy kept from an earlier call (``NeRVDecoder._kernel_weights``).
    Gradients pass: the fused block runs through the tail's and
    ``pack_cf``'s autograd Functions, the relabel back is plain torch.

    The fused block runs in ``precision.operand_dtype(x)``: bf16 weights
    under the bf16 matmul precision.

    The JAX package also gates this on a minimum grid (``PREFIX_MIN_GRID``,
    a TPU per-call overhead knob); the port fuses at any grid size."""
    last = t - 1
    fused = fuses_prefix_block(blocks, t, impl, fused_prefix, dec_norm)
    for j in range(last if fused else t):
        x = blocks[j](x)
    if fused:
        blk = blocks[last]
        h, w = int(x.shape[1]), int(x.shape[2])
        dt = precision.operand_dtype(x)
        wts = memo(("prefix", h, w, dt), lambda: prepare_prefix_block(
            h, w, *blk.conv_params(), blk.stride, dtype=dt))
        z = run_fused_prefix_block(x, wts)
        x = blk.act_fn(prefix_cf_to_nhwc(z, wts.plan, blk.stride,
                                         blk.out_channel))
    return x


def collect_tail_params(blocks, head_layer, pack_start: int):
    """The raw (HWIO kernel, bias, stride) of the tail blocks from
    pack_start on, and the head's (HWIO kernel, bias)."""
    out = [(*blocks[j].conv_params(), blocks[j].stride)
           for j in range(pack_start, len(blocks))]
    return out, (head_layer.hwio(), head_layer.bias)
