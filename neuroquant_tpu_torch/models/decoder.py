"""The conv/pixel-shuffle decoder HNeRV and NeRV share (NHWC): decoder[0], a
1x1 conv whose output a (fc_h, fc_w) block-to-space shuffle spreads over
the first grid; one NeRVBlock per stride; the 3x3 head. The two models
differ only in their encoder, which gives decoder[0]'s input: HNeRV's
ConvNeXt embeds a frame, NeRV's position encoding a frame index.

The decode runs the high-resolution tail packed from the pack start on,
channels-first, on the fused tail's CUDA kernels (ops/tail_fused.py), the
last prefix block fused too; ``decode_cf`` stays in the packed domain (the
calibration loss) and ``decode_jvp`` carries a tangent on the decoder's
conv kernels beside the value (stage 2's Hessian-vector product). PNeRV's
decoder (``models/pnerv.py``) shares the forward-mode tail
(:func:`fused_tail_jvp`), the segmenting of the forward-mode decode
(:func:`segment_runner`) and the packed-weights memo
(:class:`KeptKernelWeights`)."""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from neuroquant_tpu_torch.models.layers import (
    Conv2d, NeRVBlock, collect_tail_params, fuses_prefix_block, out_img,
    run_prefix_blocks)
from neuroquant_tpu_torch.ops import precision
from neuroquant_tpu_torch.ops.packed_decode import (
    depth_to_space, resolve_pack_start)
from neuroquant_tpu_torch.ops.pixelshuffle import pixel_shuffle
from neuroquant_tpu_torch.ops.tail_fused import (
    cf_to_nhwc, pack_cf, pack_prefix_block, plan_and_pack, prefix_cf_to_nhwc,
    PIECE, _run, prepare_tail, resolve_impl, run_fused_tail_cf,
    run_fused_tail_frames, tail_apply_fo)
from neuroquant_tpu_torch.utils.profiling import span


class DecoderShape:
    """What a decoder config derives from its fields (the ``dec_*``,
    ``channel_*`` and crop keys)."""

    def decoder_channels(self):
        """Each block's output channels: the reference's shrink rule."""
        chans, in_c = [], self.dec_in_channel
        for _ in self.dec_strides:
            out_c = int(max(round(in_c / self.channel_reduce),
                            self.channel_lbound))
            chans.append(out_c)
            in_c = out_c
        return chans


def _shuffle(x, r):
    return None if x is None else pixel_shuffle(x, r)


def _add(a, b):
    return b if a is None else a if b is None else a + b


def _conv_jvp(conv: Conv2d, x, dx, dw):
    """An NHWC conv and its tangent, for input tangent dx and weight
    tangent dw (OIHW; either may be None): conv(dx, W) + conv(x, dW)."""
    def raw(inp, weight):
        return F.conv2d(inp.permute(0, 3, 1, 2), weight, None, conv.stride,
                        conv.padding, groups=conv.groups).permute(0, 2, 3, 1)

    return conv(x), _add(None if dx is None else raw(dx, conv.weight),
                         None if dw is None else raw(x, dw))


def _out_img_jvp(x, dx, out_bias: str):
    y = out_img(x, out_bias)
    if dx is None:
        return y, None
    if out_bias == "tanh":
        return y, 0.5 * (1.0 - torch.tanh(x) ** 2) * dx
    if out_bias == "sigmoid":
        return y, y * (1.0 - y) * dx
    return y, dx


def _hwio(dw):
    return None if dw is None else dw.permute(2, 3, 1, 0)


def _pack_entry(x, dx, plan):
    """The value and its tangent into the channels-first layout (pack_cf is
    linear)."""
    return (pack_cf(x.contiguous(), plan),
            None if dx is None else pack_cf(dx.contiguous(), plan))


def _remat(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def segment_runner(remat: bool):
    """``(run, piece)`` for a forward-mode decode: ``run(fn, *args)`` runs
    a segment, fn as it is, or with `remat` under non-reentrant
    ``torch.utils.checkpoint``, so that the segment keeps only its inputs
    and outputs (the primal and its tangent at its boundaries) and a
    backward through it recomputes its inside, one segment at a time; with
    `remat` the tail's tangent GELU also runs in pieces of `piece`
    elements (``tail_fused.PIECE``; None: whole)."""
    return (_remat, PIECE) if remat else (_run, None)


def fused_tail_jvp(x, dx, blocks, head_layer, t: int, dws, out_bias: str,
                   run=_run, piece=None):
    """The tail blocks[t:] and the head on the kernels in forward mode
    (:func:`tail_fused.tail_apply_fo`), from the NHWC tail-entry value x and
    its tangent dx: (frames, their tangent). `dws`: OIHW tangents of the
    tail blocks' convs, then the head's, all None or none None. The
    kernels' tangents are packed by the same gather as the kernels; the
    head's output is unpacked by plain tensor ops, as the JAX package's
    HVP execution does. Segments, each ``run(fn, value, tangent)``
    (:func:`segment_runner`, which gives `piece` too): the entry's pack,
    each tail layer, the unpack."""
    h, w = int(x.shape[1]), int(x.shape[2])
    tail, head = collect_tail_params(blocks, head_layer, t)
    plan, kks, bms, f, ch = plan_and_pack(h, w, tail, head)
    dkks = (None,) * len(kks)
    if dws[0] is not None:
        dkks = plan_and_pack(
            h, w, [(_hwio(dws[j - t]), None, blocks[j].stride)
                   for j in range(t, len(blocks))],
            (_hwio(dws[-1]), None))[1]

    def unpack(z, dz):
        y, dy = _out_img_jvp(cf_to_nhwc(z, plan, ch),
                             None if dz is None else cf_to_nhwc(dz, plan, ch),
                             out_bias)
        return (depth_to_space(y, f),
                None if dy is None else depth_to_space(dy, f))

    x_cf, dx_cf = run(lambda x, dx: _pack_entry(x, dx, plan), x, dx)
    z, dz = tail_apply_fo(plan, x_cf, dx_cf, kks, dkks, bms, run=run,
                          piece=piece)
    return run(unpack, z, dz)


class KeptKernelWeights:
    """``_kernel_weights(key, build)`` for a module whose decode packs conv
    weights for the kernels: the packed weights are kept across decodes
    until one of ``_kernel_params()`` changes. The module sets
    ``self._packed = {}`` (key -> (weight version, weights))."""

    def _kernel_params(self):
        raise NotImplementedError

    def __getstate__(self):
        # the kept weights are a cache: a pickled model rebuilds them
        return {**self.__dict__, "_packed": {}}

    def _kernel_weights(self, key, build):
        """``build()``: the fused prefix's or tail's weights packed for the
        kernels, kept across decodes until the weights change.
        ``load_state_dict`` and every in-place update bump a parameter's
        version counter, and a moved or replaced parameter has a new
        address; either rebuilds. With gradients on it always rebuilds, so
        no kept tensor carries a graph."""
        if torch.is_grad_enabled():
            return build()
        version = tuple((p.data_ptr(), p._version)
                        for p in self._kernel_params())
        hit = self._packed.get(key)
        if hit is None or hit[0] != version:
            hit = self._packed[key] = (version, build())
        return hit[1]


class NeRVDecoder(KeptKernelWeights, nn.Module):
    """`encoder` -> decoder[0] (1x1 conv, `in_channel` -> dec_in_channel *
    fc_h * fc_w, then the (fc_h, fc_w) shuffle) -> the NeRVBlocks -> the
    head. Parameter names are the reference's: ``encoder.*``,
    ``decoder.0``, ``decoder.{i}.conv.0``, ``head_layer``."""

    def __init__(self, cfg, encoder: nn.Module, in_channel: int):
        super().__init__()
        self.cfg = c = cfg
        self.encoder = encoder
        chans = c.decoder_channels()
        decoder = [Conv2d(in_channel, c.dec_in_channel * c.fc_h * c.fc_w, 1)]
        for ks, stride, cin, cout in zip(c.dec_kernels, c.dec_strides,
                                         [c.dec_in_channel] + chans[:-1],
                                         chans):
            decoder.append(NeRVBlock(cin, cout, ks, stride, norm=c.dec_norm,
                                     act=c.dec_acts))
        self.decoder = nn.ModuleList(decoder)
        self.head_layer = Conv2d(chans[-1], 3, 3, padding=1)
        self.pack_start = resolve_pack_start(
            c.packed_tail, c.dec_kernels, c.dec_strides, c.dec_norm,
            [c.dec_in_channel] + chans[:-1], chans, c.crop_h, c.crop_w)
        self._packed = {}   # _kernel_weights: key -> (weight version, wts)

    @property
    def blocks(self):
        return list(self.decoder)[1:]

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's init of the decoder: torch's default
        U(+-1/sqrt(fan_in)) for every conv."""
        for m in self.decoder.modules():
            if isinstance(m, Conv2d):
                m.reset_parameters(generator)
        self.head_layer.reset_parameters(generator)

    def model_input(self, frames, norm_idx):
        """What the model takes for each frame of a clip, from its frames
        (N, H, W, 3) and their normalized indices (N,): HNeRV the frames."""
        return frames

    def encode(self, x):
        """The encoder's embedding of the model's input: HNeRV's NHWC frames
        -> (B, crop_h/prod(s), crop_w/prod(s), enc_channel[-1])."""
        return self.encoder(x)

    def _fused_impl(self):
        if self.pack_start is None or self.cfg.dec_acts != "gelu":
            return None
        return resolve_impl(self.cfg.fused_tail)

    def _kernel_params(self):
        return (*self.decoder.parameters(), *self.head_layer.parameters())

    def jvp_keys(self):
        """State-dict keys of the conv weights :meth:`decode_jvp` takes
        tangents on, in its order: decoder[0], each block's conv, the head
        (the quantized layers, in decode order)."""
        return (["decoder.0.weight"]
                + [f"decoder.{j + 1}.conv.0.weight"
                   for j in range(len(self.blocks))] + ["head_layer.weight"])

    def _layer0(self, img_embed):
        """decoder[0] and its (fc_h, fc_w) block-to-space shuffle."""
        c = self.cfg
        return pixel_shuffle(self.decoder[0](img_embed), (c.fc_h, c.fc_w))

    def _prefix(self, img_embed, impl):
        """decoder0 + blocks[:pack_start] -> the tail-entry NHWC activation."""
        c = self.cfg
        return run_prefix_blocks(self.blocks, self.pack_start,
                                 self._layer0(img_embed), impl,
                                 fused_prefix=c.fused_prefix,
                                 dec_norm=c.dec_norm,
                                 memo=self._kernel_weights)

    def _tail_weights(self, x):
        """The tail's packed weights, in the dtype its kernels take for x
        (``precision.operand_dtype``)."""
        h, w = int(x.shape[1]), int(x.shape[2])
        dt = precision.operand_dtype(x)
        return self._kernel_weights(("tail", h, w, dt), lambda: prepare_tail(
            h, w, *collect_tail_params(self.blocks, self.head_layer,
                                       self.pack_start), dtype=dt))

    def decode_cf(self, img_embed):
        """Decode to the packed channels-first head output with `out_bias`
        applied, (B, ch8, Mp): the calibration loss runs in this domain
        against ``tail_fused.pack_targets``-packed frames (the
        depth-to-space is a permutation, so a sum of elementwise losses is
        the same), without the unpack. Always on the fused tail: the kernels
        are the port's one implementation of it (the JAX package takes its
        jnp twin where its kernels are off)."""
        if self.pack_start is None or self.cfg.dec_acts != "gelu":
            raise ValueError("decode_cf requires a packed GELU tail (use "
                             "decode instead)")
        x = self._prefix(img_embed, "fused")
        z, _, _, _ = run_fused_tail_cf(x, self._tail_weights(x))
        return out_img(z, self.cfg.out_bias)

    def decode_jvp(self, img_embed, dws=None, remat: bool = False):
        """Embedding -> (frames, their tangent) for tangents ``dws`` on the
        decoder's conv kernels: one OIHW tensor per conv, in decode order
        (decoder[0], each block's conv, the head: the quantized layers), or
        None for no tangent (the tangent comes back None).

        On the fused tail (``fused_tail`` other than off) the last prefix
        block and the tail run :func:`tail_fused.tail_apply_fo` on the
        kernels, the tangent entering through ``pack_cf`` (linear) and the
        kernels' tangents packed by the same gather as the kernels; the
        head's output is unpacked by plain tensor ops, as the JAX package's
        HVP execution does. Otherwise (``fused_tail: off``, any
        ``dec_acts`` other than gelu, any ``dec_norm`` other than none) the
        plain unpacked chain carries the tangent on cuDNN convs, through
        each block's norm and activation (``layers.norm_tangent``,
        ``activation_tangent``). Every op of either graph is first-order
        autograd, so a gradient of the tangent (a Hessian-vector product)
        differentiates each kernel once.

        The decode runs in segments: decoder[0], each prefix block, the
        fused prefix block, then the tail's entry pack, each tail layer and
        its unpack (or the plain head). With `remat` each segment is
        checkpointed (:func:`segment_runner`), and the activations'
        tangents run piece by piece."""
        c = self.cfg
        blocks = self.blocks
        if dws is None:
            dws = (None,) * (len(blocks) + 2)
        if len(dws) != len(blocks) + 2:
            raise ValueError(f"decode_jvp: {len(dws)} tangents for "
                             f"{len(blocks) + 2} convs")
        run, piece = segment_runner(remat)
        impl = self._fused_impl()
        t = len(blocks) if impl is None else self.pack_start
        fc = (c.fc_h, c.fc_w)

        def layer0(e):
            x, dx = _conv_jvp(self.decoder[0], e, None, dws[0])
            return _shuffle(x, fc), _shuffle(dx, fc)

        def block(j, x, dx):
            x, dx = _conv_jvp(blocks[j].conv[0], x, dx, dws[j + 1])
            return blocks[j].after_conv(x, dx, piece)

        def head(x, dx):
            x, dx = _conv_jvp(self.head_layer, x, dx, dws[-1])
            return _out_img_jvp(x, dx, c.out_bias)

        def fused_block(x, dx):
            h, w = int(x.shape[1]), int(x.shape[2])
            blk = blocks[t - 1]
            plan, kks, bms, r, _ = pack_prefix_block(h, w, *blk.conv_params(),
                                                     blk.stride)
            dkks = (None,) if dws[t] is None else pack_prefix_block(
                h, w, _hwio(dws[t]), None, r)[1]
            x_cf, dx_cf = _pack_entry(x, dx, plan)
            z, dz = tail_apply_fo(plan, x_cf, dx_cf, kks, dkks, bms,
                                  piece=piece)
            x = prefix_cf_to_nhwc(z, plan, r, blk.out_channel)
            dx = (None if dz is None
                  else prefix_cf_to_nhwc(dz, plan, r, blk.out_channel))
            return blk.act_tangent(x, dx)

        x, dx = run(layer0, img_embed)
        fused = fuses_prefix_block(blocks, t, impl, c.fused_prefix,
                                   c.dec_norm)
        for j in range(t - 1 if fused else t):
            x, dx = run(functools.partial(block, j), x, dx)
        if impl is None:
            return run(head, x, dx)
        if fused:
            x, dx = run(fused_block, x, dx)
        return fused_tail_jvp(x, dx, blocks, self.head_layer, t, dws[t + 1:],
                              c.out_bias, run, piece)

    def decode(self, img_embed, return_embeds: bool = False):
        """Embedding -> NHWC frames in [0, 1] (for the tanh/sigmoid heads).

        The kernel path runs the high-resolution tail packed from the pack
        start on, channels-first, on the CUDA kernels (ops/tail_fused.py),
        with the last prefix block fused too. With ``packed_tail: off`` or
        ``fused_tail: off`` the plain unpacked conv/shuffle chain runs; with
        ``fused_tail: pallas_hvp`` the value of :meth:`decode_jvp`.

        With `return_embeds`: (frames, embeds) from the plain unpacked
        chain, as the JAX package's: embeds = [img_embed, decoder[0]'s
        output after its (fc_h, fc_w) shuffle, each block's output]. The
        unit-scope calibration reads its units' inputs and outputs there
        (``quantization/calib_unit.py``). HNeRV's shuffle is (1, 1), so its
        embeds[1] is decoder[0]'s conv output, as in JAX.

        Spans (``utils.profiling.span``): ``decode`` round the call, and on
        the kernel path ``prefix`` and ``tail`` (the tail's weights, plan,
        checks and launches)."""
        c = self.cfg
        with span("decode"):
            if return_embeds:
                x = self._layer0(img_embed)
                embeds = [img_embed, x]
                for blk in self.blocks:
                    x = blk(x)
                    embeds.append(x)
                return out_img(self.head_layer(x), c.out_bias), embeds
            impl = self._fused_impl()
            if impl == "pallas_hvp":
                return self.decode_jvp(img_embed)[0]
            if impl is not None:
                with span("prefix"):
                    x = self._prefix(img_embed, impl)
                with span("tail"):
                    return run_fused_tail_frames(x, self._tail_weights(x),
                                                 c.out_bias)
            x = self._layer0(img_embed)
            for blk in self.blocks:
                x = blk(x)
            return out_img(self.head_layer(x), c.out_bias)

    def forward(self, x):
        return self.decode(self.encode(x))
