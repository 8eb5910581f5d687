"""PNeRV: pyramid NeRV with Kronecker-FC shortcuts and gated BSM fusion (the
counterpart of ``neuroquant_tpu/models/pnerv.py``; NHWC). ``PNeRV`` is
``PNeRV1``.

The decoder: an excitation block (1x1 conv, x10 pixel shuffle), then one
fusion stage per stride but the last: the stage's NeRVBlock, and a gate
that fuses its output with a KFc shortcut of the content embedding
(PNeRV1) or with itself (PNeRV2), through three (two) 3x3 BSM convs. The
stages take a shortcut tensor at every resolution, so they stay unpacked,
NHWC, on cuDNN; with ``bsm_dtype: bfloat16`` PNeRV1's BSM convs and gate
run in bf16. The post-fusion tail (the last NeRVBlock, the 3x3 head and
the sigmoid), a plain conv chain, runs packed and channels-first on the
fused tail's CUDA kernels from pack start 0 (``ops/tail_fused.py``).

Parameter names are the reference's (``enc_layers.*``,
``dec_exc_layers.conv.0``, ``dec_layers.{i}.conv.0``, ``dec_shortcuts.{3i}``
(KFc) and ``.{3i+1}`` (BatchNorm), ``dec_bsm_{z,r,h}.{i}``,
``dec_head_layers``), so a reference-layout ``.pth`` loads strictly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from neuroquant_tpu_torch.models.decoder import (
    KeptKernelWeights, _add, _conv_jvp, _out_img_jvp, _run, fused_tail_jvp,
    segment_runner)
from neuroquant_tpu_torch.models.layers import (
    BatchNorm2d, Conv2d, ConvNeXtBlock, KFcBias, LayerNorm, NeRVBlock,
    activation, collect_tail_params, out_img)
from neuroquant_tpu_torch.ops import precision
from neuroquant_tpu_torch.ops.packed_decode import plan_packed_tail
from neuroquant_tpu_torch.ops.tail_fused import (
    prepare_tail, resolve_impl, run_fused_tail_cf, run_fused_tail_frames)

_BSM_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class PNeRVConfig:
    crop_h: int
    crop_w: int
    enc_channel: int          # one width for every encoder stage
    emd_channel: int
    enc_strides: Tuple[int, ...]
    kfc_h_w_c: Tuple[int, int, int]
    kfc_strides: Tuple[int, ...]
    dec_norm: str
    dec_acts: str
    packed_tail: str = "auto"   # 'auto' | 'off' (post-fusion tail packing)
    fused_tail: str = "auto"    # 'off' decodes the tail unpacked
    bsm_dtype: str = "float32"  # the fusion stages' BSM convs and gate

    @classmethod
    def from_cfg(cls, cfg: dict) -> "PNeRVConfig":
        c = cls(
            crop_h=cfg["crop_h"], crop_w=cfg["crop_w"],
            enc_channel=int(cfg["enc_channel"]),
            emd_channel=int(cfg["emd_channel"]),
            enc_strides=tuple(cfg["enc_strides"]),
            kfc_h_w_c=tuple(cfg["kfc_h_w_c"]),
            kfc_strides=tuple(cfg["kfc_strides"]),
            dec_norm=cfg["dec_norm"], dec_acts=cfg["dec_acts"],
            packed_tail=str(cfg.get("packed_tail", "auto")),
            fused_tail=str(cfg.get("fused_tail", "auto")),
            bsm_dtype=str(cfg.get("bsm_dtype", "float32")),
        )
        if c.bsm_dtype not in _BSM_DTYPES:
            raise ValueError(f"bsm_dtype={c.bsm_dtype!r} (use "
                             f"{' or '.join(_BSM_DTYPES)})")
        return c

    @property
    def embed_hw(self) -> Tuple[int, int]:
        s = int(np.prod(self.enc_strides))
        return self.crop_h // s, self.crop_w // s


def pnerv_tail_packed(c: PNeRVConfig) -> bool:
    """Whether the post-fusion tail (the last NeRVBlock and the head) runs
    packed: the JAX package's padded-cost model on that one-block segment,
    ties broken toward packing where the fused tail is on (Bunny-3M ties
    exactly: 204800 * 4 * 9 == 819200 * 1 * 9)."""
    if c.dec_acts != "gelu" or c.dec_norm != "none":
        return False
    if str(c.packed_tail).lower() in ("off", "false", "none"):
        return False
    ngf, r = int(c.kfc_h_w_c[2]), int(c.kfc_strides[-1])
    if r <= 1:
        return False
    t = plan_packed_tail([3], [r], [ngf], [ngf], c.crop_h, c.crop_w,
                         prefer_packed=resolve_impl(c.fused_tail) is not None)
    return t == 0


class _Act(nn.Module):
    """An activation by name as a module (the shortcut's third entry)."""

    def __init__(self, act: str):
        super().__init__()
        self.fn = activation(act)

    def forward(self, x):
        return self.fn(x)


def _conv3(conv: Conv2d, x, dx=None, dw=None):
    """A 3x3 'same' conv on x and its tangent for input tangent dx and
    weight tangent dw. On a bf16 x the weights and bias are cast to bf16
    and the bias is added after the product, as the JAX package's bf16
    stage does."""
    if x.dtype == conv.weight.dtype:
        return _conv_jvp(conv, x, dx, dw)
    w = conv.weight.to(x.dtype)

    def raw(inp, weight):
        return F.conv2d(inp.permute(0, 3, 1, 2), weight, None, 1,
                        conv.padding).permute(0, 2, 3, 1)

    y = raw(x, w) + conv.bias.to(x.dtype)
    return y, _add(None if dx is None else raw(dx, w),
                   None if dw is None else raw(x, dw.to(x.dtype)))


def _mul(a, da, b, db):
    """a * b and its tangent."""
    return a * b, _add(None if da is None else da * b,
                       None if db is None else a * db)


class _PNeRVBase(KeptKernelWeights, nn.Module):
    """The encoder, the excitation block, the NeRVBlocks and the head that
    PNeRV1 and PNeRV2 share; each adds its fusion stage (``_fuse``)."""

    shortcuts = False   # PNeRV1: KFc shortcuts and the bsm_r convs

    def __init__(self, cfg: PNeRVConfig):
        super().__init__()
        self.cfg = c = cfg
        d, ngf = c.emd_channel, int(c.kfc_h_w_c[2])
        enc, cin = [], 3
        for s in c.enc_strides:
            enc += [Conv2d(cin, c.enc_channel, s, stride=s),
                    LayerNorm(c.enc_channel), ConvNeXtBlock(c.enc_channel)]
            cin = c.enc_channel
        enc.append(Conv2d(c.enc_channel, d, 1))
        self.enc_layers = nn.Sequential(*enc)
        self.dec_exc_layers = NeRVBlock(d, d, 1, 10, norm=c.dec_norm,
                                        act=c.dec_acts)
        n = len(c.kfc_strides)
        self.dec_layers = nn.ModuleList(
            NeRVBlock(d if i == 0 else ngf, ngf, 3, int(s), norm=c.dec_norm,
                      act=c.dec_acts) for i, s in enumerate(c.kfc_strides))
        if self.shortcuts:
            in_h, in_w = c.embed_hw
            sc, h, w = [], int(c.kfc_h_w_c[0]), int(c.kfc_h_w_c[1])
            for s in c.kfc_strides[:-1]:
                h, w = h * int(s), w * int(s)
                sc += [KFcBias(in_h, in_w, h, w, d), BatchNorm2d(d),
                       _Act(c.dec_acts)]
            self.dec_shortcuts = nn.ModuleList(sc)
        self.dec_bsm_z = nn.ModuleList(Conv2d(ngf, ngf, 3, padding=1)
                                       for _ in range(n - 1))
        if self.shortcuts:
            self.dec_bsm_r = nn.ModuleList(Conv2d(d, ngf, 3, padding=1)
                                           for _ in range(n - 1))
        self.dec_bsm_h = nn.ModuleList(Conv2d(ngf, ngf, 3, padding=1)
                                       for _ in range(n - 1))
        self.dec_head_layers = Conv2d(ngf, 3, 3, padding=1)
        self.tail_packed = pnerv_tail_packed(c)
        self._packed = {}   # _kernel_weights: key -> (weight version, wts)

    @property
    def n_fused(self) -> int:
        return len(self.cfg.kfc_strides) - 1

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX package's init: torch's default U(+-1/sqrt(fan_in)) for
        the encoder's stride convs, its projection and every decoder conv;
        truncated N(0, 0.02) and zero biases in the ConvNeXt blocks
        (LayerNorms at ones/zeros, gamma at 1e-6); KFc's kaiming fan-out
        normal and zero biases; BatchNorm at ones/zeros."""
        for m in self.modules():
            if isinstance(m, (Conv2d, KFcBias)):
                m.reset_parameters(generator)
        for m in self.modules():
            if isinstance(m, ConvNeXtBlock):
                for lin in (m.dwconv, m.pwconv1, m.pwconv2):
                    nn.init.trunc_normal_(lin.weight, std=0.02, a=-2.0,
                                          b=2.0, generator=generator)
                    nn.init.zeros_(lin.bias)

    def _kernel_params(self):
        return (*self.dec_layers[-1].parameters(),
                *self.dec_head_layers.parameters())

    def jvp_keys(self):
        """State-dict keys of the conv weights :meth:`decode_jvp` takes
        tangents on, in its order: the quantized layers' in the JAX
        package's order (``models.quant_layer_paths``): the excitation
        conv, each NeRVBlock's conv, bsm_z, bsm_r (PNeRV1), bsm_h, head."""
        kinds = ("z", "r", "h") if self.shortcuts else ("z", "h")
        return (["dec_exc_layers.conv.0.weight"]
                + [f"dec_layers.{i}.conv.0.weight"
                   for i in range(len(self.dec_layers))]
                + [f"dec_bsm_{k}.{i}.weight" for k in kinds
                   for i in range(self.n_fused)]
                + ["dec_head_layers.weight"])

    def model_input(self, frames, norm_idx):
        """PNeRV takes the frames."""
        return frames

    def encode(self, img):
        """NHWC frames -> (B, crop_h/prod(s), crop_w/prod(s), emd_channel)."""
        return self.enc_layers(img)

    def _fused_impl(self):
        return resolve_impl(self.cfg.fused_tail) if self.tail_packed else None

    def _tail_weights(self, x):
        h, w = int(x.shape[1]), int(x.shape[2])
        dt = precision.operand_dtype(x)
        return self._kernel_weights(("tail", h, w, dt), lambda: prepare_tail(
            h, w, *collect_tail_params(self.dec_layers, self.dec_head_layers,
                                       self.n_fused), dtype=dt))

    def _fusion(self, content, tangents=None, run=_run, piece=None):
        """The excitation block and the fusion stages: the tail-entry NHWC
        activation and, with `tangents` ({weight key: OIHW tangent}), its
        tangent. ``run(fn, *args)`` runs each segment: the excitation
        block, then each stage (its block and its gate) as one, `piece`
        the blocks' activation tangents' (:func:`decoder.segment_runner`)."""
        dw = (tangents or {}).get
        exc = self.dec_exc_layers

        def excite(e):
            x, dx = _conv_jvp(exc.conv[0], e, None,
                              dw("dec_exc_layers.conv.0.weight"))
            return exc.after_conv(x, dx, piece)

        def stage(i, x, dx):
            blk = self.dec_layers[i]
            x, dx = _conv_jvp(blk.conv[0], x, dx,
                              dw(f"dec_layers.{i}.conv.0.weight"))
            x, dx = blk.after_conv(x, dx, piece)
            return self._fuse(content, x, dx, i, dw)

        x, dx = run(excite, content)
        for i in range(self.n_fused):
            x, dx = run(functools.partial(stage, i), x, dx)
        return x, dx

    def _tail_plain(self, x, dx=None, dw={}.get, piece=None):
        blk = self.dec_layers[-1]
        x, dx = _conv_jvp(blk.conv[0], x, dx,
                          dw(f"dec_layers.{self.n_fused}.conv.0.weight"))
        x, dx = blk.after_conv(x, dx, piece)
        x, dx = _conv_jvp(self.dec_head_layers, x, dx,
                          dw("dec_head_layers.weight"))
        return _out_img_jvp(x, dx, "sigmoid")

    def decode_cf(self, content):
        """Decode to the packed channels-first head output with the sigmoid
        applied, (B, ch8, Mp): the calibration loss's domain (see
        ``NeRVDecoder.decode_cf``). Always on the fused tail's kernels."""
        if not self.tail_packed:
            raise ValueError("decode_cf requires the packed PNeRV tail (use "
                             "decode instead)")
        x, _ = self._fusion(content)
        z, _, _, _ = run_fused_tail_cf(x, self._tail_weights(x))
        return out_img(z, "sigmoid")

    def decode_jvp(self, content, dws=None, remat: bool = False):
        """Content embedding -> (frames, their tangent) for tangents
        ``dws`` on the quantized conv kernels, one OIHW tensor each in
        :meth:`jvp_keys`' order, or None for no tangent (the tangent comes
        back None). The shortcut branch act(BN(KFc(content))) carries no
        tangent (neither is quantized, and the content is fixed). The
        tail runs :func:`decoder.fused_tail_jvp` on the kernels from pack
        start 0 (``fused_tail`` other than off), else (also for any
        ``dec_acts`` other than gelu and any ``dec_norm`` other than none)
        the plain chain; each block's norm and activation carry the tangent
        (``NeRVBlock.after_conv``); every op first-order, so a gradient of
        the tangent differentiates each kernel once. Segments: the
        excitation block, each fusion stage, the tail's entry pack, each
        tail layer and its unpack (or the plain tail as one); with `remat`
        each is checkpointed and the activations' tangents run piece by
        piece (:func:`decoder.segment_runner`)."""
        keys = self.jvp_keys()
        if dws is None:
            dws = (None,) * len(keys)
        if len(dws) != len(keys):
            raise ValueError(f"decode_jvp: {len(dws)} tangents for "
                             f"{len(keys)} convs")
        tangents = dict(zip(keys, dws))
        run, piece = segment_runner(remat)
        x, dx = self._fusion(content, tangents, run, piece)
        if self._fused_impl() is None:
            return run(lambda x, dx: self._tail_plain(x, dx, tangents.get,
                                                      piece), x, dx)
        n = self.n_fused
        dw_tail = [tangents[f"dec_layers.{n}.conv.0.weight"],
                   tangents["dec_head_layers.weight"]]
        return fused_tail_jvp(x, dx, self.dec_layers, self.dec_head_layers,
                              n, dw_tail, "sigmoid", run, piece)

    def decode(self, content):
        """Content embedding -> NHWC frames in [0, 1]. The post-fusion tail
        runs on the kernels (``run_fused_tail_frames``); with
        ``packed_tail: off`` or ``fused_tail: off`` the plain chain; with
        ``fused_tail: pallas_hvp`` the value of :meth:`decode_jvp`."""
        impl = self._fused_impl()
        if impl == "pallas_hvp":
            return self.decode_jvp(content)[0]
        x, _ = self._fusion(content)
        if impl is None:
            return self._tail_plain(x)[0]
        return run_fused_tail_frames(x, self._tail_weights(x), "sigmoid")

    def forward(self, img):
        return self.decode(self.encode(img))


class PNeRV1(_PNeRVBase):
    """PNeRV with KFc pyramid shortcuts and BSM gated fusion."""

    shortcuts = True

    def _fuse(self, content, x, dx, i, dw):
        """One BSM fusion stage in the lerp form ``m_r + att * (x - m_r)``
        (the JAX package's, an fp32 rounding away from the reference's
        ``att * x + (1 - att) * m_r``). With ``bsm_dtype: bfloat16`` it runs
        in bf16 and the result is cast back to x's dtype; with float32 it
        runs in x's own dtype (float64 in a float64 model), as in JAX."""
        sc = self.dec_shortcuts
        pym = sc[3 * i + 2](sc[3 * i + 1](sc[3 * i](content)))
        dt = x.dtype
        bt = torch.bfloat16 if self.cfg.bsm_dtype == "bfloat16" else dt
        x, dx, pym = x.to(bt), None if dx is None else dx.to(bt), pym.to(bt)
        mz, dmz = _conv3(self.dec_bsm_z[i], x, dx,
                         dw(f"dec_bsm_z.{i}.weight"))
        mr, dmr = _conv3(self.dec_bsm_r[i], pym, None,
                         dw(f"dec_bsm_r.{i}.weight"))
        pre = mz + mr
        dpre = _add(dmz, dmr)
        m = F.relu(pre)
        dm = None if dpre is None else dpre * (pre > 0).to(bt)
        h, dh = _conv3(self.dec_bsm_h[i], m, dm, dw(f"dec_bsm_h.{i}.weight"))
        att = torch.sigmoid(h)
        datt = None if dh is None else att * (1.0 - att) * dh
        diff = x - mr
        ddiff = (None if dx is None and dmr is None
                 else _add(dx, None if dmr is None else -dmr))
        y, dy = _mul(att, datt, diff, ddiff)
        y, dy = mr + y, _add(dmr, dy)
        return y.to(dt), None if dy is None else dy.to(dt)


class PNeRV2(_PNeRVBase):
    """PNeRV without KFc shortcuts: ``att * x``, att from two BSM convs.
    Its stages run in fp32 whatever ``bsm_dtype`` says, as the JAX
    package's PNeRV2 does."""

    def _fuse(self, content, x, dx, i, dw):
        mz, dmz = _conv_jvp(self.dec_bsm_z[i], x, dx,
                            dw(f"dec_bsm_z.{i}.weight"))
        m = F.relu(mz)
        dm = None if dmz is None else dmz * (mz > 0).to(mz.dtype)
        h, dh = _conv_jvp(self.dec_bsm_h[i], m, dm,
                          dw(f"dec_bsm_h.{i}.weight"))
        att = torch.sigmoid(h)
        datt = None if dh is None else att * (1.0 - att) * dh
        return _mul(att, datt, x, dx)


PNeRV = PNeRV1
