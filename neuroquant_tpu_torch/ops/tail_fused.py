"""Channels-first execution of the packed decoder tail on CUDA kernels.

The counterpart of ``neuroquant_tpu/ops/tail_fused.py``. Activations live
channels-first and spatially flattened, (B, C8, Mp) with Mp = (H+2P) *
(W+2P) rows-major including a P-wide zero border, padded up to a whole
number of ``plan.tm`` positions. A conv tap (ty, tx) is then a constant
flat shift (ty-off)*Wp + (tx-off); borders are re-zeroed after every layer
(the semantics of 'same' zero padding) and channel counts pad to multiples
of 8 with zero weights, so the padding is inert.

Five kernels (``csrc/``) run the tail's high-resolution work:

  ``tail_conv_cf``     one conv layer:
                       z = mask * (conv(gelu?(x), kk) + b) * gelu'(m)?,
                       emitting z or gelu(z); with the GELU' factor it is
                       the backward's dx pass   (TPU: ``_fwd_kernel``)
  ``tail_conv_dw_cf``  one layer's dW and db    (TPU: ``_dw_kernel``)
  ``pack_cf``          NHWC -> (B, C8, Mp) with zero border and pads
                       (TPU: ``_pack_cf_kernel`` + ``pack_cf``'s pad glue)
  ``unpack_cf``        (B, C8, Mp) -> NHWC interior, ``pack_cf``'s backward
                       (TPU: ``_unpack_cf_kernel``)
  ``unpack_frames``    head output -> out_img -> depth-to-space -> NHWC
                       frames (TPU: ``_unpack_kernel`` / ``_unpack_kernel5``)

Each wrapper takes its plain PyTorch version (``conv_cf_ref``,
``conv_cf_dw_ref``, ``pack_cf_ref``, ``unpack_cf_ref``,
``unpack_frames_ref``) for a tensor on the CPU and its kernel for a tensor
on the GPU; a kernel that cannot build or launch raises.
``KERNEL_LAUNCHES`` counts the kernel launches.

Gradients: ``tail_apply``, ``pack_cf`` and ``unpack_frames`` are
``torch.autograd.Function``s when an input requires a gradient. The tail's
backward is the JAX ``_tail_apply_bwd``: dW/db from ``tail_conv_dw_cf``,
dx from ``tail_conv_cf`` on the tap-reversed, channel-swapped kernel with
the GELU' epilogue; ``pack_cf``'s backward is ``unpack_cf``;
``unpack_frames``'s is the VJP of its plain version, as in JAX.

Left out as TPU scheduling: the execution modes and their cost model
(``ExecCfg``, ``_exec_cfg``, ``_SWEEP_PINS*``, ``NQ_TAIL_MODE``), the VMEM
budget and cout-row split (``_VMEM_BUDGET``, ``_split_parts``,
``_bwd_needs_split``), the halo DMA streaming, and the bf16 operand cast
(``_mxu_cast``, ``_entry_and_cast``): the kernels take fp32 operands and
accumulate in fp32. What is kept from the modes is the union-sparse K axis
of a layer packed with f >= 2 (``_union_blocks``): it skips the kernel's
structurally zero blocks, 4x fewer MACs at the HNeRV Bunny head, in the
forward, dx and dW alike.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neuroquant_tpu_torch.ops.packed_decode import (
    compose_shuffle_perm, depth_to_space, identity_perm, pack_conv_kernel,
    packed_kernel_geometry, packed_sparse_taps, space_to_depth,
)

# kernel launches per wrapper, since the last reset_launch_counts()
# (fq_uaq and fq_ada: the two entries of ops/fused_fakequant.py's kernel)
KERNEL_LAUNCHES = {"tail_conv_cf": 0, "tail_conv_dw_cf": 0, "pack_cf": 0,
                   "unpack_cf": 0, "unpack_frames": 0, "fq_uaq": 0,
                   "fq_ada": 0}


def reset_launch_counts() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def _r8(c: int) -> int:
    return -(-int(c) // 8) * 8


def _erf(x):
    """erf by Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7): the formula
    the JAX tail and the CUDA kernels use, not ``torch.erf``."""
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gelu(x):
    """GELU through :func:`_erf`; within ~1.5e-7 of the exact-erf GELU."""
    xf = x.float()
    return (0.5 * xf * (1.0 + _erf(xf * 0.7071067811865476))).to(x.dtype)


_INV_SQRT_2PI = 0.3989422804014327


def _gelu_grad(z):
    """d/dz [z * Phi(z)] = Phi(z) + z * phi(z), Phi through :func:`_erf`
    (the JAX tail's GELU', evaluated in fp32)."""
    zf = z.float()
    phi = torch.exp(-0.5 * zf * zf) * _INV_SQRT_2PI
    cdf = 0.5 * (1.0 + _erf(zf * 0.7071067811865476))
    return cdf + zf * phi


# --------------------------------------------------------------------------
# Static plan
# --------------------------------------------------------------------------
@lru_cache(maxsize=256)
def _union_blocks(sparse) -> tuple:
    """Sorted distinct (py, px, gin) blocks over every output group's taps:
    the K axis a packed layer's output rows read from. For the HNeRV head
    (k=3, f=4) that is 36 blocks of cin_o channels against 144 dense."""
    _, _, _, qtaps = sparse
    return tuple(sorted({blk for taps in qtaps for blk in taps}))


@dataclasses.dataclass(frozen=True)
class TailLayer:
    cin: int            # packed input channels, padded to 8
    cout: int           # packed output channels, padded to 8
    side: int           # packed kernel size kp (taps per axis)
    off: int            # left tap offset offp (packed_kernel_geometry)
    gelu_in: bool       # input is a pre-activation -> apply GELU in-kernel
    # zero-structure (k_orig, cin_o, cout_o, qtaps) of a layer packed with
    # f >= 2 (packed_decode.packed_sparse_taps), for the kernel and its convT
    # (the JAX plan's fields; the convT's is the backward's)
    sparse: tuple | None = None
    sparse_t: tuple | None = None

    @property
    def taps(self) -> int:
        return self.side * self.side

    def transposed(self) -> "TailLayer":
        """Geometry of the convT (dx) pass: channels swapped, tap offset
        mirrored (tap reversal <=> negated shifts), the convT's zero
        structure as its own."""
        return TailLayer(cin=self.cout, cout=self.cin, side=self.side,
                         off=self.side - 1 - self.off, gelu_in=False,
                         sparse=self.sparse_t, sparse_t=self.sparse)


@dataclasses.dataclass(frozen=True)
class TailPlan:
    h: int              # tail grid height (without border)
    w: int              # tail grid width
    pad: int            # border width P = max tap reach over layers
    tm: int             # Mp is padded to a multiple of it
    layers: Tuple[TailLayer, ...]

    @property
    def hp(self) -> int:
        return self.h + 2 * self.pad

    @property
    def wp(self) -> int:
        return self.w + 2 * self.pad

    @property
    def mp(self) -> int:
        return -(-self.hp * self.wp // self.tm) * self.tm

    def shifts(self, layer: TailLayer) -> Tuple[int, ...]:
        return tuple((ty - layer.off) * self.wp + (tx - layer.off)
                     for ty in range(layer.side) for tx in range(layer.side))


@lru_cache(maxsize=64)
def _mask_np(h: int, w: int, pad: int, mp: int) -> np.ndarray:
    """(1, 1, mp) float mask: 1 at interior positions of the padded grid."""
    hp, wp = h + 2 * pad, w + 2 * pad
    m = np.zeros(mp, np.float32)
    rows = np.arange(hp * wp) // wp
    cols = np.arange(hp * wp) % wp
    m[:hp * wp] = ((rows >= pad) & (rows < pad + h)
                   & (cols >= pad) & (cols < pad + w))
    return m.reshape(1, 1, mp)


def border_mask(plan: TailPlan, dtype=torch.float32, ch: int | None = None,
                device=None):
    """Validity mask (1, C, Mp) of the packed head output: spatial borders
    and flat padding are zero; with `ch` (the real packed channel count) the
    pad rows >= ch are zero too."""
    m = torch.as_tensor(_mask_np(plan.h, plan.w, plan.pad, plan.mp),
                        device=device).to(dtype)
    if ch is None or ch == _r8(ch):
        return m
    rows = torch.arange(_r8(ch), device=device)[None, :, None] < ch
    return m * rows.to(dtype)


# --------------------------------------------------------------------------
# Layout converters
# --------------------------------------------------------------------------
def nhwc_to_cf(x, plan: TailPlan):
    """(B, H, W, C) -> (B, C8, Mp) channels-first flat with zero borders."""
    b, h, w, c = x.shape
    assert (h, w) == (plan.h, plan.w), (tuple(x.shape), plan)
    p = plan.pad
    x = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p, 0, _r8(c) - c))
    x = x.reshape(b, _r8(c), plan.hp * plan.wp)
    return F.pad(x, (0, plan.mp - plan.hp * plan.wp))


def cf_to_nhwc(z, plan: TailPlan, c: int):
    """(B, C8, Mp) -> (B, H, W, C): slice interior + de-flatten."""
    b, p = z.shape[0], plan.pad
    z = z[:, :c, :plan.hp * plan.wp].reshape(b, c, plan.hp, plan.wp)
    return z[:, :, p:p + plan.h, p:p + plan.w].permute(0, 2, 3, 1)


def _launch(name: str, fn, *args) -> None:
    """Call a kernel's C launcher on the current stream; raise on a launch
    error; count the launch."""
    from neuroquant_tpu_torch.ops import _cuda

    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: "
                           f"{_cuda.error_string(rc)} ({rc})")
    KERNEL_LAUNCHES[name] += 1


def _check(t, name: str, shape, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _route(x, name: str) -> bool:
    """True -> run the kernel (CUDA tensor); False -> the plain version (CPU
    tensor); anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


# --------------------------------------------------------------------------
# Kernels 1 and 2: pack_cf and its backward, unpack_cf
# --------------------------------------------------------------------------
def pack_cf_ref(x, plan: TailPlan):
    """Plain version of :func:`pack_cf` (the JAX ``nhwc_to_cf``)."""
    return nhwc_to_cf(x, plan)


def _pack_cf_kernel(x, plan: TailPlan):
    if not _route(x, "pack_cf"):
        return pack_cf_ref(x, plan)
    from neuroquant_tpu_torch.ops import _cuda

    b, h, w, c = x.shape
    _check(x, "pack_cf x", (b, plan.h, plan.w, c))
    out = torch.empty((b, _r8(c), plan.mp), dtype=x.dtype, device=x.device)
    _launch("pack_cf", _cuda.lib().nq_pack_cf, x.data_ptr(), out.data_ptr(),
            b, h, w, c, _r8(c), plan.pad, plan.mp)
    return out


def unpack_cf_ref(g, plan: TailPlan, c: int):
    """Plain version of :func:`unpack_cf` (the JAX ``pack_cf`` backward)."""
    return cf_to_nhwc(g, plan, c).contiguous()


def unpack_cf(g, plan: TailPlan, c: int):
    """Channels-first (B, C8, Mp) -> NHWC (B, h, w, c): the interior, the
    channel pad dropped, in one pass. The transpose of :func:`pack_cf`."""
    if not _route(g, "unpack_cf"):
        return unpack_cf_ref(g, plan, c)
    from neuroquant_tpu_torch.ops import _cuda

    b, c8, _ = g.shape
    if c > c8:
        raise ValueError(f"unpack_cf: {c} channels from {c8} rows")
    _check(g, "unpack_cf g", (b, c8, plan.mp))
    out = torch.empty((b, plan.h, plan.w, c), dtype=g.dtype, device=g.device)
    _launch("unpack_cf", _cuda.lib().nq_unpack_cf, g.data_ptr(),
            out.data_ptr(), b, plan.h, plan.w, c, c8, plan.pad, plan.mp)
    return out


class _PackCF(torch.autograd.Function):
    """pack_cf is linear; its backward is the transpose, unpack_cf."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.c = plan, x.shape[-1]
        return _pack_cf_kernel(x, plan)

    @staticmethod
    def backward(ctx, g):
        return unpack_cf(g.contiguous(), ctx.plan, ctx.c), None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def pack_cf(x, plan: TailPlan):
    """NHWC (B, h, w, C) fp32 -> channels-first (B, C8, Mp) with the border
    ring, channel pad and flat tail pad written as zeros, in one pass."""
    if _needs_grad(x):
        return _PackCF.apply(x, plan)
    return _pack_cf_kernel(x, plan)


# --------------------------------------------------------------------------
# Kernels 3 and 4: tail_conv_cf and tail_conv_dw_cf
# --------------------------------------------------------------------------
K_TILE = 16     # the conv kernel's K step; the K list pads to a multiple


def _k_blocks(plan: TailPlan, layer: TailLayer, union: bool | None = None):
    """The conv's K axis as (flat shift, tap index, cin offset, cin length)
    blocks: the dense taps for an f=1 layer, the union of nonzero blocks
    for a layer packed with f >= 2 (``union=False`` forces dense)."""
    if union is None:
        union = layer.sparse is not None
    if not union:
        return tuple((s, t, 0, layer.cin)
                     for t, s in enumerate(plan.shifts(layer)))
    cin_o = layer.sparse[1]
    return tuple(((py - layer.off) * plan.wp + (px - layer.off),
                  py * layer.side + px, gin * cin_o, cin_o)
                 for (py, px, gin) in _union_blocks(layer.sparse))


@lru_cache(maxsize=64)
def _k_rows(blocks, cin: int, taps: int):
    """Per K row, padded to a multiple of K_TILE: (flat shift, input channel
    or -1, row of the (taps*cin + 1, cout) weight matrix; its last row is
    zero)."""
    shift, chan, wrow = [], [], []
    for s, t, lo, n in blocks:
        shift += [s] * n
        chan += list(range(lo, lo + n))
        wrow += [t * cin + c for c in range(lo, lo + n)]
    pad = -len(shift) % K_TILE
    shift += [0] * pad
    chan += [-1] * pad
    wrow += [taps * cin] * pad
    return (np.asarray(shift, np.int32), np.asarray(chan, np.int32),
            np.asarray(wrow, np.int64))


@lru_cache(maxsize=64)
def _k_rows_on(blocks, cin: int, taps: int, device: str):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _k_rows(blocks, cin, taps))


def _w_operand(kk, wrow):
    """(K, cout) weight rows gathered from the canonical (side, side, cin,
    cout) kernel; padded K rows read a zero row."""
    cout = kk.shape[-1]
    w2 = torch.cat([kk.reshape(-1, cout), kk.new_zeros(1, cout)])
    return w2[wrow]


def conv_w_operand(kk, plan: TailPlan, layer: TailLayer):
    """The kernel's weight operand: the (K rows, cout) rows of `kk` that the
    layer's K list reads, contiguous. :func:`conv_cf` gathers it on every
    call unless it is given one made here once."""
    _, _, wrow = _k_rows_on(_k_blocks(plan, layer), layer.cin, layer.taps,
                            str(kk.device))
    return _w_operand(kk, wrow).contiguous()


def _im2col(x, plan: TailPlan, blocks):
    """(B, K, Mp): row k is channel chan[k] of x shifted by shift[k], zero
    outside [0, Mp)."""
    g = max(abs(s) for s, _, _, _ in blocks)
    xt = F.pad(x, (g, g))
    return torch.cat([xt[:, lo:lo + n, g + s:g + s + plan.mp]
                      for s, _, lo, n in blocks], dim=1)


def _wrows(blocks, cin: int, device):
    """Row of the flat (taps*cin, cout) kernel that each K row reads."""
    return torch.as_tensor(np.concatenate(
        [t * cin + np.arange(lo, lo + n) for _, t, lo, n in blocks]),
        device=device)


def conv_cf_ref(x, kk, bias, plan: TailPlan, layer: TailLayer,
                emit: str = "z", act_in: bool = False, blocks=None,
                out_mul=None):
    """Plain version of :func:`conv_cf` (the JAX ``_conv_cf_jnp``): im2col
    over the K blocks (dense taps by default) and one matmul."""
    if act_in:
        x = _gelu(x)
    if blocks is None:
        blocks = _k_blocks(plan, layer, union=False)
    pats = _im2col(x, plan, blocks)                          # (B, K, Mp)
    wrow = _wrows(blocks, layer.cin, x.device)
    acc = torch.matmul(_w_operand(kk, wrow).T.float(), pats.float())
    if bias is not None:
        acc = acc + bias.float()[None]
    if out_mul is not None:
        acc = acc * _gelu_grad(out_mul)
    acc = acc * border_mask(plan, torch.float32, device=x.device)
    if emit == "y":
        return _gelu(acc).to(x.dtype)
    if emit != "z":
        raise ValueError(f"emit={emit!r} (use 'z' or 'y')")
    return acc.to(x.dtype)


def conv_cf(x, kk, bias, plan: TailPlan, layer: TailLayer,
            emit: str = "z", act_in: bool = False, w_op=None, out_mul=None):
    """One channels-first conv layer: x (B, cin, Mp) -> the masked
    pre-activation 'z' (B, cout, Mp) or its activation 'y' = gelu(z).
    act_in applies GELU to the input as it is read. kk is the canonical
    (side, side, cin, cout) kernel, bias (cout, 1) or None; w_op, if
    given, is ``conv_w_operand(kk, plan, layer)`` made beforehand.
    out_mul (B, cout, Mp), the backward's dx epilogue, multiplies z by
    GELU'(out_mul) before the border mask (the JAX order)."""
    blocks = _k_blocks(plan, layer)
    if not _route(x, "tail_conv_cf"):
        return conv_cf_ref(x, kk, bias, plan, layer, emit, act_in, blocks,
                           out_mul)
    from neuroquant_tpu_torch.ops import _cuda

    if emit not in ("z", "y"):
        raise ValueError(f"emit={emit!r} (use 'z' or 'y')")
    b = x.shape[0]
    _check(x, "tail_conv_cf x", (b, layer.cin, plan.mp))
    _check(kk, "tail_conv_cf kk", (layer.side, layer.side, layer.cin,
                                   layer.cout))
    if bias is not None:
        _check(bias, "tail_conv_cf bias", (layer.cout, 1))
    if out_mul is not None:
        _check(out_mul, "tail_conv_cf out_mul", (b, layer.cout, plan.mp))
    if plan.mp % 128:
        raise ValueError(f"tail_conv_cf: Mp={plan.mp} is not a multiple "
                         f"of 128")
    kshift, kchan, _ = _k_rows_on(blocks, layer.cin, layer.taps,
                                  str(x.device))
    if w_op is None:
        w_op = conv_w_operand(kk, plan, layer)
    _check(w_op, "tail_conv_cf w_op", (kshift.shape[0], layer.cout))
    out = torch.empty((b, layer.cout, plan.mp), dtype=x.dtype,
                      device=x.device)
    _launch("tail_conv_cf", _cuda.lib().nq_tail_conv_cf, x.data_ptr(),
            w_op.data_ptr(), 0 if bias is None else bias.data_ptr(),
            0 if out_mul is None else out_mul.data_ptr(),
            kshift.data_ptr(), kchan.data_ptr(), out.data_ptr(), b,
            layer.cin, layer.cout, plan.mp, int(kshift.shape[0]), plan.h,
            plan.w, plan.pad, int(act_in), int(emit == "y"))
    return out


def _scatter_dw(dw, wrow, layer: TailLayer):
    """(K rows, cout) dW in the K-row layout -> the canonical (side, side,
    cin, cout) kernel's gradient: each K row lands on the kernel row it
    reads, padded K rows on a dropped extra row. The rows of a union block
    that an output group does not read land on canonical positions that
    are structurally zero, which the packing gather's backward never reads
    (the argument of the JAX ``_op_to_kk_grad``)."""
    n = layer.taps * layer.cin
    dkk = dw.new_zeros((n + 1, dw.shape[1])).index_add_(0, wrow, dw)
    return dkk[:n].reshape(layer.side, layer.side, layer.cin, dw.shape[1])


def conv_cf_dw_ref(x, g, plan: TailPlan, layer: TailLayer,
                   act_in: bool = False, blocks=None):
    """Plain version of :func:`conv_cf_dw`: im2col over the K blocks (dense
    taps by default, the JAX ``_conv_cf_dw_jnp``) and one matmul."""
    if act_in:
        x = _gelu(x)
    if blocks is None:
        blocks = _k_blocks(plan, layer, union=False)
    pats = _im2col(x, plan, blocks).float()                  # (B, K, Mp)
    dw = torch.einsum("bkm,bcm->kc", pats, g.float())
    db = g.float().sum(dim=(0, 2)).reshape(-1, 1)
    return _scatter_dw(dw, _wrows(blocks, layer.cin, x.device), layer), db


@lru_cache(maxsize=64)
def _dw_rows_on(blocks, cin: int, taps: int, device: str):
    """The dW kernel's rows: the conv's K list plus one row of ones (chan
    -2), whose sum over positions is db."""
    shift, chan, wrow = _k_rows(blocks, cin, taps)
    return (torch.as_tensor(np.append(shift, 0).astype(np.int32),
                            device=device),
            torch.as_tensor(np.append(chan, -2).astype(np.int32),
                            device=device),
            torch.as_tensor(wrow, device=device))


DW_TILE = 64        # the dW kernel's output tile: 64 K rows x 64 channels
DW_STEP = 32        # positions per shared-memory stage; chunks align to it
_DW_BLOCKS = 528    # aim for ~4 waves of blocks over the H100's 132 SMs


def _dw_split(nk: int, cout: int, positions: int) -> Tuple[int, int]:
    """(splits, chunk): the B*Mp positions cut into `splits` chunks of
    `chunk` positions (a multiple of DW_STEP), one per block of the grid's
    third axis, so that a layer with few output tiles still fills the
    card."""
    tiles = -(-nk // DW_TILE) * -(-cout // DW_TILE)
    splits = max(1, min(-(-_DW_BLOCKS // tiles), positions // 1024))
    chunk = -(-positions // splits)
    chunk = -(-chunk // DW_STEP) * DW_STEP
    return -(-positions // chunk), chunk


def conv_cf_dw(x, g, plan: TailPlan, layer: TailLayer,
               act_in: bool = False):
    """dW and db of one layer: x its input (B, cin, Mp), g the cotangent of
    its output (B, cout, Mp), border-masked -> (dkk (side, side, cin, cout),
    db (cout, 1)), fp32. act_in applies GELU to x as it is read (the
    residuals are pre-activations). The sum runs over the layer's K list
    (union-sparse for f >= 2), as the forward does, and is scattered back
    to the canonical kernel (:func:`_scatter_dw`)."""
    blocks = _k_blocks(plan, layer)
    if not _route(x, "tail_conv_dw_cf"):
        return conv_cf_dw_ref(x, g, plan, layer, act_in, blocks)
    from neuroquant_tpu_torch.ops import _cuda

    b = x.shape[0]
    _check(x, "tail_conv_dw_cf x", (b, layer.cin, plan.mp))
    _check(g, "tail_conv_dw_cf g", (b, layer.cout, plan.mp))
    if plan.mp % DW_STEP:
        raise ValueError(f"tail_conv_dw_cf: Mp={plan.mp} is not a multiple "
                         f"of {DW_STEP}")
    kshift, kchan, wrow = _dw_rows_on(blocks, layer.cin, layer.taps,
                                      str(x.device))
    nk = int(kshift.shape[0])
    splits, chunk = _dw_split(nk, layer.cout, b * plan.mp)
    # per-split partial sums, added in a fixed order by the second pass:
    # the result is the same from run to run
    part = torch.empty((splits, nk, layer.cout), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((nk, layer.cout), dtype=torch.float32, device=x.device)
    _launch("tail_conv_dw_cf", _cuda.lib().nq_tail_conv_dw_cf, x.data_ptr(),
            g.data_ptr(), kshift.data_ptr(), kchan.data_ptr(),
            part.data_ptr(), out.data_ptr(), b, layer.cin, layer.cout,
            plan.mp, nk, splits, chunk, int(act_in))
    return (_scatter_dw(out[:nk - 1], wrow, layer),
            out[nk - 1].reshape(layer.cout, 1))


def conv_cf_flops(plan: TailPlan, layer: TailLayer, batch: int = 1,
                  cin: int | None = None, cout: int | None = None) -> int:
    """Useful FLOPs of one conv_cf call: 2 x interior positions x the
    nonzero MACs per position between the real channels (`cin`, `cout`:
    unpacked channel counts of an f=1 layer; a packed layer's come from
    its sparse structure). Equals the unpacked conv's FLOPs."""
    if layer.sparse is not None:
        k_o, cin_o, cout_o, qtaps = layer.sparse
        macs = len(qtaps) * k_o * k_o * cin_o * cout_o
    else:
        macs = layer.taps * (cin or layer.cin) * (cout or layer.cout)
    return 2 * batch * plan.h * plan.w * macs


# --------------------------------------------------------------------------
# Fused tail, forward and backward
# --------------------------------------------------------------------------
def _kk_transpose(kk):
    """Canonical kernel of the convT (dx) pass: both tap axes reversed, the
    channel axes swapped."""
    return kk.flip(0, 1).permute(0, 1, 3, 2)


class _TailApply(torch.autograd.Function):
    """``tail_apply`` with its gradient: the JAX ``_tail_apply_fwd`` /
    ``_tail_apply_bwd``.

    The forward keeps residuals: every layer emits its pre-activation z,
    and the next layer applies GELU to it as it reads it (act_in). The
    backward masks the cotangent once and walks the layers from the last:
    dW/db from the saved input (GELU applied as it is read), then dx by the
    same conv kernel on ``_kk_transpose(kk)`` and ``layer.transposed()``,
    with GELU'(the saved input) as the epilogue where the layer applied
    GELU to its input. Gradients are for the canonical kernels: each
    reaches its kk once, and autograd takes it through the packing gather
    back to the raw weights."""

    @staticmethod
    def forward(ctx, plan, w_ops, n, x_cf, *params):
        kks, biases = params[:n], params[n:]
        h, residuals = x_cf, [x_cf]
        for li, layer in enumerate(plan.layers):
            h = conv_cf(h, kks[li], biases[li], plan, layer, emit="z",
                        act_in=layer.gelu_in,
                        w_op=None if w_ops is None else w_ops[li])
            if li < n - 1:
                residuals.append(h)
        ctx.save_for_backward(*residuals, *kks)
        ctx.plan, ctx.n = plan, n
        ctx.has_bias = tuple(bb is not None for bb in biases)
        return h

    @staticmethod
    def backward(ctx, g_out):
        plan, n = ctx.plan, ctx.n
        saved = ctx.saved_tensors
        residuals, kks = saved[:n], saved[n:]
        g = (g_out * border_mask(plan, g_out.dtype,
                                 device=g_out.device)).contiguous()
        dkks, dbs = [None] * n, [None] * n
        for li in range(n - 1, -1, -1):
            layer, x_in = plan.layers[li], residuals[li]
            dkks[li], db = conv_cf_dw(x_in, g, plan, layer,
                                      act_in=layer.gelu_in)
            dbs[li] = db if ctx.has_bias[li] else None
            if li == 0 and not ctx.needs_input_grad[3]:
                g = None
                break
            g = conv_cf(g, _kk_transpose(kks[li]).contiguous(), None, plan,
                        layer.transposed(),
                        out_mul=x_in if layer.gelu_in else None)
        return (None, None, None, g, *dkks, *dbs)


def tail_apply(plan: TailPlan, x_cf, kks, biases, w_ops=None):
    """Run the fused tail: x_cf (B, C0_8, Mp) -> pre-activation head output
    (B, C_last_8, Mp) with zero borders. w_ops: per layer, the prepared
    ``conv_w_operand``, or None to gather them here.

    With no gradient wanted (decode), every layer followed by a GELU emits
    gelu(z), what the next one consumes; the head emits z. When an input
    requires a gradient it runs as :class:`_TailApply`, which keeps the
    pre-activations for its backward."""
    if _needs_grad(x_cf, *kks, *biases):
        return _TailApply.apply(plan, w_ops, len(kks), x_cf, *kks, *biases)
    h = x_cf
    for li, layer in enumerate(plan.layers):
        last = li == len(plan.layers) - 1
        next_act = not last and plan.layers[li + 1].gelu_in
        h = conv_cf(h, kks[li], biases[li], plan, layer,
                    emit="y" if next_act else "z",
                    w_op=None if w_ops is None else w_ops[li])
    return h


# --------------------------------------------------------------------------
# Plan building + weight packing
# --------------------------------------------------------------------------
@lru_cache(maxsize=64)
def _make_plan(h: int, w: int, geoms: Tuple, tm: int) -> TailPlan:
    pad = max(max(off, side - 1 - off) for side, off, *_ in geoms)
    layers = []
    for li, (side, off, cin_raw, cout_raw, spp) in enumerate(geoms):
        sparse = sparse_t = None
        if spp is not None:
            k_o, cin_o, cout_o, qt_fwd, qt_t = spp
            sparse = (k_o, cin_o, cout_o, qt_fwd)
            sparse_t = (k_o, cout_o, cin_o, qt_t)
        layers.append(TailLayer(
            cin=_r8(cin_raw), cout=_r8(cout_raw), side=side, off=off,
            gelu_in=li > 0, sparse=sparse, sparse_t=sparse_t))
    return TailPlan(h=h, w=w, pad=pad, tm=tm, layers=tuple(layers))


def _pad_kk(kk, cin8: int, cout8: int):
    return F.pad(kk, (0, cout8 - kk.shape[3], 0, cin8 - kk.shape[2]))


def _sparse_spec(k, ff, prm, cin_o, cout_o):
    """(k, cin_o, cout_o, qtaps_fwd, qtaps_t) of an f>=2-packed layer."""
    key = tuple(int(v) for v in prm) if prm is not None else None
    qt_fwd, qt_t = packed_sparse_taps(int(k), int(ff), key)
    return (int(k), int(cin_o), int(cout_o), qt_fwd, qt_t)


def _auto_tm(h: int, w: int) -> int:
    return 2048 if h * w >= 16384 else (512 if h * w >= 4096 else 128)


def plan_geometry(h: int, w: int, block_geoms, head_geom, tm: int = 0):
    """TailPlan from shapes alone: block_geoms [(k, cin, cout*r*r, r), ...]
    mirror plan_and_pack's blocks, head_geom is (k, cin, cout). Returns
    (plan, f_final)."""
    tm = tm or _auto_tm(h, w)
    f, perm = 1, None
    geoms = []
    for (k, cin, cout_rr, r) in block_geoms:
        k, cin, cout_rr, r = int(k), int(cin), int(cout_rr), int(r)
        if f == 1:
            geoms.append((k, (k - 1) // 2, cin, cout_rr, None))
        else:
            kp, off = packed_kernel_geometry(k, f)
            geoms.append((kp, off, cin * f * f, cout_rr * f * f,
                          _sparse_spec(k, f, perm, cin, cout_rr)))
        perm = compose_shuffle_perm(identity_perm(f), f, r)
        f *= r
    kh, cin_h, cout_h = (int(v) for v in head_geom)
    kp, off = packed_kernel_geometry(kh, f)
    geoms.append((kp, off, cin_h * f * f, cout_h * f * f,
                  _sparse_spec(kh, f, perm, cin_h, cout_h)))
    return _make_plan(h, w, tuple(geoms), tm), f


def _relabel(w_hwio, bias, r: int):
    """Relabel a conv's output channels shuffle-subposition-major, so its
    output is the r-packed form of the shuffled tensor."""
    kh, kw, cin, cout_rr = w_hwio.shape
    cout = cout_rr // (r * r)
    wrel = (w_hwio.reshape(kh, kw, cin, cout, r, r)
            .permute(0, 1, 2, 4, 5, 3).reshape(kh, kw, cin, cout_rr))
    brel = None
    if bias is not None:
        brel = bias.reshape(cout, r, r).permute(1, 2, 0).reshape(-1)
    return wrel, brel


def plan_and_pack(h: int, w: int, blocks, head, tm: int = 0):
    """Static TailPlan + per-layer canonical kernels for a decoder tail
    entered unpacked at resolution (h, w).

    blocks: [(w_hwio (k, k, cin, cout*r*r), bias (cout*r*r,) | None, r)]
        the tail NeRVBlock convs from the pack start on (conv ->
        PixelShuffle(r) -> GELU);
    head:   (w_hwio (k, k, cin, c_out), bias | None), the final conv.

    Returns (plan, kks, biases, f_final, head_cout_packed): kks padded to
    (side, side, cin8, cout8), biases (cout8, 1) or None.
    """
    tm = tm or _auto_tm(h, w)
    f, perm = 1, None
    kks, bbs, geoms = [], [], []
    for (w_hwio, bias, r) in blocks:
        kh, kw, cin, cout_rr = w_hwio.shape
        assert kh == kw and kh % 2 == 1, tuple(w_hwio.shape)
        wrel, brel = _relabel(w_hwio, bias, r)
        if f == 1:
            kk, off, spp = wrel, (kh - 1) // 2, None
        else:
            kk = pack_conv_kernel(wrel, f, in_perm=perm)
            _, off = packed_kernel_geometry(kh, f)
            spp = _sparse_spec(kh, f, perm, cin, cout_rr)
            if brel is not None:
                brel = brel.repeat(f * f)
        kks.append(kk)
        bbs.append(brel)
        geoms.append((kk.shape[0], off, kk.shape[2], kk.shape[3], spp))
        perm = compose_shuffle_perm(identity_perm(f), f, r)
        f *= r
    wh, bh = head
    khh = wh.shape[0]
    kk = pack_conv_kernel(wh, f, in_perm=perm)
    _, off = packed_kernel_geometry(khh, f)
    kks.append(kk)
    bbs.append(bh.repeat(f * f) if bh is not None else None)
    geoms.append((kk.shape[0], off, kk.shape[2], kk.shape[3],
                  _sparse_spec(khh, f, perm, wh.shape[2], wh.shape[3])
                  if f > 1 else None))

    plan = _make_plan(h, w, tuple(geoms), tm)
    kks_p, bms = [], []
    for kk, bb, layer in zip(kks, bbs, plan.layers):
        kks_p.append(_pad_kk(kk, layer.cin, layer.cout).contiguous())
        bms.append(F.pad(bb, (0, layer.cout - bb.shape[0]))
                   .reshape(layer.cout, 1) if bb is not None else None)
    return plan, tuple(kks_p), tuple(bms), f, kks[-1].shape[3]


# --------------------------------------------------------------------------
# Kernel 5: unpack_frames
# --------------------------------------------------------------------------
_OUT_MODES = {"sigmoid": 0, "tanh": 1}


def out_img(x, out_bias: str = "tanh"):
    """The output head's bias: sigmoid, tanh*0.5+0.5, or + a float offset
    (``models.layers.out_img``)."""
    if out_bias == "sigmoid":
        return torch.sigmoid(x)
    if out_bias == "tanh":
        return torch.tanh(x) * 0.5 + 0.5
    return x + float(out_bias)


def unpack_frames_ref(z, plan: TailPlan, f: int, ch: int, out_bias: str):
    """Plain version of :func:`unpack_frames` (the JAX ``_unpack_jnp``)."""
    return depth_to_space(out_img(cf_to_nhwc(z, plan, ch), out_bias), f)


def _unpack_frames_kernel(z, plan: TailPlan, f: int, ch: int, out_bias: str):
    if not _route(z, "unpack_frames"):
        return unpack_frames_ref(z, plan, f, ch, out_bias)
    from neuroquant_tpu_torch.ops import _cuda

    b, cp, _ = z.shape
    c = ch // (f * f)
    if c * f * f != ch or ch > cp:
        raise ValueError(f"unpack_frames: {ch} channels do not unpack by "
                         f"f={f} from {cp} packed rows")
    _check(z, "unpack_frames z", (b, cp, plan.mp))
    mode = _OUT_MODES.get(out_bias, 2)
    offset = 0.0 if mode < 2 else float(out_bias)
    out = torch.empty((b, plan.h * f, plan.w * f, c), dtype=z.dtype,
                      device=z.device)
    _launch("unpack_frames", _cuda.lib().nq_unpack_frames, z.data_ptr(),
            out.data_ptr(), b, cp, plan.mp, plan.h, plan.w, plan.pad, f, c,
            mode, offset)
    return out


class _UnpackFrames(torch.autograd.Function):
    """unpack_frames with the VJP of its plain version as its backward
    (the JAX ``_unpack_frames_bwd``)."""

    @staticmethod
    def forward(ctx, z, plan, f, ch, out_bias):
        ctx.save_for_backward(z)
        ctx.args = (plan, f, ch, out_bias)
        return _unpack_frames_kernel(z, plan, f, ch, out_bias)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        with torch.enable_grad():
            zz = z.detach().requires_grad_()
            (dz,) = torch.autograd.grad(unpack_frames_ref(zz, *ctx.args),
                                        zz, g)
        return dz, None, None, None, None


def unpack_frames(z, plan: TailPlan, f: int, ch: int, out_bias: str):
    """Head output z (B, Cp, Mp) -> frames (B, h*f, w*f, ch/f^2): interior
    slice, out_img, depth-to-space, in one pass."""
    if _needs_grad(z):
        return _UnpackFrames.apply(z, plan, f, ch, out_bias)
    return _unpack_frames_kernel(z, plan, f, ch, out_bias)


# --------------------------------------------------------------------------
# Model-facing entry points
# --------------------------------------------------------------------------
def resolve_impl(fused_tail: str) -> str | None:
    """cfg 'fused_tail' knob -> 'fused' (the channels-first tail on the
    kernels) or None (the unpacked decode). The JAX values 'pallas',
    'pallas_hvp' and 'jnp' name TPU implementations of the same function
    and select the fused tail here."""
    ft = str(fused_tail).lower()
    if ft in ("off", "false", "none", "xla"):
        return None
    if ft in ("auto", "pallas", "jnp", "pallas_hvp", "fused"):
        return "fused"
    raise ValueError(
        f"fused_tail={fused_tail!r} (use auto|pallas|pallas_hvp|jnp|off)")


class TailWeights(NamedTuple):
    """A channels-first plan with its weights in the layouts the kernels
    read. Packing them is per model, not per decode: ``HNeRV`` keeps one
    until its weights change."""
    plan: TailPlan
    kks: tuple          # canonical (side, side, cin8, cout8) kernels
    biases: tuple       # (cout8, 1) or None
    f: int              # packing factor of the last layer's output
    ch: int             # its real packed channel count
    w_ops: tuple | None  # per-layer conv_w_operand on the GPU, else None


def _with_w_ops(plan, kks, biases, f, ch) -> TailWeights:
    """The weights with their conv operands gathered (on the GPU; the
    plain versions gather their own). The operands carry no graph: a
    gradient reaches the weights through ``kks``."""
    w_ops = None
    if kks[0].device.type == "cuda":
        with torch.no_grad():
            w_ops = tuple(conv_w_operand(kk, plan, layer)
                          for kk, layer in zip(kks, plan.layers))
    return TailWeights(plan, tuple(kks), tuple(biases), f, ch, w_ops)


def prepare_tail(h: int, w: int, blocks, head, tm: int = 0) -> TailWeights:
    """:func:`plan_and_pack`, plus the kernels' weight operands on the GPU."""
    return _with_w_ops(*plan_and_pack(h, w, blocks, head, tm=tm))


def run_fused_tail_frames(x, wts: TailWeights, out_bias: str):
    """NHWC input x at the tail-entry resolution -> full-resolution frames
    (B, H, W, C): pack_cf, one tail_conv_cf per layer, unpack_frames. The
    JAX function takes the raw (blocks, head) and packs them every call;
    here the caller passes them packed once (:func:`prepare_tail`)."""
    z = tail_apply(wts.plan, pack_cf(x.contiguous(), wts.plan), wts.kks,
                   wts.biases, wts.w_ops)
    return unpack_frames(z, wts.plan, wts.f, wts.ch, out_bias)


def run_fused_tail_cf(x, wts: TailWeights):
    """Like :func:`run_fused_tail_frames` but stays channels-first: returns
    (z_cf (B, ch8, Mp), plan, ch, f), so that a loss can be computed in the
    packed flat domain against :func:`pack_targets` (the depth-to-space is
    a permutation, so a sum of elementwise losses does not change)."""
    z = tail_apply(wts.plan, pack_cf(x.contiguous(), wts.plan), wts.kks,
                   wts.biases, wts.w_ops)
    return z, wts.plan, wts.ch, wts.f


def pack_targets(frames, plan: TailPlan, f: int):
    """Ground-truth frames (N, H, W, C) -> (N, ch8, Mp), the layout of the
    fused head output (identity groups, zero borders). Set-up work, once
    per clip, so plain tensor ops."""
    return nhwc_to_cf(space_to_depth(frames, f), plan)


@lru_cache(maxsize=64)
def _prefix_plan(h: int, w: int, k: int, cin: int, cout_rr: int):
    geoms = ((k, (k - 1) // 2, cin, cout_rr, None),)
    tm = 512 if h * w >= 2048 else _auto_tm(h, w)
    return _make_plan(h, w, geoms, tm)


def prepare_prefix_block(h: int, w: int, kernel, bias, r: int) -> TailWeights:
    """The last pre-tail NeRVBlock's conv (HWIO kernel, bias, shuffle r) on
    an (h, w) grid as a 1-layer channels-first plan, its output channels
    relabeled subposition-major."""
    kh, kw, cin, cout_rr = kernel.shape
    assert kh == kw
    wrel, brel = _relabel(kernel, bias, r)
    plan = _prefix_plan(h, w, kh, cin, cout_rr)
    layer = plan.layers[0]
    kk = _pad_kk(wrel, layer.cin, layer.cout).contiguous()
    bm = (None if brel is None else
          F.pad(brel, (0, layer.cout - cout_rr)).reshape(layer.cout, 1))
    return _with_w_ops(plan, (kk,), (bm,), r, cout_rr)


def run_fused_prefix_block(x, wts: TailWeights):
    """NHWC x (B, h, w, cin) -> the prefix conv's output (B, cout*r*r
    padded, Mp), pre-PixelShuffle and pre-activation. The weights come
    packed by :func:`prepare_prefix_block`, not raw as in the JAX
    function."""
    return tail_apply(wts.plan, pack_cf(x.contiguous(), wts.plan), wts.kks,
                      wts.biases, wts.w_ops)


def prefix_cf_to_nhwc(z, plan: TailPlan, r: int, out_channel: int):
    """(B, cout*r*r pad, Mp) output of run_fused_prefix_block -> NHWC
    (B, h*r, w*r, cout) PixelShuffled pre-activation, contiguous."""
    b = z.shape[0]
    hp, wp, h, w, p = plan.hp, plan.wp, plan.h, plan.w, plan.pad
    z = z[:, :out_channel * r * r, :hp * wp].reshape(b, -1, hp, wp)
    z = z[:, :, p:p + h, p:p + w].reshape(b, r, r, out_channel, h, w)
    z = z.permute(0, 4, 1, 5, 2, 3)                  # (B, h, u, w, v, c)
    return z.reshape(b, h * r, w * r, out_channel).contiguous()

