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
                       emitting z, gelu(z) or both; with the GELU' factor
                       it is the backward's dx pass  (TPU: ``_fwd_kernel``)
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

Each kernel has an fp32 and a bf16 instantiation, picked by the dtype of
the tensors it is given (any other dtype raises). The bf16 one is the TPU
kernels' own numeric contract (the JAX ``_mxu_cast`` / ``_entry_and_cast``):
bf16 activations, weights and biases, fp32 sums, every bias, GELU, GELU'
and mask applied to the fp32 sum, each layer output rounded once to bf16;
dW and db in fp32 (the Functions cast them to the weights' dtype, as
``_tail_apply_bwd`` does). ``pack_cf`` writes its output dtype from an
fp32 or bf16 input, ``unpack_cf`` and ``unpack_frames`` read bf16 and write
the dtype asked for; the weights' dtype (``prepare_tail(..., dtype=)``)
picks the tail's, and ``ops/precision.py`` says when it is bf16. A bf16
launch counts under the kernel's name with ``_bf16`` appended.

Gradients: ``tail_apply``, ``pack_cf`` and ``unpack_frames`` are
``torch.autograd.Function``s when an input requires a gradient. The tail's
backward is the JAX ``_tail_apply_bwd``: dW/db from ``tail_conv_dw_cf``,
dx from ``tail_conv_cf`` on the tap-reversed, channel-swapped kernel with
the GELU' epilogue; ``pack_cf``'s backward is ``unpack_cf``;
``unpack_frames``'s is the VJP of its plain version, as in JAX. All three
backwards are first-order: a second derivative through them raises, and
each runs in a ``tail`` span (``utils.profiling.span``).
Hessian-vector products take the forward-mode tail instead,
:func:`tail_apply_fo` (the JAX ``tail_apply_fo``): the tangent carried
layer by layer through first-order conv Functions (``conv_p``), so the
outer gradient differentiates each kernel once.

Left out as TPU scheduling: the execution modes and their cost model
(``ExecCfg``, ``_exec_cfg``, ``_SWEEP_PINS*``, ``NQ_TAIL_MODE``), the VMEM
budget and cout-row split (``_VMEM_BUDGET``, ``_split_parts``,
``_bwd_needs_split``), the halo DMA streaming, and the bf16 operand cast
(``_mxu_cast``, ``_entry_and_cast``, on the TPU always on): by default the
kernels take fp32 operands and accumulate in fp32 (the two conv kernels
multiply on the tensor cores with each fp32 operand split into two TF32
parts, three products per product, which keeps fp32 accuracy), and take
the bf16 contract only when asked. What is kept from the modes is the
union-sparse K axis of a layer packed with f >= 2 (``_union_blocks``): it
skips the kernel's structurally zero blocks, 4x fewer MACs at the HNeRV
Bunny head, in the forward, dx and dW alike. The kernels read the K axis as a list of
steps of 4 rows, each one box of x: consecutive channels at one flat shift
(``_k_steps``); the kernels on TMA (the fp32 and bf16 conv, the bf16 dW)
copy runs of steps as one box (column 3 of their lists, ``_box_plan``).

One deliberate difference from ``_tail_fwd_impl``: under a gradient a layer
followed by a GELU emits the pair (z, gelu(z)) and the next layer, and its
dW pass, read gelu(z) as it is; the JAX tail keeps z alone and applies GELU
as each kernel reads it (``act_in``, still in both kernels' contracts).
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache, partial
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from neuroquant_tpu_torch.ops import _cuda
from neuroquant_tpu_torch.ops.packed_decode import (
    compose_shuffle_perm, depth_to_space, identity_perm, pack_conv_kernel,
    packed_kernel_geometry, packed_sparse_taps, space_to_depth,
)
from neuroquant_tpu_torch.utils.profiling import span

# kernel launches per wrapper, since the last reset_launch_counts()
# (fq_uaq, fq_ada and their _bwd: ops/fused_fakequant.py's grouped forward
# and backward launches, named as that module says)
# (the bf16 instantiations under the kernel's name + "_bf16"; the fp32
# tail_conv_cf launches on the TMA and wgmma design also under
# "tail_conv_cf_wgmma")
KERNEL_LAUNCHES = {"tail_conv_cf": 0, "tail_conv_dw_cf": 0, "pack_cf": 0,
                   "unpack_cf": 0, "unpack_frames": 0, "fq_uaq": 0,
                   "fq_ada": 0, "fq_uaq_bwd": 0, "fq_ada_bwd": 0,
                   "tail_conv_cf_bf16": 0, "tail_conv_dw_cf_bf16": 0,
                   "pack_cf_bf16": 0, "unpack_cf_bf16": 0,
                   "unpack_frames_bf16": 0, "tail_conv_cf_wgmma": 0}
# the element types the kernels take, with their launchers' type codes
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the layout kernels' (input, output) dtypes: pack_cf may narrow fp32 to
# bf16 (the tail's bf16 entry), unpack_cf and unpack_frames widen back
_F32, _B16 = torch.float32, torch.bfloat16
_PACK_TYPES = ((_F32, _F32), (_F32, _B16), (_B16, _B16))
_UNPACK_TYPES = ((_F32, _F32), (_B16, _F32), (_B16, _B16))


def reset_launch_counts() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def _r8(c: int) -> int:
    return -(-int(c) // 8) * 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    pad rows >= ch are zero too. The fp32 mask is made once per geometry
    and device (:func:`_mask_on`) and may come back as that tensor: read
    it, do not write it. (Copying it from the host on every call, as every
    tail backward asks for it, would synchronise the host with the card.)"""
    m = _mask_on(plan.h, plan.w, plan.pad, plan.mp,
                 str(torch.device("cpu" if device is None else device)))
    m = m.reshape(1, 1, plan.mp).to(dtype)
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
    error; count the launch. The stream is the raw handle of the current
    device's current stream (no ``torch.cuda.Stream`` object per call)."""
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(
        torch._C._cuda_getDevice()))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: "
                           f"{_cuda.error_string(rc)} ({rc})")
    KERNEL_LAUNCHES[name] += 1


def _check(t, name: str, shape, dtype=torch.float32):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    (a tuple); the common case costs four attribute reads."""
    if (t.is_cuda and t.dtype is dtype and t.shape == shape
            and t.is_contiguous()):
        return
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    raise ValueError(f"{name}: tensor must be contiguous")


def _kernel_dtype(t, name: str):
    """t's dtype where a kernel has an instantiation for it (fp32, bf16);
    anything else raises."""
    if t.dtype not in _TYPE_CODES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got "
                        f"{t.dtype}")
    return t.dtype


def _counted(name: str, dtype) -> str:
    """The launch count's name of `name`'s instantiation for `dtype`."""
    return name if dtype is torch.float32 else name + "_bf16"


def _route(x, name: str) -> bool:
    """True -> run the kernel (CUDA tensor); False -> the plain version (CPU
    tensor); anything else raises."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def _c_ints(*values):
    """A C int array for a launcher's parameter block, and its address:
    one pointer argument where ctypes would convert each int anew."""
    arr = (ctypes.c_int * len(values))(*values)
    return arr, ctypes.addressof(arr)


# --------------------------------------------------------------------------
# Launch geometry of the three layout kernels, pack_cf, unpack_cf and
# unpack_frames. The wrappers pass it to the launchers as it is;
# tests/test_torch_layout_tiles.py holds it against a numpy emulation of each
# kernel's block -> element map.
# --------------------------------------------------------------------------
LAYOUT_THREADS = 256        # threads per block of the three kernels
LAYOUT_SMEM = 48 * 1024     # shared memory a block may take (no opt-in)
PACK_TILE_MAX = 128         # flat positions per fp32 pack_cf block, at most
UNPACK_TILE_BF16 = 320      # packed columns per tile of the bf16 unpack
# packed columns per unpack_frames block, at most: 124 and the cover's 3
# extra floats are 32 float4, one load per lane of a warp
UNPACK_TILE_MAX = 124
# g = f*c values with a compile-time instantiation of unpack_frames: the
# configs' f = 2, 3, 4, 6 at c = 3; the kernel's launcher switches on them
UNPACK_G_TEMPLATES = (6, 9, 12, 18)


class PackGeometry(NamedTuple):
    tm: int         # flat output positions per block: a power of two
    blocks: int     # grid: (blocks, batch)
    smem: int       # shared-memory bytes per block


def _pack_cf_smem(tm: int, c: int) -> int:
    """The tile's offset table (tm ints) and its staged fp32 input run
    (tm*c floats and room for the 16-byte cover)."""
    return 4 * tm + 4 * (tm * c + 8)


@lru_cache(maxsize=256)
def pack_cf_geometry(mp: int, c: int, batch: int) -> PackGeometry:
    """Tile of :func:`pack_cf`'s fp32 kernel: 128 positions, halved while
    the staged run would not fit a block's shared memory, or while the
    launch has fewer blocks than the card holds (_SM_SLOTS) and the tile is
    above 16 positions: small entries are bound by latency, not bytes."""
    tm = PACK_TILE_MAX
    while tm > 8 and (_pack_cf_smem(tm, c) > LAYOUT_SMEM or (
            tm > 16 and mp // tm * batch < _SM_SLOTS)):
        tm //= 2
    if _pack_cf_smem(tm, c) > LAYOUT_SMEM:
        raise ValueError(f"pack_cf: {c} channels do not fit a tile of "
                         f"{tm} positions in {LAYOUT_SMEM} bytes")
    if mp % tm:
        raise ValueError(f"pack_cf: Mp={mp} is not a multiple of {tm}")
    return PackGeometry(tm, mp // tm, _pack_cf_smem(tm, c))


def _pack_cf_bf16_smem(tm: int, c: int, isz: int) -> int:
    """Shared bytes of the bf16 pack_cf kernel (csrc's ``bf16_smem``): the
    mbarrier (128 bytes), the offset table (tm ints, to 128 bytes), then
    the staged run (tm*c elements of `isz` bytes and 32 for the cover), to
    128 bytes."""
    return (128 + _cdiv(4 * tm, 128) * 128
            + _cdiv(tm * c * isz + 32, 128) * 128)


@lru_cache(maxsize=256)
def pack_cf_bf16_geometry(mp: int, c: int, batch: int,
                          isz: int) -> PackGeometry:
    """Tile of :func:`pack_cf`'s kernel to bf16 (input elements of `isz`
    bytes, 4 or 2), one a block: of the tiles of 256 positions (a
    512-byte segment of each channel row) down to 16 positions that divide
    Mp and leave room for 4 blocks on an SM, the largest that gives each
    image 4 tiles per SM, else the largest that gives the launch one per
    SM (small entries are bound by latency). On an NVIDIA H100 80GB HBM3 at
    700 W, at the Bunny-3M tail entry, 64 positions took 0.0096 ms cold
    from fp32 at batch 1 and 0.0114 from bf16 at batch 2, 256 positions
    0.0108 and 0.0129 (scripts/torch_layout_bench.py --dtype bf16
    --sweep)."""
    fit = [t for t in (256, 128, 64, 32, 16)
           if not mp % t
           and _pack_cf_bf16_smem(t, c, isz) + 1024 <= SMEM_PER_SM // 4]
    tm = next((t for t in fit if mp // t >= 4 * H100_SMS), None) \
        or next((t for t in fit if mp // t * batch >= H100_SMS),
                fit[-1] if fit else 16)
    smem = _pack_cf_bf16_smem(tm, c, isz)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"pack_cf: {c} channels do not fit a tile of "
                         f"{tm} positions in {SMEM_PER_BLOCK} bytes")
    if mp % tm:
        raise ValueError(f"pack_cf: Mp={mp} is not a multiple of {tm}")
    return PackGeometry(tm, mp // tm, smem)


def _unpack_cf_table(tq: int, w: int, pad: int) -> int:
    """Ints of the fp32 unpack_cf kernel's cover table (``table_ints`` in
    the source): the tq positions' stretch of a padded row, with the 2*pad
    border columns of every row crossing, the cover's offset (< 8 floats)
    and rounding; a multiple of 4."""
    return (tq + 2 * pad * ((tq - 1) // w + 1) + 15) // 4 * 4


def _unpack_cf_smem(tq: int, w: int, pad: int, c: int) -> int:
    """The cover table and the staged fp32 output run (tq*c floats and
    room for its offset in 16 bytes)."""
    return 4 * _unpack_cf_table(tq, w, pad) + 4 * (tq * c + 4)


@lru_cache(maxsize=256)
def unpack_cf_geometry(h: int, w: int, pad: int, c: int,
                       batch: int) -> PackGeometry:
    """Tile of :func:`unpack_cf`'s fp32 kernel: positions of one image per
    block, 128 halved while the staged run would not fit a block's shared
    memory, or while the launch has fewer blocks than the card holds
    (_SM_SLOTS) and the tile is above 32 positions. Returns (tq, blocks per
    image, smem). On an NVIDIA H100 80GB HBM3 at 700 W the prefix entry
    (2,64,4096) took 0.0031 ms of device time at 32 or 64 positions, 0.0046
    at 16 and 128, 0.0063 at 8; the tail entry 0.0180 at 128, 0.0199 at 64
    (scripts/torch_layout_bench.py --sweep)."""
    tq = PACK_TILE_MAX
    while tq > 8 and (_unpack_cf_smem(tq, w, pad, c) > LAYOUT_SMEM
                      or (tq > 32 and _cdiv(h * w, tq) * batch < _SM_SLOTS)):
        tq //= 2
    if _unpack_cf_smem(tq, w, pad, c) > LAYOUT_SMEM:
        raise ValueError(f"unpack_cf: {c} channels do not fit a tile of "
                         f"{tq} positions in {LAYOUT_SMEM} bytes")
    return PackGeometry(tq, _cdiv(h * w, tq), _unpack_cf_smem(tq, w, pad, c))


def _unpack_cf_bf16_pitch(tq: int, w: int, pad: int) -> int:
    """Bytes of a staged channel row of the bf16 unpack_cf kernel (csrc's
    ``bf16_pitch``): the tq positions' stretch of a padded row with the
    2*pad border columns of every row crossing, the cover's offset (< 8
    elements), rounded to 16 bytes."""
    return 2 * ((tq + 2 * pad * ((tq - 1) // w + 1) + 14) // 8 * 8)


def _unpack_cf_bf16_row(r: int, pitch: int) -> int:
    """Byte offset of staged channel row r (csrc's ``bf16_row``): 16 bytes
    more for each 8 rows before it, against bank conflicts."""
    return r * pitch + 16 * (r >> 3)


def _unpack_cf_bf16_smem(tq: int, w: int, pad: int, c: int) -> int:
    """Shared bytes of the bf16 unpack_cf kernel (csrc's ``bf16_smem``):
    the mbarrier (16 bytes), the position table (tq + 1 ints), then from a
    128-byte boundary c staged rows with their skew."""
    return (_cdiv(16 + 4 * (tq + 1), 128) * 128
            + _unpack_cf_bf16_row(c, _unpack_cf_bf16_pitch(tq, w, pad)))


@lru_cache(maxsize=256)
def unpack_cf_bf16_geometry(h: int, w: int, pad: int, c: int,
                            batch: int) -> PackGeometry:
    """Tile of :func:`unpack_cf`'s kernel from bf16 (to fp32 or bf16), one
    a block, a multiple of 8 positions: the launch's positions cut into 4
    equal tiles per SM (every SM holds 4 blocks at once and ends with the
    others); where those tiles would be below 32 positions, one tile per SM
    (a small entry is bound by latency); where above 256, tiles of 128 in
    several waves; halved while 4 blocks would not fit an SM's shared
    memory. Returns (tq, blocks per image, smem). On an NVIDIA H100 80GB
    HBM3 at 700 W, the Bunny-3M tail entry at batch 2 (to bf16) took 0.0080
    ms hot and 0.0124 cold at 200 positions, 0.0086 / 0.0133 at 256,
    0.0094 / 0.0141 at 128, 0.0109 / 0.0156 at 64; its prefix entry
    0.0038 / 0.0046 at 56; PNeRV's c = 100 entry 0.0648 at 128, 0.0681 at
    256 (scripts/torch_layout_bench.py --dtype bf16 --sweep)."""
    total = h * w * batch
    tq = _cdiv(_cdiv(total, 4 * H100_SMS), 8) * 8
    if tq < 32:
        tq = _cdiv(_cdiv(total, H100_SMS), 8) * 8
    tq = 128 if tq > 256 else max(tq, 8)
    while tq > 8 and (_unpack_cf_bf16_smem(tq, w, pad, c) + 1024
                      > SMEM_PER_SM // 4):
        tq = _cdiv(tq // 2, 8) * 8
    smem = _unpack_cf_bf16_smem(tq, w, pad, c)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"unpack_cf: {c} channels do not fit a tile of "
                         f"{tq} positions in {SMEM_PER_BLOCK} bytes")
    return PackGeometry(tq, _cdiv(h * w, tq), smem)


class UnpackGeometry(NamedTuple):
    tx: int         # packed columns per block: a multiple of 4
    tiles: int      # grid: (tiles, h, batch * f // fu)
    fu: int         # output rows Y*f+u per block: a divisor of f
    smem: int       # shared-memory bytes per block
    g_template: int  # the instantiation's compile-time g; 0 = generic


@lru_cache(maxsize=256)
def unpack_frames_geometry(h: int, w: int, f: int, c: int,
                           batch: int) -> UnpackGeometry:
    """Block shape of :func:`unpack_frames`'s fp32 kernel: all f output
    rows and the widest span up to 124 columns whose staged channel rows
    (tx + 4 floats each, for the 16-byte cover) fit a block's shared
    memory, cut into equal spans across the width; one output row per
    block where that launch would have fewer blocks than the card holds
    (_SM_SLOTS). On an H100 one row a block took 0.63x the time of four at
    the width-tiled plan, and narrower spans took longer at every plan
    measured (scripts/torch_layout_bench.py --sweep)."""
    def widest(fu):             # a multiple of 4: staged rows round to it
        return min(UNPACK_TILE_MAX,
                   (LAYOUT_SMEM // (4 * fu * f * c) - 4) // 4 * 4)

    def span(fu):               # equal spans, each a multiple of 4
        return _cdiv(_cdiv(w, _cdiv(w, widest(fu))), 4) * 4

    fu = f
    if (widest(fu) < 4
            or _cdiv(w, span(fu)) * h * batch < _SM_SLOTS):
        fu = 1
    if widest(fu) < 4:
        raise ValueError(f"unpack_frames: {f * c} channel rows do not fit "
                         f"a block's {LAYOUT_SMEM} bytes")
    tx = span(fu)
    g = f * c
    return UnpackGeometry(tx, _cdiv(w, tx), fu,
                          4 * fu * g * (_cdiv(tx, 4) * 4 + 4),
                          g if g in UNPACK_G_TEMPLATES else 0)


def _unpack_frames_bf16_smem(rows: int, tx: int) -> int:
    """Shared bytes of the bf16 unpack_frames kernel (csrc's ``staged_row``
    and ``bf16_smem``): the mbarrier (128 bytes), then `rows` staged rows,
    each the span rounded up to 8 bf16 and 8 more for the cover, rounded up
    to 128 bytes."""
    return 128 + _cdiv(rows * (_cdiv(tx, 8) * 8 + 8) * 2, 128) * 128


@lru_cache(maxsize=256)
def unpack_frames_bf16_geometry(h: int, w: int, f: int, c: int,
                                batch: int) -> UnpackGeometry:
    """Tile of :func:`unpack_frames`'s kernel from bf16, one a block: one
    output row and a span of up to UNPACK_TILE_BF16 columns, cut into
    equal spans across the width (each a multiple of 8), halved while the
    launch has fewer tiles than half the card's SMs or the staged rows
    would not fit a block. On an NVIDIA H100 80GB HBM3 at 700 W the
    Bunny-3M decode to fp32 frames was fastest at one row and the whole
    width a tile (640 blocks: 0.0065 ms hot, 0.0093 cold), slower at two
    rows (0.0069-0.0084 hot) or narrower spans (0.0072-0.0101); the
    width-tiled plan took 0.0031-0.0033 hot at spans of 64-160 columns
    (scripts/torch_layout_bench.py --dtype bf16 --sweep). The kernel takes
    one output row a block (fu = 1)."""
    g = f * c

    def span(most):             # equal spans, each a multiple of 8
        return _cdiv(_cdiv(w, _cdiv(w, most)), 8) * 8

    most = UNPACK_TILE_BF16
    while most > 8 and (
            _unpack_frames_bf16_smem(g, span(most)) > SMEM_PER_BLOCK
            or (most > 32 and batch * f * h * _cdiv(w, span(most))
                < H100_SMS // 2)):
        most //= 2
    tx = span(most)
    smem = _unpack_frames_bf16_smem(g, tx)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"unpack_frames: {g} channel rows do not fit a "
                         f"block's {SMEM_PER_BLOCK} bytes")
    return UnpackGeometry(tx, _cdiv(w, tx), 1, smem,
                          g if g in UNPACK_G_TEMPLATES else 0)


# --------------------------------------------------------------------------
# Kernels 1 and 2: pack_cf and its backward, unpack_cf
# --------------------------------------------------------------------------
def pack_cf_ref(x, plan: TailPlan, dtype=None):
    """Plain version of :func:`pack_cf` (the JAX ``nhwc_to_cf``, then the
    cast to the output dtype)."""
    return nhwc_to_cf(x, plan).to(dtype or x.dtype)


@lru_cache(maxsize=256)
def _pack_cf_launch(b: int, h: int, w: int, pad: int, tm: int, c: int,
                    src=_F32, dst=_F32):
    """(output shape, parameter block and its address, launch count name)
    of one pack_cf launch, per plan geometry, input shape and element
    types; a pair of types with no instantiation raises."""
    if (src, dst) not in _PACK_TYPES:
        raise TypeError(f"pack_cf: no instantiation from {src} to {dst}")
    mp = _cdiv((h + 2 * pad) * (w + 2 * pad), tm) * tm
    geo = (pack_cf_geometry(mp, c, b) if dst is _F32
           else pack_cf_bf16_geometry(mp, c, b, src.itemsize))
    return ((b, _r8(c), mp),
            *_c_ints(b, h, w, c, _r8(c), pad, mp, geo.tm, _TYPE_CODES[src],
                     _TYPE_CODES[dst], geo.smem),
            "pack_cf" if dst is _F32 else "pack_cf_bf16")


def _pack_cf_kernel(x, plan: TailPlan, dtype=None):
    dtype = dtype or x.dtype
    if not _route(x, "pack_cf"):
        return pack_cf_ref(x, plan, dtype)
    b, _, _, c = x.shape
    # `block` keeps the parameter block alive while the launcher reads it
    shape, block, prm, name = _pack_cf_launch(b, plan.h, plan.w, plan.pad,
                                              plan.tm, c, x.dtype, dtype)
    _check(x, "pack_cf x", (b, plan.h, plan.w, c), x.dtype)
    out = x.new_empty(shape, dtype=dtype)
    _launch(name, _cuda.lib().nq_pack_cf, x.data_ptr(), out.data_ptr(), prm)
    return out


def unpack_cf_ref(g, plan: TailPlan, c: int, dtype=None):
    """Plain version of :func:`unpack_cf` (the JAX ``pack_cf`` backward,
    cast to the forward input's dtype)."""
    return cf_to_nhwc(g, plan, c).to(dtype or g.dtype).contiguous()


@lru_cache(maxsize=256)
def _unpack_cf_launch(b: int, h: int, w: int, c: int, c8: int, pad: int,
                      mp: int, src=_F32, dst=_F32):
    """(output shape, parameter block and its address, launch count name)
    of one unpack_cf launch; a pair of types with no instantiation
    raises."""
    if (src, dst) not in _UNPACK_TYPES:
        raise TypeError(f"unpack_cf: no instantiation from {src} to {dst}")
    if src is _F32:
        geo = unpack_cf_geometry(h, w, pad, c, b)
        prm = _c_ints(b, h, w, c, c8, pad, mp, geo.tm, 0, 0)
    else:
        geo = unpack_cf_bf16_geometry(h, w, pad, c, b)
        prm = _c_ints(b, h, w, c, c8, pad, mp, geo.tm, 1, _TYPE_CODES[dst],
                      geo.smem)
    return ((b, h, w, c), *prm,
            "unpack_cf" if src is _F32 else "unpack_cf_bf16")


def unpack_cf(g, plan: TailPlan, c: int, dtype=None):
    """Channels-first (B, C8, Mp) -> NHWC (B, h, w, c) of `dtype` (g's by
    default; bf16 g may come out fp32): the interior, the channel pad
    dropped, in one pass. The transpose of :func:`pack_cf`."""
    dtype = dtype or g.dtype
    if not _route(g, "unpack_cf"):
        return unpack_cf_ref(g, plan, c, dtype)
    b, c8, _ = g.shape
    if c > c8:
        raise ValueError(f"unpack_cf: {c} channels from {c8} rows")
    # `block` keeps the parameter block alive while the launcher reads it
    shape, block, prm, name = _unpack_cf_launch(b, plan.h, plan.w, c, c8,
                                                plan.pad, plan.mp, g.dtype,
                                                dtype)
    _check(g, "unpack_cf g", (b, c8, plan.mp), g.dtype)
    out = g.new_empty(shape, dtype=dtype)
    _launch(name, _cuda.lib().nq_unpack_cf, g.data_ptr(), out.data_ptr(),
            prm)
    return out


class _PackCF(torch.autograd.Function):
    """pack_cf is linear; its backward is the transpose, unpack_cf, back to
    the input's dtype. The kernel builds no graph, so the backward is
    first-order on the CPU and the card alike (``once_differentiable``): a
    second derivative through it raises."""

    @staticmethod
    def forward(ctx, x, plan, dtype):
        ctx.plan, ctx.c, ctx.dtype = plan, x.shape[-1], x.dtype
        return _pack_cf_kernel(x, plan, dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with span("tail"):
            return unpack_cf(g.contiguous(), ctx.plan, ctx.c, ctx.dtype), \
                None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def pack_cf(x, plan: TailPlan, dtype=None):
    """NHWC (B, h, w, C) -> channels-first (B, C8, Mp) of `dtype` (x's by
    default; fp32 x may go to bf16, the tail's bf16 entry) with the border
    ring, channel pad and flat tail pad written as zeros, in one pass."""
    if _needs_grad(x):
        return _PackCF.apply(x, plan, dtype)
    return _pack_cf_kernel(x, plan, dtype)


# --------------------------------------------------------------------------
# Kernels 3 and 4: tail_conv_cf and tail_conv_dw_cf
# --------------------------------------------------------------------------
K_STEP = 4          # rows of one K step: one flat shift, consecutive channels
K_STAGE = 32        # K rows per stage of the conv kernels' rings: 8 steps
CONV_TILE_N = 128   # positions per block of the fp32 conv kernel
DW_TILE_K = 128     # the dW kernel's K rows per block
DW_STEP = 32        # its positions per stage; chunks align to it
_SM_SLOTS = 264     # blocks in flight on the H100: 2 on each of 132 SMs


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
def _k_steps(blocks, cin: int, taps: int):
    """The K axis as the kernels read it, in steps of K_STEP rows: a step is
    one box of x, consecutive channels at one flat shift, and never crosses
    a block. Returns (steps (n, 4) int32 rows (flat shift, first channel,
    valid rows, 0), wrow (n * K_STEP,) int64: per K row, its row of the
    (taps*cin + 1, cout) weight matrix). A block whose length is not a
    multiple of K_STEP ends in a step with fewer valid rows; the rows past
    them read zero and point at the matrix's last row, which is zero."""
    steps, wrow = [], []
    zero = taps * cin
    for s, t, lo, n in blocks:
        for c in range(lo, lo + n, K_STEP):
            rows = min(K_STEP, lo + n - c)
            steps.append((s, c, rows, 0))
            wrow += [t * cin + c + r for r in range(rows)]
            wrow += [zero] * (K_STEP - rows)
    return (np.asarray(steps, np.int32).reshape(-1, 4),
            np.asarray(wrow, np.int64))


@lru_cache(maxsize=64)
def _conv_steps(blocks, cin: int, taps: int):
    """:func:`_k_steps` padded with empty steps (and zero weight rows) to
    whole stages of K_STAGE rows: the conv kernel's list."""
    steps, wrow = _k_steps(blocks, cin, taps)
    pad = -len(steps) % (K_STAGE // K_STEP)
    steps = np.concatenate([steps, np.zeros((pad, 4), np.int32)])
    wrow = np.concatenate([wrow, np.full(pad * K_STEP, taps * cin, np.int64)])
    return steps, wrow


@lru_cache(maxsize=64)
def _conv_steps_on(blocks, cin: int, taps: int, device: str):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _conv_steps(blocks, cin, taps))


@lru_cache(maxsize=64)
def _dw_steps(blocks, cin: int, taps: int):
    """The dW kernel's list: the K steps plus one step whose first row reads
    ones (channel -2), so that its dW row is db; and the K rows' weight
    rows."""
    steps, wrow = _k_steps(blocks, cin, taps)
    steps = np.concatenate([steps, np.asarray([[0, -2, 1, 0]], np.int32)])
    return steps, wrow


@lru_cache(maxsize=64)
def _dw_steps_on(blocks, cin: int, taps: int, device: str):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _dw_steps(blocks, cin, taps))


BOX_STEPS = 8               # a bf16 kernel's TMA box stays in a window of
                            # 8 steps: a forward stage, a quarter dW tile
BOX_ROWS = (4, 8, 16, 32)   # the box heights they hold a tensor map for


def _box_plan(steps):
    """The step list with column 3 set to the bf16 kernels' copies: the
    rows of the TMA box that starts at each step (4, 8, 16 or 32), 0 where
    an earlier step's box covers it. A box covers a run of steps at one
    flat shift over consecutive channels (each full but the last) inside
    one window of BOX_STEPS steps, in boxes of 8, 4, 2 and 1 steps; its
    rows past the last step's valid ones read the next channels (or zero
    past cin), as a lone step's do. The db step (channel -2) has none."""
    out = np.array(steps, np.int32)
    out[:, 3] = 0
    n, j = len(out), 0
    while j < n:
        if out[j, 1] < 0:
            j += 1
            continue
        end = min(n, (j // BOX_STEPS + 1) * BOX_STEPS)
        k = j + 1
        while (k < end and out[k, 1] >= 0 and out[k, 0] == out[j, 0]
               and out[k, 1] == out[k - 1, 1] + K_STEP
               and out[k - 1, 2] == K_STEP):
            k += 1
        while j < k:
            h = 1 << ((k - j).bit_length() - 1)
            out[j, 3] = K_STEP * h
            j += h
    return out


@lru_cache(maxsize=64)
def _conv_boxes_on(blocks, cin: int, taps: int, device: str):
    """The conv kernels' list (fp32 and bf16): :func:`_conv_steps` with its
    box plan."""
    return torch.as_tensor(_box_plan(_conv_steps(blocks, cin, taps)[0]),
                           device=device)


@lru_cache(maxsize=64)
def _dw_steps_bf16_on(blocks, cin: int, taps: int, device: str):
    """The bf16 dW kernel's list, :func:`_dw_steps` with its box plan, and
    the K rows' weight rows."""
    steps, wrow = _dw_steps(blocks, cin, taps)
    return (torch.as_tensor(_box_plan(steps), device=device),
            torch.as_tensor(wrow, device=device))


@lru_cache(maxsize=64)
def _k_runs(blocks, cin: int, taps: int):
    """The step list of :func:`_conv_steps` read back as runs (flat shift,
    first channel, valid rows, zero rows after them): consecutive full
    steps at one shift over consecutive channels merge. What the plain
    versions slice, so that they multiply the operand the kernels see."""
    runs = []
    for s, c, rows, _ in _conv_steps(blocks, cin, taps)[0].tolist():
        if runs:
            ps, pc, pr, pz = runs[-1]
            if pz == 0 and ps == s and pc + pr == c and rows:
                runs[-1] = (s, pc, pr + rows, K_STEP - rows)
                continue
        runs.append((s, c, rows, K_STEP - rows))
    return tuple(runs)


def _w_operand(kk, wrow):
    """(K, cout) weight rows gathered from the canonical (side, side, cin,
    cout) kernel; padded K rows read a zero row."""
    cout = kk.shape[-1]
    w2 = torch.cat([kk.reshape(-1, cout), kk.new_zeros(1, cout)])
    return w2[wrow]


def conv_w_operand(kk, plan: TailPlan, layer: TailLayer):
    """The kernel's weight operand: the rows of `kk` that the layer's K-step
    list reads, contiguous: K-major, (cout, K rows), for the fp32 kernel,
    (K rows, cout) for the bf16 one. :func:`conv_cf` gathers it on every
    call unless it is given one made here once; either layout is one
    gather."""
    _, wrow = _conv_steps_on(_k_blocks(plan, layer), layer.cin, layer.taps,
                             str(kk.device))
    if kk.dtype is torch.float32:
        cout = kk.shape[-1]
        w2 = torch.cat([kk.reshape(-1, cout), kk.new_zeros(1, cout)])
        return w2.t().index_select(1, wrow)
    return _w_operand(kk, wrow).contiguous()


def conv_executed_macs(plan: TailPlan, layer: TailLayer,
                       batch: int = 1) -> int:
    """MACs the kernels execute for one conv_cf (or conv_cf_dw) call: every
    position of the flat layout x the K-step list's rows (its zero rows
    too) x cout rounded up to the 16-channel fragment. Against
    :func:`conv_cf_flops` / 2 it shows what the border, the channel pads,
    the union blocks' unread rows and the step padding cost."""
    steps, _ = _k_steps(_k_blocks(plan, layer), layer.cin, layer.taps)
    return batch * plan.mp * len(steps) * K_STEP * (-(-layer.cout // 16) * 16)


def _im2col(x, plan: TailPlan, blocks):
    """(B, K, Mp): row k is channel chan[k] of x shifted by shift[k], zero
    outside [0, Mp)."""
    g = max(abs(s) for s, _, _, _ in blocks)
    xt = F.pad(x, (g, g))
    return torch.cat([xt[:, lo:lo + n, g + s:g + s + plan.mp]
                      for s, _, lo, n in blocks], dim=1)


def _im2col_runs(x, plan: TailPlan, runs):
    """:func:`_im2col` over the runs of the K-step list, zero rows
    included."""
    g = max(abs(s) for s, _, _, _ in runs)
    xt = F.pad(x, (g, g))
    parts = []
    for s, c, rows, zeros in runs:
        if rows:
            parts.append(xt[:, c:c + rows, g + s:g + s + plan.mp])
        if zeros:
            parts.append(x.new_zeros((x.shape[0], zeros, plan.mp)))
    return torch.cat(parts, dim=1)


def _wrows(blocks, cin: int, device):
    """Row of the flat (taps*cin, cout) kernel that each K row reads."""
    return torch.as_tensor(np.concatenate(
        [t * cin + np.arange(lo, lo + n) for _, t, lo, n in blocks]),
        device=device)


def _operands(x, plan: TailPlan, layer: TailLayer, blocks, steps: bool):
    """(patches (B, K, Mp), wrow (K,)) of the plain versions: over the K
    blocks, or over the kernels' padded K-step list of those blocks."""
    if not steps:
        return _im2col(x, plan, blocks), _wrows(blocks, layer.cin, x.device)
    wrow = _conv_steps(blocks, layer.cin, layer.taps)[1]
    return (_im2col_runs(x, plan, _k_runs(blocks, layer.cin, layer.taps)),
            torch.as_tensor(wrow, device=x.device))


_EMITS = ("z", "y", "zy")


def conv_cf_ref(x, kk, bias, plan: TailPlan, layer: TailLayer,
                emit: str = "z", act_in: bool = False, blocks=None,
                out_mul=None, steps: bool = False):
    """Plain version of :func:`conv_cf` (the JAX ``_conv_cf_jnp``): im2col
    over the K blocks (dense taps by default) and one matmul. steps=True
    multiplies over the kernel's padded K-step list of those blocks
    instead (the same conv: its extra rows are zeros)."""
    if emit not in _EMITS:
        raise ValueError(f"emit={emit!r} (use 'z', 'y' or 'zy')")
    if act_in:
        x = _gelu(x)
    if blocks is None:
        blocks = _k_blocks(plan, layer, union=False)
    pats, wrow = _operands(x, plan, layer, blocks, steps)    # (B, K, Mp)
    acc = torch.matmul(_w_operand(kk, wrow).T.float(), pats.float())
    if bias is not None:
        acc = acc + bias.float()[None]
    if out_mul is not None:
        acc = acc * _gelu_grad(out_mul)
    acc = acc * border_mask(plan, torch.float32, device=x.device)
    z = acc.to(x.dtype)
    if emit == "z":
        return z
    y = _gelu(acc).to(x.dtype)
    return y if emit == "y" else (z, y)


@lru_cache(maxsize=64)
def _mask_on(h: int, w: int, pad: int, mp: int, device: str):
    """The (Mp,) fp32 border mask on `device`, made once."""
    return torch.as_tensor(_mask_np(h, w, pad, mp).reshape(mp),
                           device=device)


def _tile_m(cout: int) -> int:
    """Output channels per block of the dW kernel (its launcher applies the
    same rule): the tile of 64, 96 or 128 that leaves the fewest fragment
    columns of the last tile empty."""
    if cout <= 64:
        return 64
    return 96 if cout <= 96 or 128 < cout <= 192 else 128


def _fill_split(tiles: int, work: int, overhead: int, most: int,
                slots: int = _SM_SLOTS) -> int:
    """Into how many parts to cut each tile's `work` (in stages) so that
    `tiles * parts` blocks fill the card's `slots` (blocks in flight): the
    count that minimises waves x (stages per part + overhead), the smallest
    on a tie."""
    best, best_cost = 1, None
    for s in range(1, max(1, most) + 1):
        cost = -(-tiles * s // slots) * (-(-work // s) + overhead)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


# --------------------------------------------------------------------------
# Launch geometry of the conv kernels on TMA rings and wgmma (the fp32 and
# bf16 tail_conv_cf, the bf16 tail_conv_dw_cf). Their launchers apply the
# same tile rules (nq_tail_conv_cf_tile, nq_tail_conv_cf_bf16_tile and
# nq_tail_conv_dw_cf_bf16_tile report them); the wrappers pass the splits.
# tests/test_torch_bf16_tiles.py and tests/test_torch_tail_fused.py hold
# them at every main-path shape.
# --------------------------------------------------------------------------
H100_SMS = 132
BF16_ROW = 64               # bf16 values in one 128-byte swizzled line
BF16_SEG = 144              # the forward's staged x positions per 128
BF16_DW_TILE_K = 128        # dW K rows per block: two warpgroups of 64
BF16_DW_STEP = 64           # dW positions per stage: one swizzled line
BF16_DW_SEG = 80            # its staged x positions per 64
BF16_DW_RING = 184320       # bytes the dW kernel gives its ring
SMEM_PER_BLOCK = 232448     # dynamic shared memory a block may use
SMEM_PER_SM = 233472        # shared memory of an SM (1 KB per block kept)
F32_SEG = 136               # the fp32 forward's staged x positions per 128


def conv_f32_tile(cout: int) -> Tuple[int, int]:
    """(output channels, positions) per block of the fp32 TMA kernel: 64 x
    128 for cout <= 64, else of 96 and 128 channels the one that pads cout
    least (176 -> 192, 848 -> 864), 128 on a tie. Each of its two
    warpgroups multiplies 64 positions with every channel (m64nNk8): with
    the second set of sums the 3xTF32 promotion keeps, 64 sums a thread is
    what a warpgroup holds, so fp32 stays under bf16's tile."""
    if cout <= 64:
        return 64, CONV_TILE_N
    return (96 if _cdiv(cout, 96) * 96 < _cdiv(cout, 128) * 128 else 128,
            CONV_TILE_N)


@lru_cache(maxsize=256)
def conv_f32_geometry(cout: int, mp: int, batch: int, nsteps: int) -> dict:
    """The fp32 TMA kernel's launch, one block on each SM. A ring of
    `stages` stages of K_STAGE rows: the x rows staged by TMA as F32_SEG
    positions per 128 from the shift rounded down to 4 (a box's start
    must lie on 16 bytes), the weight rows K-major (128 bytes a channel,
    swizzled) and their TF32 lo part beside them; 1 KB for alignment,
    three barriers a stage. The K splits: 1 unless the launch has fewer tiles
    than the card has SMs (the prefix's dx pass), then enough to fill it,
    each split keeping at least 8 stages."""
    bm, bn = conv_f32_tile(cout)
    stage = K_STAGE * F32_SEG * 4 + 2 * bm * 128
    stages = {128: 4, 96: 5, 64: 6}[bm]
    ktiles = nsteps * K_STEP // K_STAGE
    tiles = _cdiv(mp, bn) * _cdiv(cout, bm) * batch
    splits = 1 if tiles >= H100_SMS else \
        _fill_split(tiles, ktiles, 4, min(16, ktiles // 8), slots=H100_SMS)
    return dict(bm=bm, bn=bn, stages=stages, stage_bytes=stage,
                smem=1024 + stages * stage + 8 * 3 * stages,
                blocks_per_sm=1, ktiles=ktiles, splits=splits,
                grid=(_cdiv(mp, bn), _cdiv(cout, bm), batch * splits))


def conv_bf16_tile(cout: int) -> Tuple[int, int]:
    """(output channels, positions) per block of the bf16 conv kernel:
    128 x 256 (one block on each SM), unless 64 x 256 (two blocks on each
    SM) pads cout to fewer channels (176 -> 192, not 256; cout <= 64).
    Each of its two warpgroups multiplies 128 positions of every
    64-channel slab."""
    if _cdiv(cout, 128) * 128 <= _cdiv(cout, 64) * 64:
        return 128, 256
    return 64, 256


@lru_cache(maxsize=256)
def conv_bf16_geometry(cout: int, mp: int, batch: int, nsteps: int) -> dict:
    """The bf16 conv kernel's launch. A ring of `stages` stages of K_STAGE
    rows: per 128 positions the x rows staged by TMA as BF16_SEG
    positions from the shift rounded down to 8 (a box's start must lie on
    16 bytes), and the weight slab of each 64 channels (4 KB, swizzled);
    per warpgroup two buffers of its realigned x rows; the epilogue's fp32
    staging reuses the ring; 1 KB for alignment, the barriers. The K
    splits: 1 unless the launch has fewer tiles than the card holds blocks
    (the prefix's dx pass), as :func:`conv_f32_geometry` counts."""
    bm, bn = conv_bf16_tile(cout)
    mt, pw = bm // BF16_ROW, bn // 2
    blocks = 1 if mt == 2 else 2
    stage = (bn // 128) * K_STAGE * BF16_SEG * 2 + mt * K_STAGE * 128
    stages = 6 if mt == 2 else 3
    ops = 2 * 2 * K_STAGE * 128 * (pw // BF16_ROW)
    epi = 2 * BF16_ROW * mt * (pw + 8) * 4
    ktiles = nsteps * K_STEP // K_STAGE
    tiles = _cdiv(mp, bn) * _cdiv(cout, bm) * batch
    slots = blocks * H100_SMS
    splits = 1 if tiles >= slots else \
        _fill_split(tiles, ktiles, 4, min(16, ktiles // 8), slots=slots)
    return dict(bm=bm, bn=bn, stages=stages, stage_bytes=stage,
                smem=1024 + max(stages * stage + ops, epi) + 16 * stages,
                blocks_per_sm=blocks, ktiles=ktiles, splits=splits,
                grid=(_cdiv(mp, bn), _cdiv(cout, bm), batch * splits))


def dw_bf16_tile(cout: int) -> int:
    """Output channels per block of the bf16 dW kernel: of 128, 96 and 64
    the one that pads cout least, the widest on a tie."""
    best = 128
    for bn in (96, 64):
        if _cdiv(cout, bn) * bn < _cdiv(cout, best) * best:
            best = bn
    return best


@lru_cache(maxsize=256)
def dw_bf16_geometry(nsteps: int, cout: int, batch: int, mp: int) -> dict:
    """The bf16 dW kernel's launch for a list of `nsteps` steps (the db
    step included): blocks of 128 K rows x :func:`dw_bf16_tile` channels,
    one on each SM; stages of 64 positions (the x rows staged as
    BF16_DW_SEG positions from the shift rounded down to 8, and 128
    bytes a channel of g, swizzled), as many as fit BF16_DW_RING (at most
    8), beside two buffers of realigned x rows per warpgroup; the
    positions cut into `splits` chunks of `chunk` (a multiple of 64) so
    that the grid fills the card, as :func:`_dw_split` does."""
    bn = dw_bf16_tile(cout)
    stage = BF16_DW_TILE_K * BF16_DW_SEG * 2 + bn * 128
    stages = min(8, BF16_DW_RING // stage)
    ops = 2 * 2 * BF16_ROW * 128
    positions = batch * mp
    ktiles = _cdiv(nsteps * K_STEP, BF16_DW_TILE_K)
    tiles = ktiles * _cdiv(cout, bn)
    splits = _fill_split(tiles, _cdiv(positions, BF16_DW_STEP), 8,
                         positions // 1024, slots=H100_SMS)
    chunk = _cdiv(_cdiv(positions, splits), BF16_DW_STEP) * BF16_DW_STEP
    splits = _cdiv(positions, chunk)
    return dict(bn=bn, stages=stages, stage_bytes=stage,
                smem=1024 + stages * stage + ops + 16 * stages,
                blocks_per_sm=1, ktiles=ktiles, splits=splits, chunk=chunk,
                grid=(ktiles, _cdiv(cout, bn), splits))


def _aligned16(t, name: str) -> None:
    """Raise unless t's data starts on a 16-byte boundary (TMA's rule for
    the bf16 kernels' tensor maps, and their 16-byte stores)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must start on a 16-byte boundary")


def conv_cf(x, kk, bias, plan: TailPlan, layer: TailLayer,
            emit: str = "z", act_in: bool = False, w_op=None, out_mul=None):
    """One channels-first conv layer: x (B, cin, Mp) -> the masked
    pre-activation 'z' (B, cout, Mp), its activation 'y' = gelu(z), or the
    pair 'zy' (z, y) from one pass. act_in applies GELU to the input as it
    is read. kk is the canonical (side, side, cin, cout) kernel, bias
    (cout, 1) or None; w_op, if given, is ``conv_w_operand(kk, plan,
    layer)`` made beforehand. out_mul (B, cout, Mp), the backward's dx
    epilogue, multiplies z by GELU'(out_mul) before the border mask (the
    JAX order). All of x, kk, bias, out_mul and w_op are fp32, or all bf16
    (the bf16 instantiation: fp32 sums, z and y rounded once to bf16)."""
    blocks = _k_blocks(plan, layer)
    if not _route(x, "tail_conv_cf"):
        return conv_cf_ref(x, kk, bias, plan, layer, emit, act_in, blocks,
                           out_mul, steps=True)
    if emit not in _EMITS:
        raise ValueError(f"emit={emit!r} (use 'z', 'y' or 'zy')")
    dt = _kernel_dtype(x, "tail_conv_cf x")
    b = x.shape[0]
    _check(x, "tail_conv_cf x", (b, layer.cin, plan.mp), dt)
    _check(kk, "tail_conv_cf kk", (layer.side, layer.side, layer.cin,
                                   layer.cout), dt)
    if bias is not None:
        _check(bias, "tail_conv_cf bias", (layer.cout, 1), dt)
    if out_mul is not None:
        _check(out_mul, "tail_conv_cf out_mul", (b, layer.cout, plan.mp), dt)
    if plan.mp % CONV_TILE_N:
        raise ValueError(f"tail_conv_cf: Mp={plan.mp} is not a multiple "
                         f"of {CONV_TILE_N}")
    dev = str(x.device)
    if w_op is None:
        w_op = conv_w_operand(kk, plan, layer)
    steps = _conv_boxes_on(blocks, layer.cin, layer.taps, dev)
    nsteps = int(steps.shape[0])
    f32 = dt is torch.float32
    if f32:
        splits = conv_f32_geometry(layer.cout, plan.mp, b, nsteps)["splits"]
        aligned = (x, w_op)
    else:
        splits = conv_bf16_geometry(layer.cout, plan.mp, b, nsteps)["splits"]
        if layer.cout % 8:
            raise ValueError(f"tail_conv_cf: bf16 cout={layer.cout} is not "
                             "a multiple of 8")
        aligned = (x, w_op, out_mul)
    for t, name in zip(aligned, ("x", "w_op", "out_mul")):
        if t is not None:
            _aligned16(t, f"tail_conv_cf {name}")
    _check(w_op, "tail_conv_cf w_op", (layer.cout, nsteps * K_STEP) if f32
           else (nsteps * K_STEP, layer.cout), dt)
    shape = (b, layer.cout, plan.mp)
    out_z = torch.empty(shape, dtype=dt, device=x.device) \
        if "z" in emit else None
    out_y = torch.empty(shape, dtype=dt, device=x.device) \
        if "y" in emit else None
    # per-split fp32 partial sums, added in a fixed order by the second pass
    part = torch.empty((splits, *shape), dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    mask = _mask_on(plan.h, plan.w, plan.pad, plan.mp, dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    lib = _cuda.lib()
    fn = lib.nq_tail_conv_cf if f32 else lib.nq_tail_conv_cf_bf16
    _launch(_counted("tail_conv_cf", dt), fn, x.data_ptr(),
            w_op.data_ptr(), ptr(bias), ptr(out_mul), mask.data_ptr(),
            steps.data_ptr(), ptr(out_z), ptr(out_y), ptr(part), b,
            layer.cin, layer.cout, plan.mp, nsteps, splits, int(act_in))
    if f32:
        KERNEL_LAUNCHES["tail_conv_cf_wgmma"] += 1
    return {"z": out_z, "y": out_y, "zy": (out_z, out_y)}[emit]


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
                   act_in: bool = False, blocks=None, steps: bool = False):
    """Plain version of :func:`conv_cf_dw`: im2col over the K blocks (dense
    taps by default, the JAX ``_conv_cf_dw_jnp``) and one matmul.
    steps=True sums over the kernel's padded K-step list of those blocks
    instead (its extra rows scatter onto a dropped row)."""
    if act_in:
        x = _gelu(x)
    if blocks is None:
        blocks = _k_blocks(plan, layer, union=False)
    pats, wrow = _operands(x, plan, layer, blocks, steps)    # (B, K, Mp)
    dw = torch.einsum("bkm,bcm->kc", pats.float(), g.float())
    db = g.float().sum(dim=(0, 2)).reshape(-1, 1)
    return _scatter_dw(dw, wrow, layer), db


def _dw_split(nk: int, cout: int, positions: int) -> Tuple[int, int]:
    """(splits, chunk): the B*Mp positions cut into `splits` chunks of
    `chunk` positions (a multiple of DW_STEP, at least 1024 where there
    are that many), one per block of the grid's third axis, so that a
    layer with few output tiles still fills the card."""
    tiles = -(-nk // DW_TILE_K) * -(-cout // _tile_m(cout))
    splits = _fill_split(tiles, -(-positions // DW_STEP), 8,
                         positions // 1024)
    chunk = -(-positions // splits)
    chunk = -(-chunk // DW_STEP) * DW_STEP
    return -(-positions // chunk), chunk


def conv_cf_dw(x, g, plan: TailPlan, layer: TailLayer,
               act_in: bool = False):
    """dW and db of one layer: x its input (B, cin, Mp), g the cotangent of
    its output (B, cout, Mp), border-masked -> (dkk (side, side, cin, cout),
    db (cout, 1)), fp32 whether x and g are fp32 or bf16. act_in applies
    GELU to x as it is read (for a residual kept as a pre-activation). The
    sum runs over the layer's K-step list (union-sparse for f >= 2), as
    the forward does, and is scattered back to the canonical kernel
    (:func:`_scatter_dw`)."""
    blocks = _k_blocks(plan, layer)
    if not _route(x, "tail_conv_dw_cf"):
        return conv_cf_dw_ref(x, g, plan, layer, act_in, blocks, steps=True)
    dt = _kernel_dtype(x, "tail_conv_dw_cf x")
    b = x.shape[0]
    _check(x, "tail_conv_dw_cf x", (b, layer.cin, plan.mp), dt)
    _check(g, "tail_conv_dw_cf g", (b, layer.cout, plan.mp), dt)
    if plan.mp % DW_STEP:
        raise ValueError(f"tail_conv_dw_cf: Mp={plan.mp} is not a multiple "
                         f"of {DW_STEP}")
    dev = str(x.device)
    if dt is torch.float32:
        steps, wrow = _dw_steps_on(blocks, layer.cin, layer.taps, dev)
        nsteps = int(steps.shape[0])
        splits, chunk = _dw_split(nsteps * K_STEP, layer.cout, b * plan.mp)
    else:
        steps, wrow = _dw_steps_bf16_on(blocks, layer.cin, layer.taps, dev)
        nsteps = int(steps.shape[0])
        if plan.mp % BF16_DW_STEP or layer.cout % 8:
            raise ValueError(f"tail_conv_dw_cf: bf16 needs Mp={plan.mp} a "
                             f"multiple of {BF16_DW_STEP} and cout="
                             f"{layer.cout} of 8")
        _aligned16(x, "tail_conv_dw_cf x")
        _aligned16(g, "tail_conv_dw_cf g")
        geo = dw_bf16_geometry(nsteps, layer.cout, b, plan.mp)
        splits, chunk = geo["splits"], geo["chunk"]
    nk = nsteps * K_STEP
    # per-split partial sums, added in a fixed order by the second pass:
    # the result is the same from run to run
    part = torch.empty((splits, nk, layer.cout), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((nk, layer.cout), dtype=torch.float32, device=x.device)
    lib = _cuda.lib()
    fn = lib.nq_tail_conv_dw_cf if dt is torch.float32 else \
        lib.nq_tail_conv_dw_cf_bf16
    _launch(_counted("tail_conv_dw_cf", dt), fn, x.data_ptr(),
            g.data_ptr(), steps.data_ptr(), part.data_ptr(), out.data_ptr(),
            b, layer.cin, layer.cout, plan.mp, nsteps, splits, chunk,
            int(act_in))
    return (_scatter_dw(out[:nk - K_STEP], wrow, layer),
            out[nk - K_STEP].reshape(layer.cout, 1))


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

    The forward keeps residuals. A layer whose successor applies GELU to
    its input emits the pair (z, y = gelu(z)) from one pass: the successor
    and its dW pass read y as it is, the successor's dx epilogue reads z.
    (The JAX tail keeps z alone and re-applies GELU as each kernel reads
    it, which saves a (cout, Mp) write per layer; here that write costs
    less than the erf on every staged value.) The backward masks the
    cotangent once and walks the layers from the last: dW/db from the saved
    input, then dx by the same conv kernel on ``_kk_transpose(kk)`` and
    ``layer.transposed()``, with GELU'(the input's pre-activation) as the
    epilogue where the layer's input went through GELU. Gradients are for
    the canonical kernels: each reaches its kk once, and autograd takes it
    through the packing gather back to the raw weights. The backward is
    first-order, as the JAX tail's custom VJP: its kernels build no graph,
    so a second derivative through it raises (``once_differentiable``)
    where it would otherwise come out silently wrong."""

    @staticmethod
    def forward(ctx, plan, w_ops, n, x_cf, *params):
        kks, biases = params[:n], params[n:]
        h, inputs, pre = x_cf, [], []
        for li, layer in enumerate(plan.layers):
            inputs.append(h)
            pair = li < n - 1 and plan.layers[li + 1].gelu_in
            out = conv_cf(h, kks[li], biases[li], plan, layer,
                          emit="zy" if pair else "z",
                          w_op=None if w_ops is None else w_ops[li])
            z, h = out if pair else (out, out)
            if pair:
                pre.append(z)
        ctx.save_for_backward(*inputs, *kks, *pre)
        ctx.plan, ctx.n = plan, n
        ctx.bias_dtypes = tuple(None if bb is None else bb.dtype
                                for bb in biases)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        with span("tail"):
            return _TailApply._backward(ctx, g_out)

    @staticmethod
    def _backward(ctx, g_out):
        plan, n = ctx.plan, ctx.n
        saved = ctx.saved_tensors
        inputs, kks, pre = saved[:n], saved[n:2 * n], list(saved[2 * n:])
        g = (g_out * border_mask(plan, g_out.dtype,
                                 device=g_out.device)).contiguous()
        dkks, dbs = [None] * n, [None] * n
        for li in range(n - 1, -1, -1):
            layer = plan.layers[li]
            # fp32 sums, returned in the weights' dtype (_tail_apply_bwd)
            dkk, db = conv_cf_dw(inputs[li], g, plan, layer)
            dkks[li] = dkk.to(kks[li].dtype)
            bdt = ctx.bias_dtypes[li]
            dbs[li] = None if bdt is None else db.to(bdt)
            if li == 0 and not ctx.needs_input_grad[3]:
                g = None
                break
            g = conv_cf(g, _kk_transpose(kks[li]).contiguous(), None, plan,
                        layer.transposed(),
                        out_mul=pre.pop() if layer.gelu_in else None)
        return (None, None, None, g, *dkks, *dbs)


def tail_apply(plan: TailPlan, x_cf, kks, biases, w_ops=None):
    """Run the fused tail: x_cf (B, C0_8, Mp) -> pre-activation head output
    (B, C_last_8, Mp) with zero borders. w_ops: per layer, the prepared
    ``conv_w_operand``, or None to gather them here.

    With no gradient wanted (decode), every layer followed by a GELU emits
    gelu(z), what the next one consumes; the head emits z. When an input
    requires a gradient it runs as :class:`_TailApply`, which keeps each
    layer's input, and the pre-activation beside it, for its backward."""
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
# Forward-mode tail ('pallas_hvp'): Hessian-vector products through the
# kernels. Hv = grad(w -> jvp(L, w, v)) is reverse-over-forward: the tangent
# is carried beside the value as plain tensors, layer by layer (the JAX
# ``tail_apply_fo`` custom_jvp rule), and every op of that graph is
# first-order autograd, so the outer gradient differentiates each kernel
# once. conv_p is the one conv in it; the GELU and its tangent are one
# Function whose closed-form backward carries the second derivative.
# --------------------------------------------------------------------------
class _ConvP(torch.autograd.Function):
    """One masked conv z = mask * (conv(x, kk) + bias), emitting z, as a
    first-order Function (the JAX ``conv_p``): forward one ``tail_conv_cf``
    launch; backward dW and db by ``tail_conv_dw_cf``, dx by ``tail_conv_cf``
    on the transposed layer, the calls of one layer of
    :class:`_TailApply`'s backward, each only where an input needs it."""

    @staticmethod
    def forward(ctx, plan, layer, x, kk, bias):
        ctx.save_for_backward(x, kk)
        ctx.plan, ctx.layer, ctx.has_bias = plan, layer, bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        return conv_cf(x, kk, bias, plan, layer)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, kk = ctx.saved_tensors
        plan, layer = ctx.plan, ctx.layer
        g = (g * border_mask(plan, g.dtype, device=g.device)).contiguous()
        dkk = db = dx = None
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            dkk, db = conv_cf_dw(x, g, plan, layer)
            dkk = dkk.to(kk.dtype)
            db = db if ctx.bias_dtype is None else db.to(ctx.bias_dtype)
        if ctx.needs_input_grad[2]:
            dx = conv_cf(g, _kk_transpose(kk).contiguous(), None, plan,
                         layer.transposed())
        return None, None, dx, dkk, db if ctx.has_bias else None


_ERF_P = 0.3275911


def _erf_grad(x):
    """d/dx of :func:`_erf` as autograd differentiates that formula (the
    JAX package differentiates its own the same way): e^{-x^2} (p t^2
    poly'(t) + 2|x| poly(t)), and 0 at x == 0, where sign and abs have a
    zero derivative."""
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + _ERF_P * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    dpoly = 0.254829592 + t * (2 * -0.284496736 + t * (3 * 1.421413741
                               + t * (4 * -1.453152027 + t * 5 * 1.061405429)))
    return s * s * torch.exp(-ax * ax) * (_ERF_P * t * t * dpoly
                                          + 2.0 * ax * poly)


PIECE = 1 << 23     # elements a piece of the tangent GELU under --remat


def _by_pieces(piece, fn, *xs):
    """``fn(*xs)`` for an elementwise `fn` of same-shape tensors; with a
    `piece` size, run over contiguous pieces of that many elements and
    written into whole outputs: the same values, with each of fn's
    temporaries a piece in size instead of a whole tensor (the erf
    polynomial's ~10 temporaries at 592 or 400 channels were the stage-2
    HVP's peak)."""
    n = xs[0].numel()
    if piece is None or n <= piece:
        return fn(*xs)
    flat = [x.contiguous().view(-1) for x in xs]
    outs = None
    for a in range(0, n, piece):
        res = fn(*(f[a:a + piece] for f in flat))
        if outs is None:
            outs = [torch.empty(n, dtype=r.dtype, device=r.device)
                    for r in res]
        for o, r in zip(outs, res):
            o[a:a + piece].copy_(r)
    return tuple(o.view(xs[0].shape) for o in outs)


def _gelu_tangent(h, dh):
    return _gelu(h), _gelu_grad(h) * dh


def _gelu_tangent_vjp(h, dh, gy, gd):
    hf = h.float()
    u = hf * 0.7071067811865476
    de = _erf_grad(u) * 0.7071067811865476        # d erf(h / sqrt 2)
    cdf = 0.5 * (1.0 + _erf(u))
    phi = torch.exp(-0.5 * hf * hf) * _INV_SQRT_2PI
    dy = cdf + 0.5 * hf * de                       # d gelu / dh
    dg = 0.5 * de + phi - hf * hf * phi            # d gelu' / dh
    return gy * dy + gd * dh * dg, gd * (cdf + hf * phi)


class _GeluTangent(torch.autograd.Function):
    """(h, dh) -> (gelu(h), gelu'(h) * dh), the tail's GELU with its
    tangent. Autograd through the two formulas keeps ~20 full-size
    intermediates of the erf polynomial for the outer backward; this keeps
    h and dh and writes that backward in closed form: the derivatives of
    :func:`_gelu` and :func:`_gelu_grad` as autograd takes them. With a
    `piece` size both passes run piece by piece (:func:`_by_pieces`)."""

    @staticmethod
    def forward(ctx, h, dh, piece=None):
        ctx.save_for_backward(h, dh)
        ctx.piece = piece
        return _by_pieces(piece, _gelu_tangent, h, dh)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gd):
        h, dh = ctx.saved_tensors
        return (*_by_pieces(ctx.piece, _gelu_tangent_vjp, h, dh, gy, gd),
                None)


def conv_p(plan: TailPlan, layer: TailLayer, x, kk, bias=None):
    """z = mask * (conv(x, kk) + bias) (bias may be None), first-order
    differentiable in x, kk and bias."""
    return _ConvP.apply(plan, layer, x.contiguous(), kk.contiguous(), bias)


def _run(fn, *args):
    return fn(*args)


def tail_apply_fo(plan: TailPlan, x_cf, dx_cf, kks, dkks, biases,
                  dbiases=None, run=_run, piece=None):
    """The fused tail with a tangent: (h, dh) for input x_cf with tangent
    dx_cf, kernels kks with tangents dkks, biases with tangents dbiases
    (None: no tangent). Per layer, as the JAX ``_tail_apply_fo_jvp``:
    ``dh <- gelu'(h) * dh; h <- gelu(h)`` where the layer's input goes
    through GELU, then ``z = conv_p(h, W, b)``, ``dz = conv_p(dh, W) +
    conv_p(h, dW, db)``. h equals :func:`tail_apply`'s output. Without any
    tangent it is :func:`tail_apply` (dh None).

    Each layer is one segment, ``run(layer_fn, h, dh)``: as it is by
    default, or checkpointed (``models.decoder.segment_runner``), so that
    a backward through the tail keeps one layer's inside at a time. With a
    `piece` size (PIECE under ``--remat``, which trades time for memory)
    the tangent GELU runs piece by piece."""
    dbiases = dbiases if dbiases is not None else (None,) * len(kks)
    if dx_cf is None and all(t is None for t in (*dkks, *dbiases)):
        return tail_apply(plan, x_cf, kks, biases), None

    def layer_fo(li, h, dh):
        layer = plan.layers[li]
        if layer.gelu_in:
            h, dh = (_gelu(h), None) if dh is None else _GeluTangent.apply(
                h, dh, piece)
        z = conv_p(plan, layer, h, kks[li], biases[li])
        parts = []
        if dh is not None:
            parts.append(conv_p(plan, layer, dh, kks[li]))
        if dkks[li] is not None or dbiases[li] is not None:
            dk = dkks[li] if dkks[li] is not None else torch.zeros_like(
                kks[li])
            parts.append(conv_p(plan, layer, h, dk, dbiases[li]))
        return z, (None if not parts else parts[0] if len(parts) == 1
                   else parts[0] + parts[1])

    h, dh = x_cf, dx_cf
    for li in range(len(plan.layers)):
        h, dh = run(partial(layer_fo, li), h, dh)
    return h, dh


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


def unpack_frames_ref(z, plan: TailPlan, f: int, ch: int, out_bias: str,
                      dtype=None):
    """Plain version of :func:`unpack_frames` (the JAX ``_unpack_jnp``):
    out_img in fp32 on the interior, one rounding to `dtype` (z's by
    default), as the TPU kernel does."""
    y = out_img(cf_to_nhwc(z, plan, ch).float(), out_bias)
    return depth_to_space(y.to(dtype or z.dtype), f)


def _float_bits(x: float) -> int:
    """The bits of fp32 `x` as a C int (a parameter block's slot)."""
    return int(np.array(x, np.float32).view(np.int32))


@lru_cache(maxsize=256)
def _unpack_frames_launch(b: int, cp: int, h: int, w: int, pad: int, tm: int,
                          f: int, ch: int, out_bias: str, src=_F32,
                          dst=_F32):
    """(z's Mp, output shape, parameter block and its address, launch count
    name) of one unpack_frames launch, per plan geometry, shape, out_bias
    and element types; a pair of types with no instantiation raises."""
    if (src, dst) not in _UNPACK_TYPES:
        raise TypeError(f"unpack_frames: no instantiation from {src} to "
                        f"{dst}")
    c = ch // (f * f)
    if c * f * f != ch or ch > cp:
        raise ValueError(f"unpack_frames: {ch} channels do not unpack by "
                         f"f={f} from {cp} packed rows")
    mp = _cdiv((h + 2 * pad) * (w + 2 * pad), tm) * tm
    mode = _OUT_MODES.get(out_bias, 2)
    geo = (unpack_frames_geometry(h, w, f, c, b) if src is _F32
           else unpack_frames_bf16_geometry(h, w, f, c, b))
    bits = _float_bits(0.0 if mode < 2 else float(out_bias))
    return (mp, (b, h * f, w * f, c),
            *_c_ints(b, cp, mp, h, w, pad, f, c, mode, geo.tx, geo.fu,
                     _TYPE_CODES[src], _TYPE_CODES[dst], bits, geo.smem),
            "unpack_frames" if src is _F32 else "unpack_frames_bf16")


def _unpack_frames_kernel(z, plan: TailPlan, f: int, ch: int, out_bias: str,
                          dtype=None):
    dtype = dtype or z.dtype
    if not _route(z, "unpack_frames"):
        return unpack_frames_ref(z, plan, f, ch, out_bias, dtype)
    b, cp, _ = z.shape
    # `block` keeps the parameter block alive while the launcher reads it
    mp, shape, block, prm, name = _unpack_frames_launch(
        b, cp, plan.h, plan.w, plan.pad, plan.tm, f, ch, out_bias, z.dtype,
        dtype)
    _check(z, "unpack_frames z", (b, cp, mp), z.dtype)
    out = z.new_empty(shape, dtype=dtype)
    _launch(name, _cuda.lib().nq_unpack_frames, z.data_ptr(), out.data_ptr(),
            prm)
    return out


class _UnpackFrames(torch.autograd.Function):
    """unpack_frames with the VJP of its plain version as its backward
    (the JAX ``_unpack_frames_bwd``). That VJP is taken without a graph, so
    the backward is first-order (``once_differentiable``): a second
    derivative through it raises."""

    @staticmethod
    def forward(ctx, z, plan, f, ch, out_bias, dtype):
        ctx.save_for_backward(z)
        ctx.args = (plan, f, ch, out_bias, dtype)
        return _unpack_frames_kernel(z, plan, f, ch, out_bias, dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        with span("tail"), torch.enable_grad():
            zz = z.detach().requires_grad_()
            (dz,) = torch.autograd.grad(unpack_frames_ref(zz, *ctx.args),
                                        zz, g)
        return dz, None, None, None, None, None


def unpack_frames(z, plan: TailPlan, f: int, ch: int, out_bias: str,
                  dtype=None):
    """Head output z (B, Cp, Mp) -> frames (B, h*f, w*f, ch/f^2) of
    `dtype` (z's by default; bf16 z may come out fp32): interior slice,
    out_img, depth-to-space, in one pass."""
    if _needs_grad(z):
        return _UnpackFrames.apply(z, plan, f, ch, out_bias, dtype)
    return _unpack_frames_kernel(z, plan, f, ch, out_bias, dtype)


# --------------------------------------------------------------------------
# Model-facing entry points
# --------------------------------------------------------------------------
def resolve_impl(fused_tail: str) -> str | None:
    """cfg 'fused_tail' knob -> 'fused' (the channels-first tail on the
    kernels), 'pallas_hvp' (the same kernels, the decode taken as the value
    of the forward-mode tail, :func:`tail_apply_fo`, and a plain unpack, as
    the JAX package's HVP execution) or None (the unpacked decode). The JAX
    values 'pallas' and 'jnp' name TPU implementations of the same function
    and select the fused tail here."""
    ft = str(fused_tail).lower()
    if ft in ("off", "false", "none", "xla"):
        return None
    if ft == "pallas_hvp":
        return ft
    if ft in ("auto", "pallas", "jnp", "fused"):
        return "fused"
    raise ValueError(
        f"fused_tail={fused_tail!r} (use auto|pallas|pallas_hvp|jnp|off)")


class TailWeights(NamedTuple):
    """A channels-first plan with its weights in the layouts the kernels
    read. Packing them is per model, not per decode: the decoder keeps one
    until its weights change."""
    plan: TailPlan
    kks: tuple          # canonical (side, side, cin8, cout8) kernels
    biases: tuple       # (cout8, 1) or None
    f: int              # packing factor of the last layer's output
    ch: int             # its real packed channel count
    w_ops: tuple | None  # per-layer conv_w_operand on the GPU, else None


def _with_w_ops(plan, kks, biases, f, ch, dtype=None) -> TailWeights:
    """The weights, cast to `dtype` if one is given (the kernels'
    instantiation: bf16 for the TPU's contract), with their conv operands
    gathered (on the GPU; the plain versions gather their own). The
    operands carry no graph: a gradient reaches the weights through
    ``kks`` (and through the cast, in the weights' own dtype)."""
    if dtype is not None:
        kks = tuple(kk.to(dtype) for kk in kks)
        biases = tuple(None if bb is None else bb.to(dtype) for bb in biases)
    w_ops = None
    if kks[0].device.type == "cuda":
        with torch.no_grad():
            w_ops = tuple(conv_w_operand(kk, plan, layer)
                          for kk, layer in zip(kks, plan.layers))
    return TailWeights(plan, tuple(kks), tuple(biases), f, ch, w_ops)


def prepare_tail(h: int, w: int, blocks, head, tm: int = 0,
                 dtype=None) -> TailWeights:
    """:func:`plan_and_pack`, cast to `dtype` if given, plus the kernels'
    weight operands on the GPU."""
    return _with_w_ops(*plan_and_pack(h, w, blocks, head, tm=tm),
                       dtype=dtype)


def _entry(x, wts: TailWeights):
    """The tail's input packed channels-first in the weights' dtype (the
    JAX ``_entry_and_cast``: fp32 x enters a bf16 tail in one pass)."""
    return pack_cf(x.contiguous(), wts.plan, wts.kks[0].dtype)


def run_fused_tail_frames(x, wts: TailWeights, out_bias: str):
    """NHWC input x at the tail-entry resolution -> full-resolution frames
    (B, H, W, C) in x's dtype: pack_cf, one tail_conv_cf per layer,
    unpack_frames, in the weights' dtype between. The JAX function takes
    the raw (blocks, head) and packs them every call; here the caller
    passes them packed once (:func:`prepare_tail`)."""
    z = tail_apply(wts.plan, _entry(x, wts), wts.kks, wts.biases, wts.w_ops)
    return unpack_frames(z, wts.plan, wts.f, wts.ch, out_bias, x.dtype)


def run_fused_tail_cf(x, wts: TailWeights):
    """Like :func:`run_fused_tail_frames` but stays channels-first: returns
    (z_cf (B, ch8, Mp) in x's dtype, plan, ch, f), so that a loss can be
    computed in the packed flat domain against :func:`pack_targets` (the
    depth-to-space is a permutation, so a sum of elementwise losses does
    not change)."""
    z = tail_apply(wts.plan, _entry(x, wts), wts.kks, wts.biases, wts.w_ops)
    return z.to(x.dtype), wts.plan, wts.ch, wts.f


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


def pack_prefix_block(h: int, w: int, kernel, bias, r: int):
    """The last pre-tail NeRVBlock's conv (HWIO kernel, bias or None,
    shuffle r) on an (h, w) grid as a 1-layer channels-first plan, its
    output channels relabeled subposition-major: (plan, kks, biases, r,
    cout*r*r), as :func:`plan_and_pack` returns a tail's."""
    kh, kw, cin, cout_rr = kernel.shape
    assert kh == kw
    wrel, brel = _relabel(kernel, bias, r)
    plan = _prefix_plan(h, w, kh, cin, cout_rr)
    layer = plan.layers[0]
    kk = _pad_kk(wrel, layer.cin, layer.cout).contiguous()
    bm = (None if brel is None else
          F.pad(brel, (0, layer.cout - cout_rr)).reshape(layer.cout, 1))
    return plan, (kk,), (bm,), r, cout_rr


def prepare_prefix_block(h: int, w: int, kernel, bias, r: int,
                         dtype=None) -> TailWeights:
    """:func:`pack_prefix_block`, cast to `dtype` if given, plus the
    kernel's weight operand on the GPU."""
    return _with_w_ops(*pack_prefix_block(h, w, kernel, bias, r),
                       dtype=dtype)


def run_fused_prefix_block(x, wts: TailWeights):
    """NHWC x (B, h, w, cin) -> the prefix conv's output (B, cout*r*r
    padded, Mp) in x's dtype, pre-PixelShuffle and pre-activation, run in
    the weights' dtype. The weights come packed by
    :func:`prepare_prefix_block`, not raw as in the JAX function."""
    return tail_apply(wts.plan, _entry(x, wts), wts.kks, wts.biases,
                      wts.w_ops).to(x.dtype)


def prefix_cf_to_nhwc(z, plan: TailPlan, r: int, out_channel: int):
    """(B, cout*r*r pad, Mp) output of run_fused_prefix_block -> NHWC
    (B, h*r, w*r, cout) PixelShuffled pre-activation, contiguous."""
    b = z.shape[0]
    hp, wp, h, w, p = plan.hp, plan.wp, plan.h, plan.w, plan.pad
    z = z[:, :out_channel * r * r, :hp * wp].reshape(b, -1, hp, wp)
    z = z[:, :, p:p + h, p:p + w].reshape(b, r, r, out_channel, h, w)
    z = z.permute(0, 4, 1, 5, 2, 3)                  # (B, h, u, w, v, c)
    return z.reshape(b, h * r, w * r, out_channel).contiguous()

