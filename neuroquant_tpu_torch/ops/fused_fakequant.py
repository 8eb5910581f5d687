"""Fused Hadamard-domain fake-quantization of conv weights on CUDA kernels
(the counterpart of ``neuroquant_tpu/ops/pallas_fakequant.py``).

The calibration and evaluation paths quantize a weight as FWHT over C_in ->
uniform affine (or AdaRound) fake-quant -> inverse FWHT. The plain chain
(:func:`fake_quant_ref`, what ``quantization/qmodel.py`` runs under
``fq_impl='jnp'``) takes log2(C) butterfly stages of small tensor
operations, twice per layer; ``csrc/fq_hadamard.cu`` does the whole chain
for a group of layers in one launch, with the transform as a butterfly in
registers, and its backward in one more.

:func:`fake_quant_group` takes every layer of a ``quantize_params`` call,
each with its own rounding (UAQ, AdaRound soft or hard: the
mixed-rounding state is one group). It is differentiable: one forward
launch, and a backward launch that writes the plain chain's VJP in closed
form (:func:`fake_quant_vjp_ref` is that arithmetic in plain torch
operations): straight-through rounding, half the gradient on a clip bound,
none through ``floor``, the rectified sigmoid's for alpha. The gradients
are those of the JAX package's ``pallas_uaq_fake_quant`` and
``pallas_ada_fake_quant``, which differentiate their plain chain. The
backward is first-order (``once_differentiable``), as the JAX custom VJP.
Select it with ``QuantSpec(fq_impl='pallas')`` or ``calibrate_network
--fq_impl pallas`` (the value keeps the JAX package's name and selects the
CUDA kernels).

On a CUDA tensor the group launches the kernels or raises (C_in padding
past ``MAX_C``, a kernel taller than ``MAX_BLOCK_ROWS`` rows); on a CPU
tensor it runs :func:`fake_quant_ref` per layer forward and
:func:`fake_quant_vjp_ref` backward. :func:`fused_fake_quant_hwio` (forward
only), :func:`uaq_fake_quant` and :func:`ada_fake_quant` are one-layer
groups. The kernels read the weights, alphas and gradients where they lie
(any HWIO view whose two kernel axes share one stride, as the HWIO view of
an OIHW parameter) and write OIHW results, returned as HWIO views of one
allocation per launch: no transpose, pad or crop around them.

Launch counts (``tail_fused.KERNEL_LAUNCHES``): a forward launch counts
under ``fq_ada`` when any layer of its group rounds by AdaRound, else under
``fq_uaq``; its backward under ``fq_ada_bwd`` or ``fq_uaq_bwd`` the same
way. So a mixed-rounding ``quantize_params`` call counts one ``fq_ada``
launch. A group of more than ``MAX_LAYERS`` layers launches once per
``MAX_LAYERS``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from neuroquant_tpu_torch.ops import _cuda
from neuroquant_tpu_torch.ops import quant as Q
from neuroquant_tpu_torch.ops.hadamard import (
    fwht, next_power_of_two, pad_cin_to_pow2)
from neuroquant_tpu_torch.ops.tail_fused import _launch, _needs_grad, _route

MAX_C = 1024          # the kernels' widest padded C_in: 32 registers a lane
MAX_LAYERS = 16       # layers in one launch's descriptor
MAX_BLOCK_ROWS = 256  # rows whose sums one block keeps (the kernel's KH*KW)
FQ_WARPS = 8          # warps per block (the kernels' THREADS / 32)
STAGE_FLOATS = 5632   # a tile buffer's floats (two and the sums: 48 KB)
FILL = 0.75           # the least share of a block's row slots in use
MODE_UAQ, MODE_ADA_SOFT, MODE_ADA_HARD = 0, 1, 2
NEED_W, NEED_DELTA, NEED_ZP, NEED_ALPHA = 1, 2, 4, 8


def fake_quant_ref(w, delta, zp, alpha, n_bits: int, hadamard: bool,
                   soft: bool = True):
    """The plain chain on an HWIO weight (the JAX ``_jnp_reference``); UAQ
    when ``alpha`` is None, else AdaRound."""
    cin = w.shape[2]
    x = fwht(pad_cin_to_pow2(w), axis=2) if hadamard else w
    if alpha is None:
        xq = Q.uaq_fake_quant(x, delta, zp, n_bits)
    else:
        xq = Q.adaround_fake_quant(x, delta, zp, alpha, n_bits, soft=soft)
    if hadamard:
        xq = fwht(xq, axis=2)[:, :, :cin, :]     # self-inverse; crop the pad
    return xq


@lru_cache(maxsize=None)
def _inv_sqrt(n: int) -> float:
    """The fp32 reciprocal of sqrt(n), as ops/hadamard.fwht multiplies by."""
    return float(1.0 / torch.sqrt(torch.tensor(float(n))))


def fwht_t(g, axis: int):
    """The transpose of :func:`fwht` as autograd computes it: the multiply
    by 1/sqrt(n) first, then the butterfly stages from the widest down."""
    n = g.shape[axis]
    g = torch.movedim(g, axis, -1)
    lead = g.shape[:-1]
    g = g * _inv_sqrt(n)
    for s in reversed(range(n.bit_length() - 1)):
        half = 1 << s
        g = g.reshape(*lead, n // (2 * half), 2, half)
        a, b = g[..., 0, :], g[..., 1, :]
        g = torch.cat([a + b, a - b], dim=-1).reshape(*lead, n)
    return torch.movedim(g, -1, axis)


def _clip_mask(x, hi: float):
    """The gradient share of ``_clip(x, 0, hi)``: 1 inside, 1/2 on a bound,
    0 outside."""
    inside = ((x > 0) & (x < hi)).to(x.dtype)
    return inside + 0.5 * ((x == 0) | (x == hi)).to(x.dtype)


def _sum_like(t, like):
    return t.sum() if like.dim() == 0 else t.sum_to_size(like.shape)


def fake_quant_vjp_ref(g, w, delta, zp, alpha, n_bits: int, hadamard: bool,
                       soft: bool = True, needs=(True, True, True, True),
                       sum_like=_sum_like):
    """The VJP of :func:`fake_quant_ref` at (w, delta, zp, alpha) for the
    cotangent g, in closed form: (dw, ddelta, dzp, dalpha), None where
    ``needs`` asks for none or the chain passes none (alpha under UAQ or
    hard rounding). Each product is the one autograd takes through the
    plain chain, in its order, and each sum is split as autograd's
    accumulation splits it, so the values are autograd's (to the bit on the
    CPU, where the two reduce alike). ``sum_like(term, scale)`` sums a term
    to a scale's shape; summing magnitudes there gives what bounds the
    reduced gradients' rounding (their halves cancel)."""
    cin = w.shape[2]
    if hadamard:
        x = fwht(pad_cin_to_pow2(w), axis=2)
        gq = fwht_t(F.pad(g, (0, 0, 0, x.shape[2] - cin)), 2)
    else:
        x, gq = w, g
    qmax = 2.0 ** n_bits - 1
    t = x / delta
    if alpha is None:
        xz = torch.round(t) + zp
    else:
        if soft:
            s = torch.sigmoid(alpha)
            hp = s * (Q.ZETA - Q.GAMMA) + Q.GAMMA
            h = torch.clamp(hp, 0.0, 1.0)
        else:
            h = (alpha >= 0).to(x.dtype)
        xz = (torch.floor(t) + h) + zp
    m = _clip_mask(xz, qmax)
    q = torch.clamp(xz, 0.0, qmax)
    a = gq * delta
    ma = m * a
    dw = ddelta = dzp = dalpha = None
    if needs[1]:
        ddelta = sum_like(gq * (q - zp), delta)
        if alpha is None:      # and through x / delta
            ddelta = ddelta + sum_like((-ma) * ((x / delta) / delta), delta)
    if needs[2]:
        dzp = sum_like(ma, zp) + sum_like(-a, zp)
    if needs[0]:
        if alpha is None:
            dx = ma / delta
            dw = fwht_t(dx, 2)[:, :, :cin, :] if hadamard else dx
        else:
            dw = torch.zeros_like(w)      # floor passes nothing
    if needs[3] and alpha is not None and soft:
        dalpha = (((ma * _clip_mask(hp, 1.0)) * (Q.ZETA - Q.GAMMA))
                  * (1 - s)) * s
    return dw, ddelta, dzp, dalpha


# --------------------------------------------------------------------------
# The launch geometry and descriptors
# --------------------------------------------------------------------------
class FqGeometry(NamedTuple):
    c: int          # the lanes' width: C_in padded to a power of two
    cq: int         # the quantization domain's width: c, or C_in
    lanes: int      # lanes per row
    v: int          # values per lane
    cpb: int        # output channels per block
    blocks: int
    staged: bool    # the block's tensors go through shared memory


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=256)
def fq_geometry(cout: int, kk: int, cin: int, hadamard: bool,
                ada: bool) -> FqGeometry:
    """How the kernels cover a layer: a block takes ``cpb`` whole output
    channels (all their rows, so their sums stay in the block), as many as
    fill at least ``FILL`` of its row slots over its passes, and stages
    them in shared memory when they fit. The forward and the backward share
    it; tests/test_torch_fq_backward.py emulates the map."""
    c = next_power_of_two(cin)
    if c > MAX_C:
        raise ValueError(f"fused_fake_quant: C_in {cin} pads to {c}; the "
                         f"kernel transforms at most {MAX_C} channels")
    if kk > MAX_BLOCK_ROWS:
        raise ValueError(f"fused_fake_quant: {kk} kernel positions; the "
                         f"kernel takes at most {MAX_BLOCK_ROWS}")
    lanes = min(c, 32)
    rpi = FQ_WARPS * (32 // lanes)

    def fill(n):
        return n * kk / (_cdiv(n * kk, rpi) * rpi)

    base = max(1, min(rpi // kk, cout, MAX_BLOCK_ROWS // kk))
    cpb = base
    while (fill(cpb) < FILL and cpb < cout
           and (cpb + 1) * kk <= MAX_BLOCK_ROWS):
        cpb += 1
    if fill(cpb) < FILL:
        cpb = base
    cq = c if hadamard else cin
    per_channel = (2 * cin + (cq if ada else 0)) * kk   # the backward's
    while cpb > 1 and cpb * per_channel > STAGE_FLOATS:
        cpb -= 1
    return FqGeometry(c, cq, lanes, c // lanes, cpb, _cdiv(cout, cpb),
                      cpb * per_channel <= STAGE_FLOATS)


class _View(ctypes.Structure):
    _fields_ = [("so", ctypes.c_int), ("sk", ctypes.c_int),
                ("sc", ctypes.c_int)]


class _Layer(ctypes.Structure):
    """The mirror of ``struct Layer`` in csrc/fq_hadamard.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "w", "alpha", "delta", "zp", "out", "g", "dw", "dalpha", "ddelta",
        "dzp")] + [(n, _View) for n in ("wv", "av", "gv")] + [
        (n, ctypes.c_int) for n in (
            "cout", "kk", "cin", "cq", "lanes", "v", "levels", "mode",
            "dstride", "hadamard", "block0", "cpb", "staged", "need")] + [
        ("inv", ctypes.c_float)]


class _Group(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("blocks", ctypes.c_int),
                ("layer", _Layer * MAX_LAYERS)]


@lru_cache(maxsize=1)
def _lib():
    lib = _cuda.lib()
    if lib.nq_fq_group_bytes() != ctypes.sizeof(_Group):
        raise RuntimeError(
            f"fq_hadamard: the kernel's Group is {lib.nq_fq_group_bytes()} "
            f"bytes, its mirror {ctypes.sizeof(_Group)}")
    if lib.nq_fq_threads() != 32 * FQ_WARPS:
        raise RuntimeError(
            f"fq_hadamard: the kernels take {lib.nq_fq_threads()} threads a "
            f"block, the tile map {32 * FQ_WARPS}")
    return lib


def _row_strides(t):
    """(so, sk, sc) element strides of an HWIO tensor over (C_out, the
    flattened kernel position ky * KW + kx, C_in), or None when the two
    kernel axes do not share one stride."""
    kh, kw = t.shape[:2]
    s0, s1, sc, so = t.stride()
    if kh == 1 or s0 == kw * s1:
        sk = s1
    elif kw == 1:
        sk = s0
    else:
        return None
    return so, sk, sc


def _dense(t) -> bool:
    """No element of t's storage span is skipped or aliased."""
    expect = 1
    for st, n in sorted((st, n) for st, n in zip(t.stride(), t.shape)
                        if n != 1):
        if st != expect:
            return False
        expect *= n
    return True


def _strided(t, dense: bool = False):
    """t as the kernels read it, with its (so, sk, sc) strides: a
    contiguous copy when its kernel axes do not share a stride (or, with
    ``dense``, when its storage has gaps), else t itself."""
    strides = _row_strides(t)
    if (strides is None or max(map(abs, strides)) >= 2 ** 31
            or (dense and not _dense(t))):
        t = t.contiguous()
        strides = _row_strides(t)
    return t, strides


def _scale_rows(s, cout: int, name: str, like):
    """A delta or zero point as a flat fp32 tensor of C_out values (stride
    1) or one (stride 0)."""
    if s.device != like.device or s.dtype != torch.float32:
        raise ValueError(f"fused_fake_quant {name}: expected fp32 on "
                         f"{like.device}, got {s.dtype} on {s.device}")
    if s.numel() not in (1, cout):
        raise ValueError(f"fused_fake_quant {name}: {s.numel()} values for "
                         f"{cout} output channels")
    return s.reshape(-1).contiguous(), int(s.numel() != 1)


class _Prepared(NamedTuple):
    """One layer of a launch: its tensors as the kernel reads them, and
    what its descriptor holds besides pointers."""
    w: torch.Tensor
    delta: torch.Tensor
    zp: torch.Tensor
    alpha: torch.Tensor | None
    shape: tuple          # (kh, kw, cin, cout)
    key: tuple            # the descriptor's fields other than pointers
    copied: bool          # an input was copied to suit the kernel


def _prepare(w_hwio, delta, zp, alpha, n_bits: int, hadamard: bool,
             soft: bool) -> _Prepared:
    """Check one layer for the kernels, which raise rather than fall back
    on what they do not take."""
    if w_hwio.dim() != 4 or w_hwio.dtype != torch.float32:
        raise ValueError("fused_fake_quant w: expected a 4-D fp32 HWIO "
                         f"weight, got {tuple(w_hwio.shape)} {w_hwio.dtype}")
    kh, kw, cin, cout = w_hwio.shape
    geo = fq_geometry(cout, kh * kw, cin, hadamard, alpha is not None)
    d, dstride = _scale_rows(delta, cout, "delta", w_hwio)
    z, zstride = _scale_rows(zp, cout, "zp", w_hwio)
    if dstride != zstride:
        raise ValueError("fused_fake_quant: delta and zp differ in shape")
    w, wv = _strided(w_hwio.detach())
    copied = w.data_ptr() != w_hwio.data_ptr()
    av = (0, 0, 0)
    if alpha is None:
        mode = MODE_UAQ
    else:
        mode = MODE_ADA_SOFT if soft else MODE_ADA_HARD
        if (tuple(alpha.shape) != (kh, kw, geo.cq, cout)
                or alpha.dtype != torch.float32
                or alpha.device != w.device):
            raise ValueError(
                f"fused_fake_quant alpha: expected fp32 "
                f"{(kh, kw, geo.cq, cout)} on {w.device}, got {alpha.dtype} "
                f"{tuple(alpha.shape)} on {alpha.device}")
        # dense, as its gradient takes its strides
        a, av = _strided(alpha.detach(), dense=True)
        copied |= a.data_ptr() != alpha.data_ptr()
        alpha = a
    copied |= (d.data_ptr() != delta.data_ptr()
               or z.data_ptr() != zp.data_ptr())
    key = (cout, kh * kw, cin, 2 ** n_bits, mode, dstride, int(hadamard),
           wv, av)
    return _Prepared(w, d.detach(), z.detach(), alpha, (kh, kw, cin, cout),
                     key, copied)


def _descriptor(keys: tuple, backward: bool) -> _Group:
    """A launch's Group with every field but the per-call pointers
    filled."""
    grp = _Group()
    grp.n = len(keys)
    block0 = 0
    for lay, (layer_key, extra) in zip(grp.layer, keys):
        cout, kk, cin, levels, mode, dstride, had, wv, av = layer_key
        geo = fq_geometry(cout, kk, cin, bool(had), mode != MODE_UAQ)
        lay.wv = _View(*wv)
        lay.av = _View(*av)
        if backward:
            lay.gv = _View(*extra[0])
            lay.need = extra[1]
        lay.cout, lay.kk, lay.cin, lay.cq = cout, kk, cin, geo.cq
        lay.lanes, lay.v, lay.levels, lay.mode = geo.lanes, geo.v, levels, mode
        lay.dstride, lay.hadamard, lay.block0 = dstride, had, block0
        lay.cpb, lay.staged = geo.cpb, int(geo.staged)
        lay.inv = _inv_sqrt(geo.c)
        block0 += geo.blocks
    grp.blocks = block0
    return grp


def _kernel_name(layers) -> str:
    return "fq_ada" if any(p.alpha is not None for p in layers) else "fq_uaq"


def _chunks(items):
    return [items[i:i + MAX_LAYERS] for i in range(0, len(items),
                                                    MAX_LAYERS)]


class _Launch(NamedTuple):
    name: str
    grp: _Group           # the input pointers in place
    layers: tuple         # indices into the call's layers


class _Plan(NamedTuple):
    """A call's launches with their descriptors, and where each layer's
    results lie in the call's allocations: what repeats from one call to
    the next with the same inputs (a calibration's steps, an evaluation's
    batches), so a repeated call refills only its output pointers."""
    launches: tuple
    shapes: tuple         # per layer (kh, kw, cin, cout)
    offsets: tuple        # per layer: forward, its result; backward, (dw,
    #                       dalpha, sums) offsets, -1 where not written
    alpha_strides: tuple  # per layer: the strides dalpha takes
    sizes: tuple          # elements of the call's allocations


# plans by the signature of their inputs; a call with new inputs plans anew
_PLANS: dict = {}
_MAX_PLANS = 64


def _signature(lay, extra=()):
    w, d, z, a, bits, soft = lay
    return (w.data_ptr(), w.shape, w.stride(), w.dtype, d.data_ptr(),
            d.shape, d.dtype, z.data_ptr(), z.shape, z.dtype,
            None if a is None else (a.data_ptr(), a.shape, a.stride(),
                                    a.dtype), bits, soft, *extra)


def _remember(key, plan, prep):
    """Keep a plan for its inputs, unless an input was copied to suit the
    kernel (its copy is made anew by every call)."""
    if any(p.copied for p in prep):
        return
    if len(_PLANS) >= _MAX_PLANS:
        _PLANS.clear()
    _PLANS[key] = plan


def _fill_inputs(lay, p: _Prepared):
    lay.w, lay.delta, lay.zp = (p.w.data_ptr(), p.delta.data_ptr(),
                                p.zp.data_ptr())
    lay.alpha = None if p.alpha is None else p.alpha.data_ptr()


def _hwio_view(flat, shape, offset: int):
    """The HWIO view of an OIHW result at `offset` of `flat`."""
    kh, kw, cin, cout = shape
    return flat.as_strided((kh, kw, cin, cout),
                           (kw, 1, kh * kw, cin * kh * kw), offset)


def _route_group(layers) -> bool:
    """:func:`_route` for a whole group: every tensor of every layer must
    lie on the first weight's device, so a CUDA tensor never reaches the
    plain chain and a CPU one never the kernels."""
    dev = layers[0][0].device
    for i, lay in enumerate(layers):
        for name, t in zip(("w", "delta", "zp", "alpha"), lay[:4]):
            if t is not None and t.device != dev:
                raise ValueError(
                    f"fused_fake_quant {name} of layer {i}: on {t.device}, "
                    f"the first weight on {dev}; the layers lie on several "
                    "devices")
    return _route(layers[0][0], "fused_fake_quant")


def _forward(layers, hadamard: bool):
    """The fake-quantized HWIO weights of every layer, (w, delta, zp, alpha
    | None, n_bits, soft) each: one kernel launch per ``MAX_LAYERS``
    layers on the card, the plain chain on the CPU."""
    if not _route_group(layers):
        return [fake_quant_ref(w, d, z, a, b, hadamard, s)
                for w, d, z, a, b, s in layers]
    key = (False, hadamard, tuple(map(_signature, layers)))
    plan, prep = _PLANS.get(key), None
    if plan is None:
        prep = [_prepare(*lay[:5], hadamard, lay[5]) for lay in layers]
        offsets = [0]
        for p in prep:
            offsets.append(offsets[-1] + p.w.numel())
        launches = []
        for part in _chunks(list(range(len(prep)))):
            grp = _descriptor(tuple((prep[i].key, None) for i in part),
                              False)
            for lay, i in zip(grp.layer, part):
                _fill_inputs(lay, prep[i])
            launches.append(_Launch(_kernel_name([prep[i] for i in part]),
                                    grp, tuple(part)))
        plan = _Plan(tuple(launches), tuple(p.shape for p in prep),
                     tuple(offsets[:-1]), (), (offsets[-1],))
        _remember(key, plan, prep)
    flat = layers[0][0].new_empty(plan.sizes[0])
    base, lib = flat.data_ptr(), _lib()
    for launch in plan.launches:
        for lay, i in zip(launch.grp.layer, launch.layers):
            lay.out = base + 4 * plan.offsets[i]
        _launch(launch.name, lib.nq_fq_group_forward,
                ctypes.addressof(launch.grp))
    return [_hwio_view(flat, shape, off)
            for shape, off in zip(plan.shapes, plan.offsets)]


def _need_flags(layer, need) -> int:
    nw, nd, nz, na = need
    na = na and layer[3] is not None and layer[5]   # hard rounding: none
    return NEED_W * nw + NEED_DELTA * nd + NEED_ZP * nz + NEED_ALPHA * na


def _backward(layers, hadamard: bool, gs, needs):
    """Per layer the gradients (w, delta, zp, alpha) of :func:`_forward`'s
    outputs for the cotangents gs, None where ``needs`` (4 flags a layer)
    asks for none: one backward launch per ``MAX_LAYERS`` layers that need
    any on the card, :func:`fake_quant_vjp_ref` on the CPU."""
    if not _route_group(layers):
        return [fake_quant_vjp_ref(g, w, d, z, a, b, hadamard, s, nd)
                if any(nd) and g is not None else (None,) * 4
                for (w, d, z, a, b, s), g, nd in zip(layers, gs, needs)]
    flags = [0 if g is None else _need_flags(lay, nd)
             for lay, g, nd in zip(layers, gs, needs)]
    todo = [i for i, f in enumerate(flags) if f]
    grads = [(None,) * 4] * len(layers)
    if not todo:
        return grads
    for i in todo:
        g = gs[i]
        if (g.dtype != torch.float32 or g.dim() != 4
                or g.shape != layers[i][0].shape):
            raise ValueError(f"fused_fake_quant backward: expected an fp32 "
                             f"{tuple(layers[i][0].shape)} gradient, got "
                             f"{g.dtype} {tuple(g.shape)}")
    gviews = {i: _strided(gs[i].detach()) for i in todo}
    key = (True, hadamard, tuple(_signature(layers[i], (
        gviews[i][1], flags[i])) for i in todo), tuple(todo))
    plan, prep = _PLANS.get(key), None
    if plan is None:
        prep = {i: _prepare(*layers[i][:5], hadamard, layers[i][5])
                for i in todo}
        if any(gviews[i][0].device != prep[i].w.device for i in todo):
            raise ValueError("fused_fake_quant backward: the gradient lies "
                             "on another device than its weight")
        offsets, big, small = [], 0, 0
        for i in todo:
            p, f = prep[i], flags[i]
            dw = da = -1
            if f & NEED_W:
                dw, big = big, big + p.w.numel()
            if f & NEED_ALPHA:
                da, big = big, big + p.alpha.numel()
            offsets.append((dw, da, small))
            small += 2 * p.shape[3]
        launches = []
        for part in _chunks(list(range(len(todo)))):
            grp = _descriptor(tuple((prep[todo[j]].key, (
                gviews[todo[j]][1], flags[todo[j]])) for j in part), True)
            for lay, j in zip(grp.layer, part):
                _fill_inputs(lay, prep[todo[j]])
            launches.append(_Launch(
                _kernel_name([prep[todo[j]] for j in part]) + "_bwd", grp,
                tuple(part)))
        plan = _Plan(tuple(launches), tuple(prep[i].shape for i in todo),
                     tuple(offsets),
                     tuple(None if prep[i].alpha is None
                           else prep[i].alpha.stride() for i in todo),
                     (big, small))
        _remember(key, plan, list(prep.values()))
    ref = layers[todo[0]][0]
    flat, sums = ref.new_empty(plan.sizes[0]), ref.new_empty(plan.sizes[1])
    fbase, sbase, lib = flat.data_ptr(), sums.data_ptr(), _lib()
    for launch in plan.launches:
        for lay, j in zip(launch.grp.layer, launch.layers):
            dw, da, sm = plan.offsets[j]
            cout = plan.shapes[j][3]
            lay.g = gviews[todo[j]][0].data_ptr()
            lay.dw = None if dw < 0 else fbase + 4 * dw
            lay.dalpha = None if da < 0 else fbase + 4 * da
            lay.ddelta, lay.dzp = sbase + 4 * sm, sbase + 4 * (sm + cout)
        _launch(launch.name, lib.nq_fq_group_backward,
                ctypes.addressof(launch.grp))
    for j, i in enumerate(todo):
        (dw, da, sm), shape, f = plan.offsets[j], plan.shapes[j], flags[i]
        cout, delta, zp, alpha = shape[3], *layers[i][1:4]

        def scale(part, like):
            # per-layer scales: the channel sums summed in a fixed order
            return (part.view(like.shape) if like.numel() == cout
                    else part.sum().reshape(like.shape))

        grads[i] = (
            None if dw < 0 else _hwio_view(flat, shape, dw),
            scale(sums[sm:sm + cout], delta) if f & NEED_DELTA else None,
            scale(sums[sm + cout:sm + 2 * cout], zp) if f & NEED_ZP
            else None,
            None if da < 0 else flat.as_strided(
                alpha.shape, plan.alpha_strides[j], da))
    return grads


class _FakeQuantGroup(torch.autograd.Function):
    """Kernel forward and backward over a group of layers; the tensors come
    as (w, delta, zp, alpha | None) per layer, ``cfg`` as (hadamard,
    ((n_bits, soft), ...))."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.cfg = cfg
        return tuple(_forward(_layers(cfg, tensors), cfg[0]))

    @staticmethod
    @once_differentiable
    def backward(ctx, *gs):
        cfg, need = ctx.cfg, ctx.needs_input_grad[1:]
        grads = _backward(_layers(cfg, ctx.saved_tensors), cfg[0], gs,
                          [need[4 * i:4 * i + 4] for i in range(len(gs))])
        return (None, *(g for four in grads for g in four))


def _layers(cfg, tensors):
    return [(*tensors[4 * i:4 * i + 4], bits, soft)
            for i, (bits, soft) in enumerate(cfg[1])]


def fake_quant_group(layers, hadamard: bool):
    """Fused (FWHT ->) fake-quant (-> inverse FWHT) of several HWIO conv
    weights, one kernel launch for them all, differentiable. ``layers``:
    (w, delta, zp, alpha | None, n_bits, soft) each, delta/zp per channel
    (1, 1, 1, C_out) or 0-d, alpha (AdaRound) the quantization-domain
    tensor (KH, KW, C_in padded, C_out) or None for UAQ. Returns the list
    of fake-quantized weights, the values of :func:`fake_quant_ref`."""
    cfg = (bool(hadamard), tuple((int(b), bool(s))
                                 for *_, b, s in layers))
    tensors = [t for lay in layers for t in lay[:4]]
    if _needs_grad(*tensors):
        return list(_FakeQuantGroup.apply(cfg, *tensors))
    return _forward(layers, hadamard)


def fused_fake_quant_hwio(w_hwio, delta, zp, n_bits: int,
                          hadamard: bool = True, alpha=None,
                          soft: bool = True):
    """One layer's fused fake-quant, forward only: the kernel on a CUDA
    tensor, :func:`fake_quant_ref` on a CPU one."""
    if not _route_group([(w_hwio, delta, zp, alpha)]):
        return fake_quant_ref(w_hwio, delta, zp, alpha, n_bits, hadamard,
                              soft)
    return _forward([(w_hwio, delta, zp, alpha, n_bits, soft)], hadamard)[0]


def uaq_fake_quant(w, delta, zp, n_bits: int, hadamard: bool):
    """UAQ fake-quant of an HWIO weight: fused forward, the plain chain's
    straight-through gradients (the JAX ``pallas_uaq_fake_quant``)."""
    return fake_quant_group([(w, delta, zp, None, n_bits, True)],
                            hadamard)[0]


def ada_fake_quant(w, delta, zp, alpha, n_bits: int, hadamard: bool,
                   soft: bool):
    """AdaRound fake-quant: fused forward; alpha gets the rectified
    sigmoid's gradient, w none through the floor (the JAX
    ``pallas_ada_fake_quant``)."""
    return fake_quant_group([(w, delta, zp, alpha, n_bits, soft)],
                            hadamard)[0]
