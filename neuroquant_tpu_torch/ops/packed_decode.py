"""Space-to-depth packed geometry of the high-resolution decoder tail (host
side of ``neuroquant_tpu/ops/packed_decode.py``).

A stride-1 conv with odd kernel k on (H, W, C) is exactly a conv on the
r-packed tensor (H/r, W/r, r*r*C) with a block-structured kernel of size kp;
a NeRVBlock's own PixelShuffle(r) raises the pack factor by r for free. The
tail therefore runs packed from the pack-start block on and unpacks once, at
the RGB output. Channel groups are subposition-major: packed channel g*C + c
holds subposition perm^-1[g]. See the JAX module's docstring for the
derivation.

Not ported: ``fused_tail_feasible`` and ``gate_fused_impl``. They gate the
TPU tail on its 16 MB VMEM budget; the CUDA kernels stream their operands
and have no such limit, so every plan runs the fused tail. The XLA packed
execution (``packed_conv``, ``upsample_conv_packed``) is an XLA lowering and
is not ported either: with the fused tail off, the port decodes unpacked.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def plan_packed_tail(kernels, strides, in_channels, out_channels,
                     crop_h: int, crop_w: int,
                     head_kernel: int = 3, head_out: int = 3,
                     prefer_packed: bool = False):
    """Pack-start block index minimizing the JAX package's padded-cost model
    (spatial positions x ceil(Cin/128) x ceil(Cout/128) x k^2 per conv).

    The model is the TPU MXU's and is kept unchanged so that the port
    resolves the same pack start as the reference (t=3 for HNeRV Bunny-3M).
    """
    n = len(kernels)

    def tiles(c):
        return -(-int(c) // 128)

    def res(j):
        s = int(np.prod([int(x) for x in strides[j:]]))
        return (crop_h // s) * (crop_w // s)

    def plan_cost(t):
        total = 0
        f = 1
        for j in range(n):
            k, r = int(kernels[j]), int(strides[j])
            cin, cout = int(in_channels[j]), int(out_channels[j]) * r * r
            if t is None or j <= t:
                if k % 2 == 0 and t is not None and j == t:
                    return None
                total += res(j) * tiles(cin) * tiles(cout) * k * k
            else:
                if k % 2 == 0:
                    return None
                kp, _ = packed_kernel_geometry(k, f)
                total += (res(j) // (f * f) * tiles(cin * f * f)
                          * tiles(cout * f * f) * kp * kp)
            if t is not None and j >= t:
                f *= r
        hk, hin = int(head_kernel), int(out_channels[-1])
        if t is None:
            total += crop_h * crop_w * tiles(hin) * tiles(head_out) * hk * hk
        else:
            if hk % 2 == 0:
                return None
            kp, _ = packed_kernel_geometry(hk, f)
            total += (crop_h * crop_w // (f * f) * tiles(hin * f * f)
                      * tiles(head_out * f * f) * kp * kp)
        return total

    candidates = {None: plan_cost(None)}
    for t in range(n):
        candidates[t] = plan_cost(t)
    valid = {t: c for t, c in candidates.items() if c is not None}
    return min(valid, key=lambda t: (valid[t], (t is None) if prefer_packed
                                     else (t is not None)))


@lru_cache(maxsize=128)
def _auto_pack_start(kernels, strides, in_channels, out_channels,
                     crop_h: int, crop_w: int):
    return plan_packed_tail(kernels, strides, in_channels, out_channels,
                            crop_h, crop_w)


def resolve_pack_start(packed_tail, kernels, strides, dec_norm: str,
                       in_channels, out_channels, crop_h: int, crop_w: int):
    """A config's `packed_tail` knob ('auto' | 'off' | block index) -> the
    pack-start block index, or None for the unpacked decode."""
    if dec_norm != "none" or str(packed_tail).lower() in ("off", "false",
                                                          "none"):
        return None
    if str(packed_tail).lower() in ("auto", "true"):
        return _auto_pack_start(
            tuple(int(k) for k in kernels), tuple(int(s) for s in strides),
            tuple(int(c) for c in in_channels),
            tuple(int(c) for c in out_channels), int(crop_h), int(crop_w))
    t = int(packed_tail)
    if not 0 <= t < len(kernels):
        raise ValueError(
            f"packed_tail={t} out of range for a {len(kernels)}-block decoder "
            f"(use 0..{len(kernels) - 1}, 'auto', or 'off')")
    return t


def packed_kernel_geometry(k: int, r: int) -> Tuple[int, int]:
    """(kp, offp): packed kernel size and left pad for an odd-k stride-1 conv
    executed on r-packed tensors."""
    p = (k - 1) // 2
    offp = -((-p) // r) if p else 0          # ceil(p / r)
    kp = offp + (r - 1 + p) // r + 1
    return kp, offp


@lru_cache(maxsize=256)
def _axis_map(k: int, r: int) -> np.ndarray:
    """(kp, r_in, r_out): the tap dy each (dp, a_in, i_out) reads, or k (a
    zero sentinel row) where no tap maps."""
    p = (k - 1) // 2
    kp, offp = packed_kernel_geometry(k, r)
    m = np.full((kp, r, r), k, dtype=np.int32)
    for i_out in range(r):
        for dy in range(k):
            q = i_out + dy - p
            m[q // r + offp, q % r, i_out] = dy
    return m


@lru_cache(maxsize=256)
def _inv_axis_map(k: int, r: int) -> np.ndarray:
    """(k, r_in, r_out): the dp with _axis_map[dp, a, i] == dy, or kp."""
    m = _axis_map(k, r)
    kp = m.shape[0]
    inv = np.full((k, r, r), kp, dtype=np.int32)
    for dp in range(kp):
        for a in range(r):
            for i in range(r):
                if int(m[dp, a, i]) < k:
                    inv[int(m[dp, a, i]), a, i] = dp
    return inv


def identity_perm(r: int) -> np.ndarray:
    return np.arange(r * r, dtype=np.int64)


def compose_shuffle_perm(in_perm: np.ndarray, f: int, r: int) -> np.ndarray:
    """Group layout after a PixelShuffle(r) absorbed into an f-packing:
    subposition (a*r + i, b*r + j) lives at group in_perm[a*f+b]*r*r + i*r+j."""
    fr = f * r
    out = np.empty(fr * fr, dtype=np.int64)
    for a in range(f):
        for b in range(f):
            g_outer = in_perm[a * f + b]
            for i in range(r):
                for j in range(r):
                    out[(a * r + i) * fr + b * r + j] = (g_outer * (r * r)
                                                         + i * r + j)
    return out


def space_to_depth(x: torch.Tensor, r: int, perm=None) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/r, W/r, r*r*C); subposition (u, v) at channel
    group perm[u*r+v] (identity by default)."""
    if r == 1:
        return x
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, h // r, w // r, r * r, c)
    if perm is not None:
        x = x[:, :, :, torch.as_tensor(np.argsort(np.asarray(perm)),
                                       device=x.device)]
    return x.reshape(n, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int, perm=None) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    if r == 1:
        return x
    n, h, w, gc = x.shape
    c = gc // (r * r)
    x = x.reshape(n, h, w, r * r, c)
    if perm is not None:
        x = x[:, :, :, torch.as_tensor(np.asarray(perm), device=x.device)]
    x = x.reshape(n, h, w, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c)


def _pack_impl(w_hwio: np.ndarray, r: int, in_perm, out_perm) -> np.ndarray:
    """numpy repack of a (k, k, Cin, Cout) kernel into (kp, kp, r^2 Cin,
    r^2 Cout): a pure gather, the same steps as the JAX ``_pack_impl``."""
    k = int(w_hwio.shape[0])
    assert w_hwio.shape[1] == k and k % 2 == 1, w_hwio.shape
    cin, cout = int(w_hwio.shape[2]), int(w_hwio.shape[3])
    m = _axis_map(k, r)
    kp = m.shape[0]
    wp = np.pad(w_hwio, ((0, 1), (0, 1), (0, 0), (0, 0)))   # zero sentinel
    kk = wp[m]                                   # (kp, a, i, k+1, cin, cout)
    kk = np.take(kk, m, axis=3)                  # (kp, a, i, kp, b, j, ...)
    kk = kk.transpose(0, 3, 1, 4, 6, 2, 5, 7)    # (py, px, a, b, ci, i, j, co)
    kk = kk.reshape(kp, kp, r * r, cin, r * r, cout)
    if in_perm is not None:
        kk = kk[:, :, np.argsort(np.asarray(in_perm))]
    if out_perm is not None:
        kk = kk[:, :, :, :, np.argsort(np.asarray(out_perm))]
    return kk.reshape(kp, kp, r * r * cin, r * r * cout)


@lru_cache(maxsize=64)
def _pack_index(k: int, r: int, cin: int, cout: int, in_perm_key,
                out_perm_key) -> np.ndarray:
    """Flat gather index of the packed kernel into the original kernel's
    flattened entries; k*k*cin*cout (one past the end) marks a zero."""
    iota = np.arange(1, k * k * cin * cout + 1, dtype=np.int64)
    packed = _pack_impl(iota.reshape(k, k, cin, cout), r,
                        None if in_perm_key is None else np.asarray(in_perm_key),
                        None if out_perm_key is None
                        else np.asarray(out_perm_key))
    return np.where(packed == 0, k * k * cin * cout, packed - 1)


@lru_cache(maxsize=64)
def _pack_index_t(key) -> np.ndarray:
    """Transpose of :func:`_pack_index` as a gather index: row j lists the
    flat packed slots that read entry j of the original kernel, padded with
    one past the packed end (a zero slot)."""
    k, _, cin, cout = key[:4]
    idx = _pack_index(*key).reshape(-1)
    n = k * k * cin * cout
    counts = np.bincount(idx, minlength=n + 1)[:n]
    order = np.argsort(idx, kind="stable")[:int(counts.sum())]
    col = np.arange(order.size) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    inv = np.full((n, int(counts.max())), idx.size, np.int64)
    inv[np.repeat(np.arange(n), counts), col] = order
    return inv


@lru_cache(maxsize=64)
def _pack_index_on(key, device: str, transpose: bool = False):
    return torch.as_tensor(_pack_index_t(key) if transpose
                           else _pack_index(*key), device=device)


class _PackKernel(torch.autograd.Function):
    """The packing gather, with a gather as its backward (the JAX
    ``_pack_kernel_transpose``): autograd would take ``flat[idx]`` back by a
    scatter-add whose sort serializes on the zero slot, read by most packed
    entries."""

    @staticmethod
    def forward(ctx, w_hwio, key):
        ctx.key, ctx.shape = key, w_hwio.shape
        idx = _pack_index_on(key, str(w_hwio.device))
        return torch.cat([w_hwio.reshape(-1), w_hwio.new_zeros(1)])[idx]

    @staticmethod
    def backward(ctx, g):
        inv = _pack_index_on(ctx.key, str(g.device), transpose=True)
        gf = torch.cat([g.reshape(-1), g.new_zeros(1)])
        return gf[inv].sum(dim=1).reshape(ctx.shape), None


def pack_conv_kernel(w_hwio, r: int, in_perm=None, out_perm=None):
    """Repack an odd-k stride-1 conv kernel (k, k, Cin, Cout) into the
    (kp, kp, r^2*Cin, r^2*Cout) kernel acting on r-packed tensors.

    numpy in, numpy out (plan-time structure); a torch tensor is packed by
    one gather on its own device, bit-identical to the numpy path, and its
    gradient goes back by another gather."""
    if isinstance(w_hwio, np.ndarray):
        return _pack_impl(w_hwio, r, in_perm, out_perm)
    k, _, cin, cout = (int(v) for v in w_hwio.shape)
    key = lambda p: None if p is None else tuple(int(v) for v in p)  # noqa
    return _PackKernel.apply(w_hwio, (k, r, cin, cout, key(in_perm),
                                      key(out_perm)))


@lru_cache(maxsize=128)
def packed_sparse_taps(k: int, r: int, in_perm_key: tuple | None):
    """Zero-structure of a packed kernel per output subposition group q:
    (qtaps_fwd, qtaps_t), each a tuple over q of k^2 (py, px, gin) entries
    ordered by the original tap index dy*k+dx, for the kernel and for its
    convT (tap-reversed, channel-transposed)."""
    in_perm = (np.asarray(in_perm_key, np.int64) if in_perm_key is not None
               else None)
    marker = np.arange(1.0, k * k + 1).reshape(k, k, 1, 1)
    kkm = pack_conv_kernel(marker, r, in_perm=in_perm)
    kkm_t = kkm[::-1, ::-1].transpose(0, 1, 3, 2)

    def extract(mk):
        kp, _, f2i, f2o = mk.shape
        out = []
        for q in range(f2o):
            taps = sorted(
                (int(round(mk[py, px, gin, q])) - 1, py, px, gin)
                for py in range(kp) for px in range(kp) for gin in range(f2i)
                if round(mk[py, px, gin, q]) != 0)
            assert len(taps) == k * k, (k, r, q, len(taps))
            out.append(tuple((py, px, gin) for _, py, px, gin in taps))
        return tuple(out)

    return extract(kkm), extract(kkm_t)
