"""The launch geometry of the two layout kernels (``csrc/pack_cf.cu``,
``csrc/unpack_frames.cu``), on the CPU. The kernels run only on the card;
what decides where each of their output elements comes from is the tile
(``tail_fused.pack_cf_geometry``, ``unpack_frames_geometry``), the 16-byte
cover and its offset, and the index arithmetic of each block. A numpy
emulation of each kernel's block -> element map, written from the CUDA
source, shows at the Bunny-3M, fixture and edge plans that:
- every output element is written exactly once, from the right source
  element, with zeros exactly on the border ring, the channel pad and the
  flat tail pad (pack_cf);
- every 16-byte store is aligned, every staged read lies inside what the
  block loaded, and every load lies inside the input's aligned extent, also
  when the input starts 1-3 floats past a 16-byte boundary;
- the emulated result equals ``pack_cf_ref`` exactly, and
  ``unpack_frames_ref`` exactly with the offset form of out_img and within
  1e-6 with tanh and sigmoid (the same torch function, whose vectorised
  path and scalar tail differ in the last ulp).
No JAX here: the plain versions are held against the JAX package in
test_torch_tail_fused.py."""

import numpy as np
import pytest
import torch

from _layout_cases import PACK_CASES, UNPACK_CASES, case_id, plan
from neuroquant_tpu_torch.ops import tail_fused as tf

THREADS = tf.LAYOUT_THREADS


def _memory(a, base):
    """`a` flattened as the card holds it: `base` floats past a 16-byte
    boundary, NaN on either side up to the aligned extent."""
    n = a.size
    mem = np.full(-(-(base + n) // 4) * 4, np.nan, np.float32)
    mem[base:base + n] = a.ravel()
    return mem


def _interior_before(m, h, w, pad, wp):
    r, col = divmod(m, wp)
    rows = min(max(r - pad, 0), h)
    part = min(max(col - pad, 0), w) if pad <= r < pad + h else 0
    return rows * w + part


def emulate_pack_cf(x, p, base=0):
    """csrc/pack_cf.cu block by block. Returns (out (B, c8, mp), per element
    write counts)."""
    nb, h, w, c = x.shape
    geo = tf.pack_cf_geometry(p.mp, c, nb)
    tm, c8, mp, pad, wp = geo.tm, tf._r8(c), p.mp, p.pad, p.wp
    hpwp = p.hp * wp
    assert geo.smem <= tf.LAYOUT_SMEM and mp % tm == 0 and tm % 8 == 0
    mem = _memory(x, base)
    out = np.full(nb * c8 * mp, np.nan, np.float32)
    writes = np.zeros(nb * c8 * mp, np.int32)
    pairs = tm // 8
    log_pairs = pairs.bit_length() - 1
    lane = np.arange(32)
    chl, pg = lane & 15, lane >> 4
    it = np.arange(((c8 + 15) >> 4) << log_pairs)[:, None]     # warp items
    ch = ((it >> log_pairs) << 4) + chl                         # (items, 32)
    pos = ((it & (pairs - 1)) << 3) + (pg << 2)
    live = ch < c8
    t = np.arange(tm)
    for b in range(nb):
        for bx in range(geo.blocks):
            m0 = bx * tm
            q0 = _interior_before(min(m0, hpwp), h, w, pad, wp)
            q1 = _interior_before(min(m0 + tm, hpwp), h, w, pad, wp)
            start = base + (b * h * w + q0) * c
            shift = start & 3
            nv4 = ((q1 - q0) * c + shift + 3) >> 2 if q1 > q0 else 0
            lo = start - shift
            assert 0 <= lo and lo + 4 * nv4 <= mem.size    # inside the extent
            assert 4 * nv4 <= tm * c + 8                   # fits the stage
            run = mem[lo:lo + 4 * nv4]
            m = m0 + t
            r, col = m // wp, m % wp
            inside = ((m < hpwp) & (r >= pad) & (r < pad + h) & (col >= pad)
                      & (col < pad + w))
            src = np.where(inside, shift + ((r - pad) * w + col - pad - q0)
                           * c, -1)
            flat = (b * c8 + ch) * mp + m0 + pos
            assert np.all(flat[live] % 4 == 0)             # 16-byte stores
            for i in range(4):
                s = src[pos + i]
                read = live & (ch < c) & (s >= 0)
                k = np.where(read, s + ch, 0)
                assert np.all(k[read] < run.size)          # staged data only
                v = np.where(read, run[k] if run.size else 0.0, 0.0)
                np.add.at(writes, flat[live] + i, 1)
                out[flat[live] + i] = v[live]
    return out.reshape(nb, c8, mp), writes.reshape(nb, c8, mp)


def emulate_unpack_frames(z, p, f, ch, out_bias, base=0):
    """csrc/unpack_frames.cu block by block (out_img through the torch
    function the plain version uses). Returns (out (B, h*f, w*f, c), per
    element write counts)."""
    nb, cp, mp = z.shape
    c = ch // (f * f)
    g = f * c
    h, w, pad, wp = p.h, p.w, p.pad, p.wp
    geo = tf.unpack_frames_geometry(h, w, f, c, nb)
    tx, sp, fu = geo.tx, geo.tx + 4, geo.fu
    rows = fu * g                      # staged channel rows per block
    assert f % fu == 0
    assert geo.smem == 4 * rows * sp <= tf.LAYOUT_SMEM and tx % 4 == 0
    assert geo.tiles == -(-w // tx)
    mem = _memory(z, base)
    out = np.full(nb * h * f * w * f * c, np.nan, np.float32)
    writes = np.zeros(out.size, np.int32)
    # the load phase: warp k takes rows k, k + 8, ...; its lanes the float4
    # columns q, q + 32, ...
    warps = THREADS // 32
    for nv4 in {(min(tx, w - x0) + sh + 3) >> 2 for x0 in range(0, w, tx)
                for sh in range(4)}:
        loaded = {(r, q) for t in range(THREADS)
                  for r in range(t // 32, rows, warps)
                  for q in range(t % 32, nv4, 32)}
        assert loaded == {(r, q) for r in range(rows) for q in range(nv4)}
    for b, u0 in ((b, u0) for b in range(nb) for u0 in range(0, f, fu)):
        for y in range(h):
            for tile in range(geo.tiles):
                x0 = tile * tx
                n = min(tx, w - x0)
                row0 = (base + (b * cp + u0 * g) * mp + (y + pad) * wp + pad
                        + x0)
                shift = row0 & 3
                nv4 = (n + shift + 3) >> 2
                assert 4 * nv4 <= sp                       # fits a staged row
                idx = (row0 - shift + np.arange(rows)[:, None] * mp
                       + np.arange(4 * nv4))
                assert idx.min() >= 0 and idx.max() < mem.size
                assert (row0 - shift) % 4 == 0 and mp % 4 == 0
                stage = tf.out_img(torch.from_numpy(mem[idx]), out_bias).numpy()
                length = n * g
                for u in range(fu):
                    o = ((b * h * f + y * f + u0 + u) * w + x0) * g
                    hd = min((4 - (o & 3)) & 3, length)
                    nb4 = (length - hd) >> 2
                    body = hd + 4 * np.arange(nb4)
                    assert np.all((o + body) % 4 == 0)     # 16-byte stores
                    tl = length - hd - 4 * nb4
                    assert hd + tl <= THREADS
                    e = np.concatenate([np.arange(hd), (body[:, None]
                                        + np.arange(4)).ravel(),
                                        hd + 4 * nb4 + np.arange(tl)])
                    xx, j = e // g, e % g
                    assert np.all(shift + xx < 4 * nv4)    # staged data only
                    np.add.at(writes, o + e, 1)
                    out[o + e] = stage[u * g + j, shift + xx]
    return (out.reshape(nb, h * f, w * f, c),
            writes.reshape(nb, h * f, w * f, c))


@pytest.mark.parametrize("base", [0, 3])
@pytest.mark.parametrize("case", PACK_CASES, ids=case_id)
def test_pack_cf_block_map(case, base):
    name, c, nb = case
    p, _ = plan(name)
    x = np.random.RandomState(c + nb).randn(nb, p.h, p.w, c).astype(
        np.float32)
    out, writes = emulate_pack_cf(x, p, base)
    assert np.all(writes == 1)
    want = tf.pack_cf_ref(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(out, want)
    # zeros exactly on the border ring, the channel pad and the tail pad
    live = tf._mask_np(p.h, p.w, p.pad, p.mp).reshape(-1) > 0
    assert np.all(out[:, :, ~live] == 0) and np.all(out[:, c:, :] == 0)
    assert np.count_nonzero(out[:, :c, live]) == np.count_nonzero(x)


@pytest.mark.parametrize("base", [1, 2])
def test_pack_cf_block_map_misaligned_input(base):
    """The input 1 or 2 floats past a 16-byte boundary, at the tail entry."""
    p, _ = plan("bunny")
    x = np.random.RandomState(base).randn(1, p.h, p.w, 53).astype(np.float32)
    out, writes = emulate_pack_cf(x, p, base)
    assert np.all(writes == 1)
    np.testing.assert_array_equal(
        out, tf.pack_cf_ref(torch.from_numpy(x), p).numpy())


@pytest.mark.parametrize("case", UNPACK_CASES, ids=case_id)
def test_unpack_frames_block_map(case):
    name, c, nb = case
    p, f = plan(name)
    ch = c * f * f
    cp = max(p.layers[-1].cout, tf._r8(ch))
    z = np.random.RandomState(f + c).randn(nb, cp, p.mp).astype(np.float32)
    for out_bias, base in (("tanh", 0), ("0.0", 1), ("sigmoid", 2)):
        out, writes = emulate_unpack_frames(z, p, f, ch, out_bias, base)
        assert np.all(writes == 1), out_bias
        want = tf.unpack_frames_ref(torch.from_numpy(z), p, f, ch,
                                    out_bias).numpy()
        # the offset form is exact; torch's vectorised tanh and sigmoid
        # differ from their scalar tails in the last ulp
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=0 if out_bias == "0.0" else 1e-6)


@pytest.mark.parametrize("base", [1, 2, 3])
def test_unpack_frames_block_map_misaligned_input(base):
    """z 1-3 floats past a 16-byte boundary, at the Bunny-3M decode: the
    cover's offset changes, the staged reads and the stores do not."""
    p, f = plan("bunny")
    z = np.random.RandomState(base).randn(1, 48, p.mp).astype(np.float32)
    out, writes = emulate_unpack_frames(z, p, f, 48, "0.0", base)
    assert np.all(writes == 1)
    np.testing.assert_array_equal(
        out, tf.unpack_frames_ref(torch.from_numpy(z), p, f, 48,
                                  "0.0").numpy())


def test_pack_cf_tiles():
    """128 positions at the Bunny tail entry (416 blocks a frame); the
    prefix entry's 4096 positions in tiles of 16, so that its 1.9 MB spreads
    over the card; wide channel counts take smaller tiles."""
    assert tf.pack_cf_geometry(53248, 53, 1) == (128, 416, 27680)
    assert tf.pack_cf_geometry(53248, 53, 2).tm == 128
    assert tf.pack_cf_geometry(4096, 64, 1) == (16, 256, 4192)
    assert tf.pack_cf_geometry(4096, 64, 2).tm == 16
    assert tf.pack_cf_geometry(53248, 100, 1).tm == 64
    for mp, c, nb in ((640, 5, 2), (256, 100, 2), (53248, 1, 1),
                      (2048, 700, 1)):
        geo = tf.pack_cf_geometry(mp, c, nb)
        assert geo.tm in (8, 16, 32, 64, 128) and mp % geo.tm == 0
        assert geo.smem <= tf.LAYOUT_SMEM
    with pytest.raises(ValueError, match="do not fit"):
        tf.pack_cf_geometry(2048, 2000, 1)


def test_unpack_frames_tiles():
    """Three spans of 108 columns and all 4 output rows a block at the
    Bunny decode (480 blocks); the compile-time g for the configs' f = 2,
    3, 4, 6 at c = 3, the generic kernel for the rest; one output row a
    block where blocks would be few."""
    geo = tf.unpack_frames_geometry(160, 320, 4, 3, 1)
    assert geo == (108, 3, 4, 4 * 48 * 112, 12)
    assert [tf.unpack_frames_geometry(160, 320, f, 3, 1).g_template
            for f in (1, 2, 3, 4, 5, 6)] == [0, 6, 9, 12, 0, 18]
    assert tf.unpack_frames_geometry(160, 320, 6, 3, 1).tx == 108
    assert tf.unpack_frames_geometry(4, 480, 4, 3, 2)[:3] == (120, 4, 1)
    assert tf.unpack_frames_geometry(160, 320, 4, 3, 2).fu == 4
    assert tf.unpack_frames_geometry(5, 37, 4, 13, 1).tx == 40
    assert tf.unpack_frames_geometry(160, 320, 4, 13, 1).tx == 48
    with pytest.raises(ValueError, match="do not fit"):
        tf.unpack_frames_geometry(16, 16, 6, 1000, 1)


def test_launch_parameter_blocks():
    """The parameter blocks the C launchers read, in their order, made once
    per plan geometry and shape."""
    p, f = plan("bunny")
    shape, arr, addr = tf._pack_cf_launch(2, p.h, p.w, p.pad, p.tm, 53)
    assert shape == (2, 56, p.mp)
    assert list(arr) == [2, 160, 320, 53, 56, 2, p.mp, 128]
    assert tf._pack_cf_launch(2, p.h, p.w, p.pad, p.tm, 53)[2] == addr
    mp, shape, arr, _, offset = tf._unpack_frames_launch(
        1, 48, p.h, p.w, p.pad, p.tm, f, 48, "tanh")
    assert (mp, shape, offset) == (p.mp, (1, 640, 1280, 3), 0.0)
    assert list(arr) == [1, 48, p.mp, 160, 320, 2, 4, 3, 1, 108, 4]
    assert tf._unpack_frames_launch(1, 48, p.h, p.w, p.pad, p.tm, f, 48,
                                    "0.25")[4] == 0.25
    with pytest.raises(ValueError, match="do not unpack"):
        tf._unpack_frames_launch(1, 48, p.h, p.w, p.pad, p.tm, f, 47, "tanh")
