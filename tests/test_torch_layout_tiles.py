"""The launch geometry of the three layout kernels (``csrc/pack_cf.cu``,
``csrc/unpack_cf.cu``, ``csrc/unpack_frames.cu``), on the CPU. The kernels
run only on the card; what decides where each of their output elements
comes from is the tile (``tail_fused.pack_cf_geometry``,
``unpack_cf_geometry``, ``unpack_frames_geometry``), the 16-byte cover and
its offset, and the index arithmetic of each block. A numpy emulation of
each kernel's block -> element map, written from the CUDA source, shows at
the Bunny-3M, fixture and edge plans that:
- every output element is written exactly once, from the right source
  element, with zeros exactly on the border ring, the channel pad and the
  flat tail pad (pack_cf); no border, channel-pad or tail-pad element of
  the input reaches the output (unpack_cf);
- every 16-byte store is aligned, every staged read lies inside what the
  block loaded, and every load lies inside the input's aligned extent, also
  when the input starts 1-3 floats past a 16-byte boundary;
- the emulated result equals ``pack_cf_ref`` and ``unpack_cf_ref``
  exactly, and ``unpack_frames_ref`` exactly with the offset form of
  out_img and within 1e-6 with tanh and sigmoid (the same torch function,
  whose vectorised path and scalar tail differ in the last ulp).
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


def emulate_unpack_cf(g, p, c, base=0):
    """csrc/unpack_cf.cu block by block. Returns (out (B, h, w, c), per
    element write counts)."""
    nb, c8, mp = g.shape
    h, w, pad, wp = p.h, p.w, p.pad, p.wp
    hw = h * w
    geo = tf.unpack_cf_geometry(h, w, pad, c, nb)
    tq, tcap = geo.tm, tf._unpack_cf_table(geo.tm, w, pad)
    assert geo.smem == 4 * tcap + 4 * (tq * c + 4) <= tf.LAYOUT_SMEM
    assert geo.blocks == -(-hw // tq) and tq in (8, 16, 32, 64, 128)
    assert mp % 4 == 0 and tcap % 4 == 0
    mem = _memory(g, base)
    out = np.full(nb * hw * c, np.nan, np.float32)
    writes = np.zeros(out.size, np.int32)
    chans = np.arange(c)[:, None]
    covered = set()
    for b in range(nb):
        for bx in range(geo.blocks):
            q0 = bx * tq
            q1 = min(q0 + tq, hw)
            y0, yl = q0 // w, (q1 - 1) // w
            m_lo = (y0 + pad) * wp + pad + q0 - y0 * w
            m_hi = (yl + pad) * wp + pad + (q1 - 1 - yl * w) + 1
            first = b * c8 * mp + m_lo
            row0 = base + first
            shift = row0 & (7 if first >= 8 else 3)    # 32-byte sectors
            nv4 = (m_hi - m_lo + shift + 3) >> 2
            assert 4 * nv4 <= tcap                         # fits the table
            if nv4 not in covered:
                # a lane pair per channel and sector: every (channel,
                # float4) of the cover loaded exactly once
                i = np.arange(2 * c * ((nv4 + 1) >> 1))
                vv, ch = 2 * ((i >> 1) // c) + (i & 1), (i >> 1) % c
                live = vv < nv4
                assert sorted(zip(ch[live], vv[live])) == [
                    (k, u) for k in range(c) for u in range(nv4)]
                covered.add(nv4)
            o0 = (b * hw + q0) * c
            a = o0 & 3                  # the output is 16-byte aligned
            m = m_lo - shift + np.arange(4 * nv4)
            r, col = m // wp, m % wp
            ok = (m >= m_lo) & (m < m_hi) & (col >= pad) & (col < pad + w)
            tbl = np.where(ok, a + ((r - pad) * w + col - pad - q0) * c, -1)
            lo = row0 - shift
            assert lo % 4 == 0 and (first < 8 or lo % 8 == 0)
            idx = lo + chans * mp + np.arange(4 * nv4)      # (c, cover)
            assert idx.min() >= 0 and idx.max() < mem.size  # inside the extent
            dest = (tbl + chans)[:, ok]
            assert dest.max() < tq * c + 4                 # fits the stage
            run = np.full(tq * c + 4, np.nan, np.float32)
            staged = np.zeros(run.size, np.int32)
            np.add.at(staged, dest.ravel(), 1)
            run[dest.ravel()] = mem[idx][:, ok].ravel()
            n = (q1 - q0) * c
            assert np.all(staged[a:a + n] == 1) and staged.sum() == n
            hd = min((4 - a) & 3, n)
            nb4 = (n - hd) >> 2
            tl = n - hd - 4 * nb4
            assert hd <= THREADS and tl <= THREADS
            body = hd + 4 * np.arange(nb4)
            assert np.all((o0 + body) % 4 == 0)            # 16-byte stores
            assert np.all((a + body) % 4 == 0)             # aligned stage
            e = np.arange(n)
            np.add.at(writes, o0 + e, 1)
            out[o0 + e] = run[a + e]
    return out.reshape(nb, h, w, c), writes.reshape(nb, h, w, c)


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


def _cf_with_nan_pads(p, c, nb, seed):
    """A (B, c8, Mp) input whose border ring, channel pad and tail pad are
    NaN: a pad element that reached the output would show."""
    g = np.random.RandomState(seed).randn(nb, tf._r8(c), p.mp).astype(
        np.float32)
    live = tf._mask_np(p.h, p.w, p.pad, p.mp).reshape(-1) > 0
    g[:, :, ~live] = np.nan
    g[:, c:] = np.nan
    return g


@pytest.mark.parametrize("base", [0, 3])
@pytest.mark.parametrize("case", PACK_CASES, ids=case_id)
def test_unpack_cf_block_map(case, base):
    """The Bunny-3M step's two entries at batch 1 and 2, the fixtures'
    plans, the edge plans at c = 1 to 100."""
    name, c, nb = case
    p, _ = plan(name)
    g = _cf_with_nan_pads(p, c, nb, c + nb)
    out, writes = emulate_unpack_cf(g, p, c, base)
    assert np.all(writes == 1)
    np.testing.assert_array_equal(
        out, tf.unpack_cf_ref(torch.from_numpy(g), p, c).numpy())
    assert not np.isnan(out).any()


@pytest.mark.parametrize("base", [1, 2])
@pytest.mark.parametrize("name,c", [("bunny", 53), ("bunny_prefix", 64)])
def test_unpack_cf_block_map_misaligned_input(name, c, base):
    """The input 1 or 2 floats past a 16-byte boundary, at the step's two
    entries."""
    p, _ = plan(name)
    g = _cf_with_nan_pads(p, c, 1, base)
    out, writes = emulate_unpack_cf(g, p, c, base)
    assert np.all(writes == 1)
    np.testing.assert_array_equal(
        out, tf.unpack_cf_ref(torch.from_numpy(g), p, c).numpy())


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


def test_unpack_cf_tiles():
    """128 positions of one image at the Bunny tail entry (400 blocks an
    image); the prefix entry's 3,200 positions in tiles of 32, so that its
    1.6 MB an image spreads over the card; wide channel counts take smaller
    tiles."""
    assert tf.unpack_cf_geometry(160, 320, 2, 53, 2) == (128, 400, 27728)
    assert tf.unpack_cf_geometry(40, 80, 2, 64, 2) == (32, 100, 8400)
    assert tf.unpack_cf_geometry(40, 80, 2, 64, 1).tm == 32
    assert tf.unpack_cf_geometry(160, 320, 2, 100, 1).tm == 64
    assert tf._unpack_cf_table(128, 320, 2) == 144
    assert tf._unpack_cf_table(16, 5, 2) == 44
    for h, w, pad, c, nb in ((16, 24, 2, 5, 2), (5, 13, 2, 100, 2),
                             (160, 320, 2, 1, 1), (40, 80, 2, 700, 1)):
        geo = tf.unpack_cf_geometry(h, w, pad, c, nb)
        assert geo.tm in (8, 16, 32, 64, 128)
        assert geo.smem <= tf.LAYOUT_SMEM
    with pytest.raises(ValueError, match="do not fit"):
        tf.unpack_cf_geometry(40, 80, 2, 2000, 1)


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
    assert list(arr) == [2, 160, 320, 53, 56, 2, p.mp, 128, 0, 0]
    assert tf._pack_cf_launch(2, p.h, p.w, p.pad, p.tm, 53)[2] == addr
    shape, arr, _ = tf._unpack_cf_launch(2, p.h, p.w, 53, 56, p.pad, p.mp)
    assert shape == (2, 160, 320, 53)
    assert list(arr) == [2, 160, 320, 53, 56, 2, p.mp, 128, 0, 0]
    mp, shape, arr, _, offset = tf._unpack_frames_launch(
        1, 48, p.h, p.w, p.pad, p.tm, f, 48, "tanh")
    assert (mp, shape, offset) == (p.mp, (1, 640, 1280, 3), 0.0)
    assert list(arr) == [1, 48, p.mp, 160, 320, 2, 4, 3, 1, 108, 4, 0, 0]
    assert tf._unpack_frames_launch(1, 48, p.h, p.w, p.pad, p.tm, f, 48,
                                    "0.25")[4] == 0.25
    with pytest.raises(ValueError, match="do not unpack"):
        tf._unpack_frames_launch(1, 48, p.h, p.w, p.pad, p.tm, f, 47, "tanh")
