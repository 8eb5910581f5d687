"""The bf16 unpack_cf kernel (``csrc/unpack_cf.cu``,
``unpack_cf_bf16_kernel``: a bf16 cotangent back to bf16 or fp32 NHWC), on
the CPU. The kernel runs only on the card; its tile
(``tail_fused.unpack_cf_bf16_geometry``), the byte layout of its staged
channel rows and the index arithmetic of each block are emulated here in
numpy, written from the CUDA source, block by block (vectorised over
blocks), at the Bunny-3M step's two entries at batch 1 and 2, NeRV's and
PNeRV's (c = 100) entries, the fixtures' plans and edge plans (c = 1, 3, 7,
9, ...; image widths below and above the tile), also with the input 1-7
elements past a 16-byte boundary. They show that:
- each block's c bulk copies start and end on 16 bytes, lie inside the
  input's aligned extent, fit their staged row and overlap no other row,
  the table or the mbarrier, and all of them fit the block's shared memory,
  which leaves room for 4 blocks on an SM;
- every staged read lies inside what its row's copy brought, every
  position the table is read at lies inside it;
- every output element is written exactly once, by a whole aligned 16-byte
  vector or, at a run's unaligned ends, a scalar store of one of the first
  threads;
- the result equals ``unpack_cf_ref`` exactly (bf16 to bf16 and to fp32),
  with NaN in every border, channel-pad and tail-pad element of the input.
No JAX here: the plain version is held against the JAX package in
test_torch_tail_fused.py."""

import numpy as np
import pytest
import torch

from _layout_cases import PACK_CASES, case_id, plan
from neuroquant_tpu_torch.ops import tail_fused as tf

THREADS = tf.LAYOUT_THREADS
CHUNK = 128             # blocks emulated at once


def _memory(g, base):
    """`g` flattened as the card holds it, `base` elements past a 16-byte
    boundary, NaN on either side up to the aligned extent (8 bf16)."""
    n = g.size
    mem = np.full(-(-(base + n) // 8) * 8, np.nan, np.float32)
    mem[base:base + n] = g.ravel()
    return mem


def emulate(g, p, c, vo, base=0, tq=None):
    """The bf16 kernel on (B, c8, Mp) `g` (bf16 values held as fp32) to an
    output of `vo` elements a 16-byte vector (8: bf16, 4: fp32). Returns
    (out (B, h, w, c), per element write counts)."""
    nb, c8, mp = g.shape
    h, w, pad, wp = p.h, p.w, p.pad, p.wp
    hw = h * w
    geo = tf.unpack_cf_bf16_geometry(h, w, pad, c, nb)
    tq = tq or geo.tm
    pitch = tf._unpack_cf_bf16_pitch(tq, w, pad)
    rows0 = -(-(16 + 4 * (tq + 1)) // 128) * 128
    smem = tf._unpack_cf_bf16_smem(tq, w, pad, c)
    assert rows0 >= 16 + 4 * (tq + 1) and pitch % 16 == 0
    assert smem == rows0 + tf._unpack_cf_bf16_row(c, pitch)
    assert mp % 8 == 0
    mem = _memory(g, base)
    out = np.full(nb * hw * c, np.nan, np.float32)
    written = []                    # flat output indices of every store
    # the rows' byte ranges: 16-byte starts, disjoint, in the block
    starts = rows0 + np.array([tf._unpack_cf_bf16_row(r, pitch)
                               for r in range(c)])
    assert np.all(starts % 16 == 0)
    assert np.all(np.diff(starts) >= pitch) and starts[-1] + pitch <= smem
    blocks = -(-hw // tq)
    ids = np.arange(nb * blocks)
    for lo in range(0, ids.size, CHUNK):
        blk = ids[lo:lo + CHUNK]
        b, bx = blk // blocks, blk % blocks
        q0 = bx * tq
        q1 = np.minimum(q0 + tq, hw)
        y0, yl = q0 // w, (q1 - 1) // w
        m_lo = (y0 + pad) * wp + pad + q0 - y0 * w
        m_hi = (yl + pad) * wp + pad + (q1 - 1 - yl * w) + 1
        first = base + b * c8 * mp + m_lo          # element address
        shift = first & 7
        nbytes = ((m_hi - m_lo + shift) * 2 + 15) & ~15
        src = first - shift                        # channel 0's copy
        assert np.all(src % 8 == 0) and np.all(nbytes % 16 == 0)
        assert np.all(nbytes <= pitch)             # fits its row
        assert src.min() >= 0                      # inside the extent
        assert np.all(src + (c - 1) * mp + nbytes // 2 <= mem.size)
        # the table: each position's byte offset in a staged row
        t = np.arange(tq)[None, :]
        q = q0[:, None] + t
        live_t = q < q1[:, None]
        y = q // w
        tbl = 2 * ((y + pad) * wp + pad + (q - y * w) - m_lo[:, None]
                   + shift[:, None])
        assert np.all(tbl[live_t] >= 0)
        assert np.all((tbl + 2 <= nbytes[:, None])[live_t])
        tbl = np.concatenate([np.where(live_t, tbl, -1 << 30),
                              np.full((blk.size, 1), -1 << 30)], 1)
        # the output run and its alignment (the output is 16-byte aligned)
        n = (q1 - q0) * c
        o0 = (b * hw + q0) * c
        a = o0 & (vo - 1)
        hd = np.minimum((vo - a) & (vo - 1), n)
        nvec = (n - hd) // vo
        tl = n - hd - vo * nvec
        assert np.all(hd + tl <= THREADS)
        rows = np.arange(blk.size)[:, None]

        def read(e_p, e_ch, live):
            """Staged reads at positions e_p, channels e_ch of each block
            (rows); NaN where not `live`."""
            col = tbl[rows, np.where(live, e_p, 0)]
            ok = (col >= 0) & (col + 2 <= nbytes[:, None]) & (e_ch < c)
            assert np.all(ok | ~live)       # a live position, copied bytes
            idx = src[:, None] + e_ch * mp + col // 2
            return np.where(live, mem[np.where(live, idx, 0)], np.nan)

        # the unaligned ends: threads < hd + tl, one element each
        th = np.arange(THREADS)[None, :]
        e = np.where(th < hd[:, None], th, hd[:, None] + vo * nvec[:, None]
                     + th - hd[:, None])
        live = th < (hd + tl)[:, None]
        pe = e // c
        v = read(pe, e - pe * c, live)
        written.append((o0[:, None] + e)[live])
        out[written[-1]] = v[live]
        # the body: vector i of the run, VO elements walked position by
        # position as the kernel's loop increments them
        vv = np.arange(int(nvec.max(initial=0)))[None, :]
        live = vv < nvec[:, None]
        e = hd[:, None] + vo * vv
        assert np.all(((o0[:, None] + e) % vo == 0)[live])   # aligned store
        pe, ce = e // c, e % c
        for k in range(vo):
            val = read(pe, ce, live)
            written.append((o0[:, None] + e + k)[live])
            out[written[-1]] = val[live]
            ce = ce + 1
            wrap = ce == c
            ce = np.where(wrap, 0, ce)
            pe = pe + wrap
            assert np.all((pe <= tq)[live])          # tbl holds tq + 1
    writes = np.bincount(np.concatenate(written), minlength=out.size)
    return out.reshape(nb, h, w, c), writes.reshape(nb, h, w, c)


def _cf_with_nan_pads(p, c, nb, seed):
    """A (B, c8, Mp) bf16 input (as fp32) whose border ring, channel pad
    and tail pad are NaN: a pad element that reached the output would
    show."""
    g = np.random.RandomState(seed).randn(nb, tf._r8(c), p.mp).astype(
        np.float32)
    g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    live = tf._mask_np(p.h, p.w, p.pad, p.mp).reshape(-1) > 0
    g[:, :, ~live] = np.nan
    g[:, c:] = np.nan
    return g


def _check(p, c, nb, base=0, tq=None, seed=0):
    g = _cf_with_nan_pads(p, c, nb, seed)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    for vo, dt in ((8, torch.bfloat16), (4, torch.float32)):
        out, writes = emulate(g, p, c, vo, base, tq)
        assert np.all(writes == 1), (vo, tq)
        want = tf.unpack_cf_ref(gt, p, c, dt)
        assert want.dtype == dt
        np.testing.assert_array_equal(out, want.float().numpy())


EDGE_CASES = [(name, c, 2) for name in ("f2_w13", "f2_w131")
              for c in (1, 3, 7, 9)]


@pytest.mark.parametrize("case", PACK_CASES + EDGE_CASES, ids=case_id)
def test_block_map(case):
    """The geometry's own tile at every layout case: the Bunny-3M step's
    two entries at batch 1 and 2, NeRV's and PNeRV's entries, the fixtures,
    the edge plans."""
    name, c, nb = case
    p, _ = plan(name)
    _check(p, c, nb, seed=c + nb)


@pytest.mark.parametrize("tq", [8, 32, 56, 200, 256])
@pytest.mark.parametrize("name,c", [("f2_w13", 9), ("small", 7),
                                    ("f2_w131", 3), ("tiny", 17)])
def test_block_map_at_other_tiles(name, c, tq):
    """Tiles wider than the image (w = 13, 24, 40 against up to 256
    positions: a tile crosses many rows and their border columns) and
    narrower (w = 131), powers of two or not."""
    p, _ = plan(name)
    _check(p, c, 2, tq=tq, seed=tq)


@pytest.mark.parametrize("base", range(1, 8))
@pytest.mark.parametrize("name,c", [("bunny_prefix", 64), ("f2_w13", 7)])
def test_block_map_misaligned_input(name, c, base):
    """The input 1-7 elements past a 16-byte boundary: the copies' offset
    moves with it, each copy still starts on 16 bytes inside the input's
    aligned extent."""
    p, _ = plan(name)
    _check(p, c, 2, base=base, seed=base)


def test_tiles():
    """4 equal tiles per SM where they hold 32 to 256 positions: 200 at the
    Bunny tail entry at batch 2 (256 blocks an image), 104 at batch 1; one
    per SM at the prefix entry (56 and 32 positions); 128 at PNeRV's
    c = 100 entry (1600 blocks an image, in waves); every tile a multiple
    of 8 that leaves room for 4 blocks on an SM; a channel count that fits
    no tile raises."""
    assert tf.unpack_cf_bf16_geometry(160, 320, 2, 53, 2) == (200, 256,
                                                              23888)
    assert tf.unpack_cf_bf16_geometry(160, 320, 2, 53, 1).tm == 104
    assert tf.unpack_cf_bf16_geometry(40, 80, 2, 64, 2) == (56, 58, 9600)
    assert tf.unpack_cf_bf16_geometry(40, 80, 2, 64, 1).tm == 32
    assert tf.unpack_cf_bf16_geometry(320, 640, 1, 100, 2) == (128, 1600,
                                                               29632)
    assert tf._unpack_cf_bf16_pitch(200, 320, 2) == 432
    assert tf._unpack_cf_bf16_pitch(256, 13, 2) == 2 * (256 + 80 + 8)
    for args in ((160, 320, 2, 53, 2), (40, 80, 2, 64, 1),
                 (320, 640, 1, 100, 2), (5, 13, 2, 1, 2), (5, 131, 2, 9, 2),
                 (16, 24, 2, 700, 1), (160, 320, 2, 2000, 1)):
        geo = tf.unpack_cf_bf16_geometry(*args)
        assert geo.tm % 8 == 0 and 8 <= geo.tm <= 256
        assert geo.smem == tf._unpack_cf_bf16_smem(geo.tm, args[1], args[2],
                                                   args[3])
        assert geo.smem + 1024 <= tf.SMEM_PER_SM // 4 or geo.tm == 8
        assert geo.smem <= tf.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="do not fit"):
        tf.unpack_cf_bf16_geometry(40, 80, 2, 20000, 1)


def test_launch_records():
    """The bf16 route's parameter block carries the bf16 tile and its
    shared bytes; the fp32 route's is unchanged (10 ints)."""
    p, _ = plan("bunny")
    bf, f32 = torch.bfloat16, torch.float32
    for dst in (bf, f32):
        shape, arr, _, name = tf._unpack_cf_launch(2, p.h, p.w, 53, 56,
                                                   p.pad, p.mp, bf, dst)
        geo = tf.unpack_cf_bf16_geometry(p.h, p.w, p.pad, 53, 2)
        assert name == "unpack_cf_bf16" and shape == (2, p.h, p.w, 53)
        assert list(arr) == [2, p.h, p.w, 53, 56, p.pad, p.mp, geo.tm, 1,
                             int(dst is bf), geo.smem]
    arr = tf._unpack_cf_launch(2, p.h, p.w, 53, 56, p.pad, p.mp)[1]
    assert list(arr) == [2, p.h, p.w, 53, 56, p.pad, p.mp,
                         tf.unpack_cf_geometry(p.h, p.w, p.pad, 53, 2).tm,
                         0, 0]
