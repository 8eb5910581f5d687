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
The bf16 kernels of pack_cf (to bf16 from fp32 or bf16) and unpack_frames
(from bf16 to fp32 or bf16 frames) stage their input by TMA bulk copies
(``pack_cf_bf16_geometry``, ``unpack_frames_bf16_geometry``); their
emulations also show that every bulk copy starts and ends on 16 bytes
inside the input's aligned extent and fits the staging buffer, and that
every store is a whole 16-byte vector (bf16 frames within one bf16 unit:
tanh's last ulp may move a rounding).
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


def _memory_as(a, base, vec):
    """`a` flattened as the card holds it, `base` elements past a 16-byte
    boundary of `vec` elements, NaN on either side up to the aligned
    extent."""
    n = a.size
    mem = np.full(-(-(base + n) // vec) * vec, np.nan, np.float32)
    mem[base:base + n] = a.ravel()
    return mem


def _as_bf16(a):
    """fp32 values rounded to bf16 (to nearest even), as fp32."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def _interior_vec(m, h, w, pad, wp):
    """_interior_before over an array of flat indices."""
    r, col = np.divmod(m, wp)
    rows = np.clip(r - pad, 0, h)
    part = np.where((r >= pad) & (r < pad + h), np.clip(col - pad, 0, w), 0)
    return rows * w + part


def emulate_pack_cf_bf16(x, p, src, base=0):
    """csrc/pack_cf.cu's bf16 kernel: x (B, h, w, c) fp32 values of the
    input type `src` ("fp32" or "bf16"), `base` elements of it past a
    16-byte boundary. Returns (out (B, c8, mp) fp32 values before the
    rounding to bf16, per element write counts)."""
    nb, h, w, c = x.shape
    isz = 4 if src == "fp32" else 2
    vec = 16 // isz
    geo = tf.pack_cf_bf16_geometry(p.mp, c, nb, isz)
    tm, c8, mp, pad, wp = geo.tm, tf._r8(c), p.mp, p.pad, p.wp
    hpwp = p.hp * wp
    # shared memory: the mbarrier, the table, the staged run
    stage = -(-(tm * c * isz + 32) // 128) * 128
    assert geo.smem == 128 + -(-4 * tm // 128) * 128 + stage
    assert geo.smem <= tf.SMEM_PER_BLOCK and tm in (16, 32, 64, 128, 256)
    assert mp % tm == 0 and geo.blocks == mp // tm
    tiles = nb * geo.blocks                        # one a block
    # one tile's lane map: a lane pair per channel row, 8 positions a lane
    lane = np.arange(32)
    row, half = lane >> 1, lane & 1
    groups = tm // 16
    it = np.arange(-(-c8 // 16) * groups)[:, None]
    ch = (it // groups) * 16 + row
    pos = (it % groups) * 16 + half * 8
    live = ch < c8
    cover = np.zeros((c8, tm), np.int32)
    for i in range(8):
        np.add.at(cover, (ch[live], pos[live] + i), 1)
    assert np.all(cover == 1)                      # each element once
    assert np.all(pos[live] % 8 == 0)              # 16-byte stores
    q = np.arange(tiles)
    b, m0 = q // (mp // tm), (q % (mp // tm)) * tm
    writes = np.zeros((nb, c8, mp), np.int32)
    for bb, mm in zip(b, m0):
        writes[bb, :, mm:mm + tm] += cover
    # every tile's run: one bulk copy of its cover
    mem = _memory_as(x, base, vec)
    q0 = _interior_vec(np.minimum(m0, hpwp), h, w, pad, wp)
    q1 = _interior_vec(np.minimum(m0 + tm, hpwp), h, w, pad, wp)
    start = base + (b * h * w + q0) * c
    shift = start % vec
    nbytes = -(-((q1 - q0) * c + shift) * isz // 16) * 16
    lo = start - shift
    has = q1 > q0
    assert np.all(lo[has] % vec == 0) and np.all(lo[has] >= 0)
    assert np.all(lo[has] + nbytes[has] // isz <= mem.size)
    assert np.all(nbytes[has] <= stage)            # fits the buffer
    # the table and the staged reads, per image, in slabs of channels
    out = np.zeros((nb, c8, mp), np.float32)
    m = np.arange(mp)
    r, col = np.divmod(m, wp)
    inside = ((m < hpwp) & (r >= pad) & (r < pad + h) & (col >= pad)
              & (col < pad + w))
    for bb in range(nb):
        t = bb * (mp // tm) + m // tm
        src_ = np.where(inside, shift[t] + ((r - pad) * w + col - pad
                                            - q0[t]) * c, -1)
        assert np.all(~inside | has[t])
        for c0 in range(0, c, 16):
            chs = np.arange(c0, min(c, c0 + 16))[:, None]
            k = src_[inside] + chs                      # staged index
            assert np.all(k >= 0)
            assert np.all(k < (nbytes // isz)[t[inside]])  # staged data only
            out[bb, c0:c0 + len(chs)][:, inside] = mem[lo[t[inside]] + k]
    return out, writes


def emulate_unpack_frames_bf16(z, p, f, ch, out_bias, base=0):
    """csrc/unpack_frames.cu's bf16 kernel: z (B, cp, Mp) fp32 values of
    bf16, `base` elements past a 16-byte boundary. Returns (out_img of the
    staged values in fp32 (B, h*f, w*f, c), per element write counts) for
    each output type: the vectors of 4 fp32 and of 8 bf16 differ."""
    nb, cp, mp = z.shape
    c = ch // (f * f)
    g = f * c
    h, w, pad, wp = p.h, p.w, p.pad, p.wp
    geo = tf.unpack_frames_bf16_geometry(h, w, f, c, nb)
    tx, fu = geo.tx, geo.fu
    rows, sp = fu * g, -(-geo.tx // 8) * 8 + 8
    nx = -(-w // tx)
    assert tx % 8 == 0 and f % fu == 0 and mp % 8 == 0 and geo.tiles == nx
    assert geo.smem == 128 + -(-rows * sp * 2 // 128) * 128
    assert geo.smem <= tf.SMEM_PER_BLOCK
    mem = _memory_as(z, base, 8)
    size = nb * h * f * w * f * c
    # the aligned path (a compile-time g, output rows on 16 bytes, spans of
    # whole groups of P columns) writes the same whole vectors lane by lane
    aligned = {vo: g in tf.UNPACK_G_TEMPLATES and (w * g) % vo == 0
               for vo in (4, 8)}
    lane_cols = {vo: next(q for q in (1, 2, 4, 8, 16) if q * g % vo == 0)
                 for vo in (4, 8)}
    outs = {vo: (np.full(size, np.nan, np.float32), []) for vo in (4, 8)}
    for q in range(nb * (f // fu) * h * nx):      # the grid (x, y, z)
        xs, rest = q % nx, q // nx
        y, rest = rest % h, rest // h
        u0, b = (rest % (f // fu)) * fu, rest // (f // fu)
        x0 = xs * tx
        n = min(tx, w - x0)
        row0 = base + (b * cp + u0 * g) * mp + (y + pad) * wp + pad + x0
        shift = row0 % 8
        nbytes = -(-(n + shift) * 2 // 16) * 16
        assert nbytes <= sp * 2 and (row0 - shift) % 8 == 0
        idx = row0 - shift + np.arange(rows)[:, None] * mp + np.arange(
            nbytes // 2)
        assert idx.min() >= 0 and idx.max() < mem.size   # aligned extent
        # the staged rows (reads past the copied bytes are ruled out below)
        img = tf.out_img(torch.from_numpy(mem[idx]), out_bias).numpy()
        length = n * g
        for vo, (out, writes) in outs.items():
            for u in range(fu):
                # the output's aligned 16-byte vectors the segment touches;
                # only the first and the last may be cut
                a = ((b * h * f + y * f + u0 + u) * w + x0) * g
                e0 = np.arange(a // vo, (a + length - 1) // vo + 1) * vo - a
                cut = (e0 < 0) | (e0 + vo > length)
                assert not cut[1:-1].any()
                if aligned[vo] and n % lane_cols[vo] == 0:
                    assert not cut.any() and e0[0] == 0
                e = (e0[:, None] + np.arange(vo)).ravel()
                e = e[(e >= 0) & (e < length)]
                xx, j = e // g, e % g
                assert np.all(shift + xx < nbytes // 2)  # staged data only
                writes.append(a + e)
                out[a + e] = img[u * g + j, shift + xx]
    shape = (nb, h * f, w * f, c)
    return {vo: (o.reshape(shape), np.bincount(np.concatenate(wr),
                                               minlength=size).reshape(shape))
            for vo, (o, wr) in outs.items()}


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


def _pack_bf16_case(x, p, src, base):
    """The bf16 kernel's emulation, rounded to bf16, against the plain
    version: bit for bit, every element written once."""
    xs = _as_bf16(x) if src == "bf16" else x
    out, writes = emulate_pack_cf_bf16(xs, p, src, base)
    assert np.all(writes == 1)
    t = torch.from_numpy(xs)
    want = tf.pack_cf_ref(t.to(torch.bfloat16) if src == "bf16" else t, p,
                          torch.bfloat16)
    assert torch.equal(torch.from_numpy(out).to(torch.bfloat16), want)
    return out


@pytest.mark.parametrize("types", ["fp32", "fp32>bf16", "bf16"])
@pytest.mark.parametrize("base", [0, 3])
@pytest.mark.parametrize("case", PACK_CASES, ids=case_id)
def test_pack_cf_block_map(case, base, types):
    """fp32 -> fp32 on the fp32 kernel; fp32 -> bf16 and bf16 -> bf16 on
    the bf16 kernel (base in input elements)."""
    name, c, nb = case
    p, _ = plan(name)
    x = np.random.RandomState(c + nb).randn(nb, p.h, p.w, c).astype(
        np.float32)
    if types != "fp32":
        out = _pack_bf16_case(x, p, types[:4], base)
        live = tf._mask_np(p.h, p.w, p.pad, p.mp).reshape(-1) > 0
        assert np.all(out[:, :, ~live] == 0) and np.all(out[:, c:, :] == 0)
        return
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


@pytest.mark.parametrize("base", range(1, 8))
@pytest.mark.parametrize("name,c,src", [("bunny", 53, "fp32"),
                                        ("bunny", 53, "bf16"),
                                        ("bunny_prefix", 64, "bf16"),
                                        ("f2_w131", 13, "bf16")])
def test_pack_cf_bf16_block_map_misaligned_input(name, c, src, base):
    """The bf16 kernel with its input 1-7 elements past a 16-byte boundary
    (fp32: 1-3 and, past 4, the next 16 bytes' 1-3), at batch 2: the bulk
    copy's cover and offset move, the stores do not."""
    p, _ = plan(name)
    x = np.random.RandomState(base).randn(2, p.h, p.w, c).astype(np.float32)
    _pack_bf16_case(x, p, src, base)


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


def _unpack_bf16_case(z, p, f, ch, out_bias, base):
    """The bf16 kernel's emulation against the plain version, to fp32
    frames (4 a store) and bf16 frames (8 a store): every element written
    once; the offset form exact, tanh and sigmoid within 1e-6 in fp32 and
    one bf16 unit in bf16."""
    zs = _as_bf16(z)
    got = emulate_unpack_frames_bf16(zs, p, f, ch, out_bias, base)
    zt = torch.from_numpy(zs).to(torch.bfloat16)
    for vo, dt in ((4, torch.float32), (8, torch.bfloat16)):
        out, writes = got[vo]
        assert np.all(writes == 1), (out_bias, vo)
        have = torch.from_numpy(out).to(dt).float()
        want = tf.unpack_frames_ref(zt, p, f, ch, out_bias, dt).float()
        if out_bias == "0.0":
            assert torch.equal(have, want)
        elif dt is torch.float32:
            assert float((have - want).abs().max()) <= 1e-6
        else:
            unit = torch.ldexp(torch.ones_like(want),
                               torch.frexp(want)[1] - 8)
            assert bool(((have - want).abs() <= unit).all())


@pytest.mark.parametrize("types", ["fp32", "bf16"])
@pytest.mark.parametrize("case", UNPACK_CASES, ids=case_id)
def test_unpack_frames_block_map(case, types):
    """fp32 z on the fp32 kernel; bf16 z on the bf16 kernel, to fp32 and to
    bf16 frames (base in z's elements)."""
    name, c, nb = case
    p, f = plan(name)
    ch = c * f * f
    cp = max(p.layers[-1].cout, tf._r8(ch))
    z = np.random.RandomState(f + c).randn(nb, cp, p.mp).astype(np.float32)
    if types == "bf16":
        for out_bias, base in (("tanh", 0), ("0.0", 5), ("sigmoid", 7)):
            _unpack_bf16_case(z, p, f, ch, out_bias, base)
        return
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


@pytest.mark.parametrize("base", range(1, 8))
@pytest.mark.parametrize("name", ["bunny", "width_tiled", "f6_w37"])
def test_unpack_frames_bf16_block_map_misaligned_input(name, base):
    """bf16 z 1-7 elements past a 16-byte boundary, at the Bunny-3M decode,
    the width-tiled plan and an f=6 edge plan: the bulk copies' cover and
    offset move, the staged reads and the stores do not."""
    p, f = plan(name)
    z = np.random.RandomState(base).randn(1, p.layers[-1].cout,
                                          p.mp).astype(np.float32)
    _unpack_bf16_case(z, p, f, 3 * f * f, "0.0", base)


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


def test_pack_cf_bf16_tiles():
    """The bf16 kernel's tile, one a block: 64 positions at the Bunny tail
    entry (832 tiles an image), 16 and 32 at the prefix entry, 128 and 256
    at PNeRV's c = 100 entry; every tile leaves room for 4 blocks on an
    SM; a channel count that fits no tile raises."""
    assert tf.pack_cf_bf16_geometry(53248, 53, 1, 4) == (64, 832, 14080)
    assert tf.pack_cf_bf16_geometry(53248, 53, 2, 2).tm == 64
    assert tf.pack_cf_bf16_geometry(4096, 64, 1, 4).tm == 16
    assert tf.pack_cf_bf16_geometry(4096, 64, 2, 2).tm == 32
    assert tf.pack_cf_bf16_geometry(206848, 100, 1, 4).tm == 128
    assert tf.pack_cf_bf16_geometry(206848, 100, 2, 2).tm == 256
    for mp, c, nb, isz in ((640, 5, 2, 4), (256, 100, 2, 2),
                           (53248, 1, 1, 2), (2048, 700, 1, 4)):
        geo = tf.pack_cf_bf16_geometry(mp, c, nb, isz)
        assert geo.tm in (16, 32, 64, 128, 256) and mp % geo.tm == 0
        assert geo.smem == tf._pack_cf_bf16_smem(geo.tm, c, isz)
        assert geo.smem <= tf.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="do not fit"):
        tf.pack_cf_bf16_geometry(2048, 8000, 1, 4)


def test_unpack_frames_bf16_tiles():
    """The bf16 kernel's tile, one a block: one output row and the whole
    width at the Bunny decode (640 blocks) and PNeRV's head (two spans of
    320), three spans of 160 on the width-tiled plan (96 blocks), spans
    narrowed where the launch would be small; the compile-time g for the
    configs' f = 2, 3, 4, 6 at c = 3."""
    assert tf.unpack_frames_bf16_geometry(160, 320, 4, 3, 1) == (
        320, 1, 1, 8064, 12)
    assert tf.unpack_frames_bf16_geometry(320, 640, 2, 3, 1)[:3] == (
        320, 2, 1)
    assert tf.unpack_frames_bf16_geometry(4, 480, 4, 3, 2)[:3] == (160, 3, 1)
    assert tf.unpack_frames_bf16_geometry(5, 13, 4, 3, 2).tx == 16
    assert [tf.unpack_frames_bf16_geometry(160, 320, f, 3, 1).g_template
            for f in (1, 2, 3, 4, 5, 6)] == [0, 6, 9, 12, 0, 18]
    with pytest.raises(ValueError, match="do not fit"):
        tf.unpack_frames_bf16_geometry(16, 16, 6, 2000, 1)


def test_launch_parameter_blocks():
    """The parameter blocks the C launchers read, in their order, made once
    per plan geometry, shape and pair of element types, with the launch
    count's name; a pair with no instantiation raises."""
    f32, bf = torch.float32, torch.bfloat16
    p, f = plan("bunny")
    shape, arr, addr, name = tf._pack_cf_launch(2, p.h, p.w, p.pad, p.tm,
                                                53)
    assert (shape, name) == ((2, 56, p.mp), "pack_cf")
    assert list(arr) == [2, 160, 320, 53, 56, 2, p.mp, 128, 0, 0, 27680]
    assert tf._pack_cf_launch(2, p.h, p.w, p.pad, p.tm, 53)[2] == addr
    _, arr, _, name = tf._pack_cf_launch(1, p.h, p.w, p.pad, p.tm, 53, f32,
                                         bf)
    geo = tf.pack_cf_bf16_geometry(p.mp, 53, 1, 4)
    assert name == "pack_cf_bf16"
    assert list(arr) == [1, 160, 320, 53, 56, 2, p.mp, geo.tm, 0, 1,
                         geo.smem]
    assert list(tf._pack_cf_launch(2, p.h, p.w, p.pad, p.tm, 53, bf,
                                   bf)[1])[8:10] == [1, 1]
    with pytest.raises(TypeError, match="no instantiation"):
        tf._pack_cf_launch(2, p.h, p.w, p.pad, p.tm, 53, bf, f32)
    shape, arr, _, name = tf._unpack_cf_launch(2, p.h, p.w, 53, 56, p.pad,
                                               p.mp)
    assert (shape, name) == ((2, 160, 320, 53), "unpack_cf")
    assert list(arr) == [2, 160, 320, 53, 56, 2, p.mp, 128, 0, 0]
    assert tf._unpack_cf_launch(2, p.h, p.w, 53, 56, p.pad, p.mp, bf,
                                f32)[3] == "unpack_cf_bf16"
    with pytest.raises(TypeError, match="no instantiation"):
        tf._unpack_cf_launch(2, p.h, p.w, 53, 56, p.pad, p.mp, f32, bf)
    mp, shape, arr, _, name = tf._unpack_frames_launch(
        1, 48, p.h, p.w, p.pad, p.tm, f, 48, "tanh")
    assert (mp, shape, name) == (p.mp, (1, 640, 1280, 3), "unpack_frames")
    assert list(arr) == [1, 48, p.mp, 160, 320, 2, 4, 3, 1, 108, 4, 0, 0, 0,
                         4 * 48 * 112]
    # out_img's offset travels as the bits of an fp32 in the block
    arr = tf._unpack_frames_launch(1, 48, p.h, p.w, p.pad, p.tm, f, 48,
                                   "0.25", bf, f32)[2]
    geo = tf.unpack_frames_bf16_geometry(160, 320, 4, 3, 1)
    assert list(arr) == [1, 48, p.mp, 160, 320, 2, 4, 3, 2, geo.tx, geo.fu,
                         1, 0, tf._float_bits(0.25), geo.smem]
    assert np.array(arr[13], np.int32).view(np.float32) == 0.25
    assert tf._unpack_frames_launch(1, 48, p.h, p.w, p.pad, p.tm, f, 48,
                                    "tanh", bf, bf)[4] == "unpack_frames_bf16"
    with pytest.raises(TypeError, match="no instantiation"):
        tf._unpack_frames_launch(1, 48, p.h, p.w, p.pad, p.tm, f, 48, "tanh",
                                 f32, bf)
    with pytest.raises(ValueError, match="do not unpack"):
        tf._unpack_frames_launch(1, 48, p.h, p.w, p.pad, p.tm, f, 47, "tanh")
