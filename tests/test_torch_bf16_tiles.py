"""The launch geometry of the bf16 conv kernels (``csrc/tail_conv_cf.cu``
and ``csrc/tail_conv_dw_cf.cu``, their TMA and wgmma instantiations), on
the CPU. The kernels run only on the card; what decides which rows they
copy and multiply is computed in ``ops/tail_fused.py`` and mirrored by the
launchers: the tiles (``conv_bf16_geometry``, ``dw_bf16_geometry``), the
K splits and position chunks, and the box plan in column 3 of the step
lists (``_box_plan``). At every main-path shape of HNeRV, NeRV, PNeRV1 and
PNeRV2 Bunny-3M (PNeRV2's tail is PNeRV1's), forward, dx and dW, batch 1
and 2, this shows that:
- the tiles cover cout and Mp, the K tiles and the splits cover K, the
  position chunks cover every position in whole stages;
- shared memory stays within a block's 227 KB, and the blocks an SM is
  to hold fit it;
- every box starts at a step, covers a run of steps at one shift over
  consecutive channels inside one stage window, and the boxes of a window
  cover each of its steps once; the db step has none;
- row strides, box widths and shared destinations meet TMA's 16- and
  128-byte rules, and the realigned reads stay inside the staged rows;
- the realignment's word arithmetic (``nq_realign16``) picks the 8 values
  at any residue.
No JAX here."""

import os

import numpy as np
import pytest

from neuroquant_tpu_torch.ops import tail_fused as tf

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _layers():
    """(id, plan, layer) of the four models' kernel-path convs at Bunny-3M:
    the fused prefix blocks of HNeRV (64 -> 848, k5, 40x80) and NeRV
    (36 -> 384, k3), then each tail's layers from its config."""
    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.models import tail_plan_for

    out = []
    for arch, prefix in (("hnerv", (5, 64, 848)), ("nerv", (3, 36, 384)),
                         ("pnerv", None)):
        sub = {"hnerv": "HNeRV", "nerv": "NeRV", "pnerv": "PNeRV"}[arch]
        cfg = get_config(os.path.join(CONFIGS, sub,
                                      "Bunny_1280x640_3M.yaml"))
        if prefix is not None:
            pp = tf._prefix_plan(40, 80, *prefix)
            out.append((f"{arch}-prefix", pp, pp.layers[0]))
        plan = tail_plan_for(arch, cfg)[0]
        out += [(f"{arch}-L{i}", plan, layer)
                for i, layer in enumerate(plan.layers)]
    return out


LAYERS = _layers()
IDS = [name for name, _, _ in LAYERS]
PASSES = ("forward", "dx")


def _pass(plan, layer, which):
    lay = layer if which == "forward" else layer.transposed()
    blocks = tf._k_blocks(plan, lay)
    return lay, tf._box_plan(tf._conv_steps(blocks, lay.cin, lay.taps)[0])


def _dw_steps(plan, layer):
    blocks = tf._k_blocks(plan, layer)
    return tf._box_plan(tf._dw_steps(blocks, layer.cin, layer.taps)[0])


def test_pnerv2_tail_is_pnerv1s():
    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.models import tail_plan_for

    cfg = get_config(os.path.join(CONFIGS, "PNeRV", "Bunny_1280x640_3M.yaml"))
    assert tail_plan_for("pnerv2", cfg)[0] == tail_plan_for("pnerv", cfg)[0]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("which", PASSES)
@pytest.mark.parametrize("name,plan,layer", LAYERS, ids=IDS)
def test_conv_tiles_cover_and_fit(name, plan, layer, which, batch):
    lay, steps = _pass(plan, layer, which)
    geo = tf.conv_bf16_geometry(lay.cout, plan.mp, batch, len(steps))
    bm, bn = geo["bm"], geo["bn"]
    gx, gy, gz = geo["grid"]
    assert (bm, bn) in ((128, 256), (64, 256))
    assert (gy - 1) * bm < lay.cout <= gy * bm        # channels covered once
    assert (gx - 1) * bn < plan.mp <= gx * bn         # positions covered once
    assert gz == batch * geo["splits"]
    # the tile pads cout least, 128 channels on a tie
    pads = {t: -(-lay.cout // t) * t for t in (64, 128)}
    assert gy * bm == min(pads.values())
    # every split's K tiles: the K list whole, in stages
    kt = geo["ktiles"]
    assert kt * tf.K_STAGE == len(steps) * tf.K_STEP
    per = -(-kt // geo["splits"])
    assert per * geo["splits"] >= kt and geo["splits"] <= max(1, kt // 8)
    # shared memory: within a block's, the blocks an SM holds
    assert geo["smem"] <= tf.SMEM_PER_BLOCK
    assert geo["blocks_per_sm"] * (geo["smem"] + 1024) <= tf.SMEM_PER_SM
    # the ring: 1024-byte stages (the swizzled weight slabs), the staged
    # rows of 128 positions and the slabs of 64 channels
    assert geo["stage_bytes"] % 1024 == 0
    assert geo["stage_bytes"] == ((bn // 128) * tf.K_STAGE * tf.BF16_SEG * 2
                                  + (bm // 64) * tf.K_STAGE * 128)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("name,plan,layer", LAYERS, ids=IDS)
def test_dw_tiles_cover_and_fit(name, plan, layer, batch):
    steps = _dw_steps(plan, layer)
    geo = tf.dw_bf16_geometry(len(steps), layer.cout, batch, plan.mp)
    bn = geo["bn"]
    gx, gy, gz = geo["grid"]
    assert bn in (64, 96, 128)
    assert (gy - 1) * bn < layer.cout <= gy * bn
    rows = len(steps) * tf.K_STEP
    assert (gx - 1) * tf.BF16_DW_TILE_K < rows <= gx * tf.BF16_DW_TILE_K
    # position chunks: whole stages that never cross a frame (Mp a multiple
    # of the stage), covering every position once
    positions = batch * plan.mp
    assert plan.mp % tf.BF16_DW_STEP == 0
    assert geo["chunk"] % tf.BF16_DW_STEP == 0
    assert (gz - 1) * geo["chunk"] < positions <= gz * geo["chunk"]
    assert geo["smem"] + 16 * 32 <= tf.SMEM_PER_BLOCK   # + the static steps
    assert geo["stage_bytes"] % 1024 == 0
    assert geo["stages"] >= 4


def _windows(steps):
    for w0 in range(0, len(steps), tf.BOX_STEPS):
        yield w0, steps[w0:w0 + tf.BOX_STEPS]


def _check_boxes(steps):
    """Every box starts at a step and covers a run inside its window; the
    boxes cover each copied step once; the rows a box brings are those the
    steps name."""
    covered = np.zeros(len(steps), np.int32)
    for w0, win in _windows(steps):
        for j, (shift, chan, valid, rows) in enumerate(win.tolist()):
            if rows == 0:
                continue
            assert chan >= 0 and rows in tf.BOX_ROWS
            n = rows // tf.K_STEP
            assert j + n <= len(win)                 # inside the window
            run = win[j:j + n]
            assert (run[:, 0] == shift).all()        # one shift
            assert (run[:, 1] == chan + tf.K_STEP * np.arange(n)).all()
            assert (run[:-1, 2] == tf.K_STEP).all()  # full but the last
            assert (run[1:, 3] == 0).all()           # covered, no box
            covered[w0 + j:w0 + j + n] += 1
    copied = steps[:, 1] >= 0
    assert (covered[copied] == 1).all() and (covered[~copied] == 0).all()


@pytest.mark.parametrize("which", PASSES)
@pytest.mark.parametrize("name,plan,layer", LAYERS, ids=IDS)
def test_forward_box_plan(name, plan, layer, which):
    lay, steps = _pass(plan, layer, which)
    assert len(steps) % tf.BOX_STEPS == 0            # whole stages
    assert (steps[:, :3] == tf._conv_steps(
        tf._k_blocks(plan, lay), lay.cin, lay.taps)[0][:, :3]).all()
    _check_boxes(steps)
    # every step is copied (the padding's empty steps too: no operand row
    # holds stale shared memory)
    assert (steps[:, 1] >= 0).all()


@pytest.mark.parametrize("name,plan,layer", LAYERS, ids=IDS)
def test_dw_box_plan(name, plan, layer):
    steps = _dw_steps(plan, layer)
    _check_boxes(steps)
    assert steps[-1].tolist() == [0, -2, 1, 0]       # db: ones, no box
    assert (steps[:-1, 1] >= 0).all()
    # a dW block's 32 steps are four whole windows
    assert tf.BF16_DW_TILE_K // tf.K_STEP % tf.BOX_STEPS == 0
    # the rows past a step's valid ones land on the dropped weight row
    _, wrow = tf._dw_steps(tf._k_blocks(plan, layer), layer.cin, layer.taps)
    pad = np.repeat(steps[:-1, 2], tf.K_STEP) <= np.tile(
        np.arange(tf.K_STEP), len(steps) - 1)
    assert (wrow[pad] == layer.taps * layer.cin).all()


@pytest.mark.parametrize("name,plan,layer", LAYERS, ids=IDS)
def test_tma_rules(name, plan, layer):
    """16-byte global strides and bases, box widths that are whole 16-byte
    chunks, 128-byte shared destinations, box starts on 16 bytes, staged
    reads inside the staged rows."""
    for lay in (layer, layer.transposed()):
        assert (plan.mp * 2) % 16 == 0                   # x, g row strides
        assert (lay.cin * plan.mp * 2) % 16 == 0         # frame strides
        assert (lay.cout * 2) % 16 == 0                  # w_op rows
    for width, srow_rows in ((tf.BF16_SEG, tf.K_STAGE),
                             (tf.BF16_DW_SEG, tf.BF16_DW_TILE_K)):
        srow = width * 2
        assert srow % 16 == 0
        # a box of a step at row 4j lands at 4j rows: 128-byte aligned
        assert (tf.K_STEP * srow) % 128 == 0
        assert srow_rows * srow % 1024 == 0
    # the box start: the shifted position rounded down to 8 values; the
    # realigned chunks read the staged chunk and the next
    for which in PASSES:
        lay, steps = _pass(plan, layer, which)
        shifts = steps[:, 0].astype(np.int64)
        for m0 in (0, 128, plan.mp - 128):
            a = (m0 + shifts) & ~7
            assert (a % 8 == 0).all() and ((m0 + shifts - a) < 8).all()
        # forward: a warpgroup's 128 positions of its staged segment
        last = (128 - 8) // 8 + 1                        # the next chunk
        assert (last + 1) * 8 <= tf.BF16_SEG
    assert (64 - 8) // 8 + 2 <= tf.BF16_DW_SEG // 8      # dW rows


def _realign16(words, r):
    """nq_realign16 of csrc/nq_tma.cuh on uint32 words: the 5 words from
    word r // 2, funnel-shifted right by 16 bits when r is odd."""
    h, sh = r >> 1, (r & 1) * 16
    v = [int(words[i + h]) for i in range(5)]
    return [((v[i + 1] << 32 | v[i]) >> sh) & 0xFFFFFFFF for i in range(4)]


@pytest.mark.parametrize("r", range(8))
def test_realign_word_arithmetic(r):
    rng = np.random.RandomState(r)
    vals = rng.randint(0, 1 << 16, size=16).astype(np.uint32)   # bf16 bits
    words = vals[0::2] | (vals[1::2] << 16)     # little-endian pairs
    got = _realign16(words, r)
    want = vals[r:r + 8]
    assert got == [int(want[2 * i]) | int(want[2 * i + 1]) << 16
                   for i in range(4)]


def test_box_plan_runs():
    """A hand-made list: a run of 11 full steps and a ragged one (a box of
    8 steps, then one of 4 in the next window), a step at another shift,
    the padding's empty steps (a box each), and the db step (none)."""
    steps = [[5, 4 * i, 4, 0] for i in range(11)]
    steps += [[5, 44, 3, 0], [7, 0, 4, 0], [0, 0, 0, 0], [0, 0, 0, 0],
              [0, -2, 1, 0]]
    got = tf._box_plan(np.asarray(steps, np.int32))
    assert got[:, 3].tolist() == [32, 0, 0, 0, 0, 0, 0, 0,
                                  16, 0, 0, 0, 4, 4, 4, 0]
    _check_boxes(got)
