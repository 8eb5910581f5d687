"""The K-step list the port's two conv kernels read, the 'zy' pair and the
residuals built on it, and the arithmetic of the 3xTF32 product, all on the
CPU. Inputs come from numpy seeds.

The kernels walk the K axis in steps of 4 rows, each one box of x
(consecutive channels at one flat shift); a run whose length is no multiple
of 4 ends in a step with zero rows. The plain versions multiply over that
very list (``steps=True``), so the list is held here against the dense conv
and the JAX package's ``_conv_cf_jnp`` / ``_conv_cf_dw_jnp``: 1e-5 relative
to the largest value compared (fp32, another summation order)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroquant_tpu.ops import tail_fused as jtf
from neuroquant_tpu_torch.ops import tail_fused as ttf

B = 2
# (k, cin, cout*r*r, r) blocks and the head's (k, cin, cout): packed with
# f = 1, 2, 4; K runs of 8 / 4 / 3 rows, and of 8 / 5 / 3
GEOMS = {
    "runs_8_4_3": dict(h=8, w=12, block_geoms=[(5, 5, 16, 2), (3, 4, 12, 2)],
                       head_geom=(3, 3, 3), tm=128),
    "runs_8_5_3": dict(h=8, w=12, block_geoms=[(3, 6, 20, 2), (3, 5, 12, 2)],
                       head_geom=(3, 3, 3), tm=128),
}
with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")) as _f:
    CONV_TOL = float(re.search(r"^CONV_TOL = ([0-9.e-]+)", _f.read(),
                               re.M)[1])


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module", params=sorted(GEOMS))
def case(request):
    geo = GEOMS[request.param]
    rng = np.random.RandomState(1)
    blocks = [((rng.randn(k, k, cin, crr) * 0.3).astype(np.float32),
               (rng.randn(crr) * 0.1).astype(np.float32), r)
              for k, cin, crr, r in geo["block_geoms"]]
    k, cin, cout = geo["head_geom"]
    head = ((rng.randn(k, k, cin, cout) * 0.3).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32))
    jp = jtf.plan_and_pack(geo["h"], geo["w"],
                           [(jnp.asarray(a), jnp.asarray(b), r)
                            for a, b, r in blocks],
                           (jnp.asarray(head[0]), jnp.asarray(head[1])),
                           tm=geo["tm"])
    tp = ttf.plan_and_pack(geo["h"], geo["w"],
                           [(torch.from_numpy(a), torch.from_numpy(b), r)
                            for a, b, r in blocks],
                           (torch.from_numpy(head[0]),
                            torch.from_numpy(head[1])), tm=geo["tm"])
    plan = tp[0]
    mask = jtf._mask_np(plan.h, plan.w, plan.pad, plan.mp)
    cf = lambda c: (rng.randn(B, c, plan.mp) * mask).astype(np.float32)  # noqa
    return jp, tp, cf


LAYERS = pytest.mark.parametrize("li", [0, 1, 2], ids=["f1", "f2", "head_f4"])


@LAYERS
def test_step_list_covers_the_blocks(case, li):
    """Every step is one box inside one block; the valid rows are the
    blocks' rows in order; the rows past them point at the zero weight row;
    the conv's list pads to whole stages with empty steps."""
    _, (plan, *_), _ = case
    layer = plan.layers[li]
    blocks = ttf._k_blocks(plan, layer)
    steps, wrow = ttf._k_steps(blocks, layer.cin, layer.taps)
    assert steps.shape[1] == 4 and len(wrow) == ttf.K_STEP * len(steps)
    zero = layer.taps * layer.cin
    rows, it = [], iter(steps.tolist())
    for s, t, lo, n in blocks:
        got = 0
        while got < n:
            shift, chan, valid, _ = next(it)
            assert shift == s and chan == lo + got
            assert 1 <= valid <= ttf.K_STEP and got + valid <= n
            rows += [t * layer.cin + chan + r for r in range(valid)]
            rows += [zero] * (ttf.K_STEP - valid)
            got += valid
    assert next(it, None) is None
    np.testing.assert_array_equal(wrow, rows)
    psteps, pwrow = ttf._conv_steps(blocks, layer.cin, layer.taps)
    assert len(psteps) % (ttf.K_STAGE // ttf.K_STEP) == 0
    assert not psteps[len(steps):].any() and (pwrow[len(wrow):] == zero).all()
    runs = ttf._k_runs(blocks, layer.cin, layer.taps)
    assert sum(r + z for _, _, r, z in runs) == len(pwrow)
    assert sum(r for _, _, r, _ in runs) == sum(n for *_, n in blocks)


@LAYERS
@pytest.mark.parametrize("act_in", [False, True])
def test_conv_over_the_step_list_is_the_dense_conv(case, li, act_in):
    (jplan, jkks, jbms, *_), (plan, kks, bms, *_), cf = case
    layer = plan.layers[li]
    x = cf(layer.cin)
    xt = torch.from_numpy(x)
    blocks = ttf._k_blocks(plan, layer)
    dense = ttf.conv_cf_ref(xt, kks[li], bms[li], plan, layer, "z", act_in)
    over_steps = ttf.conv_cf_ref(xt, kks[li], bms[li], plan, layer, "z",
                                 act_in, blocks, steps=True)
    want = jtf._conv_cf_jnp(
        jtf._gelu(jnp.asarray(x)) if act_in else jnp.asarray(x), jkks[li],
        jbms[li], None, jplan, jplan.layers[li], jnp.float32)
    _close(over_steps.numpy(), dense.numpy(), 1e-5)
    _close(over_steps.numpy(), want, 1e-5)
    # the wrapper's CPU route is the plain version over the step list
    assert torch.equal(ttf.conv_cf(xt, kks[li], bms[li], plan, layer, "z",
                                   act_in), over_steps)


@LAYERS
@pytest.mark.parametrize("act_in", [False, True])
def test_dw_over_the_step_list_is_the_dense_dw(case, li, act_in):
    (jplan, *_), (plan, kks, *_), cf = case
    layer = plan.layers[li]
    x, g = cf(layer.cin), cf(layer.cout)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    blocks = ttf._k_blocks(plan, layer)
    dense = ttf.conv_cf_dw_ref(xt, gt, plan, layer, act_in)
    over_blocks = ttf.conv_cf_dw_ref(xt, gt, plan, layer, act_in, blocks)
    over_steps = ttf.conv_cf_dw_ref(xt, gt, plan, layer, act_in, blocks,
                                    steps=True)
    want = jtf._conv_cf_dw_jnp(jnp.asarray(x), jnp.asarray(g), jplan,
                               jplan.layers[li], act_in=act_in)
    # the zero rows of the list add nothing to the blocks' sum
    _close(over_steps[0].numpy(), over_blocks[0].numpy(), 1e-6)
    live = (kks[li] != 0).numpy() if layer.sparse is not None else 1.0
    _close(over_steps[0].numpy() * live, dense[0].numpy() * live, 1e-5)
    _close(over_steps[0].numpy() * live, np.asarray(want[0]) * live, 1e-5)
    _close(over_steps[1].numpy(), want[1], 1e-5)
    got = ttf.conv_cf_dw(xt, gt, plan, layer, act_in)
    assert torch.equal(got[0], over_steps[0])
    assert torch.equal(got[1], over_steps[1])


@LAYERS
def test_emit_zy_is_exactly_z_and_gelu_z(case, li):
    _, (plan, kks, bms, *_), cf = case
    layer = plan.layers[li]
    x = torch.from_numpy(cf(layer.cin))
    z, y = ttf.conv_cf(x, kks[li], bms[li], plan, layer, "zy")
    assert torch.equal(z, ttf.conv_cf(x, kks[li], bms[li], plan, layer, "z"))
    assert torch.equal(y, ttf.conv_cf(x, kks[li], bms[li], plan, layer, "y"))
    assert torch.equal(y, ttf._gelu(z))
    with pytest.raises(ValueError, match="emit"):
        ttf.conv_cf(x, kks[li], bms[li], plan, layer, "yz")


def test_tail_function_keeps_y_residuals(case):
    """Under a gradient each layer followed by a GELU emits (z, y): the
    Function saves every layer's input (x, then the y's), the kernels, and
    the z's for the dx epilogue; no saved input is a pre-activation."""
    _, (plan, kks, bms, *_), cf = case
    n = len(plan.layers)
    x = torch.from_numpy(cf(plan.layers[0].cin)).requires_grad_()
    out = ttf.tail_apply(plan, x, kks, bms)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2 * n + (n - 1)
    inputs, pre = saved[:n], saved[2 * n:]
    assert inputs[0] is x or torch.equal(inputs[0], x)
    for li in range(1, n):
        assert torch.equal(inputs[li], ttf._gelu(pre[li - 1]))
    # the forward's value is the decode path's
    with torch.no_grad():
        assert torch.equal(out, ttf.tail_apply(plan, x.detach(), kks, bms))
    # and its gradients equal autograd's through the plain chain that
    # applies GELU as each layer reads its input, inside the border and
    # where a packed kernel can be nonzero
    wt = torch.from_numpy(cf(plan.layers[-1].cout))

    def grads(run):
        xg = x.detach().clone().requires_grad_()
        ks = [k.clone().requires_grad_() for k in kks]
        (run(xg, ks) * wt).sum().backward()
        return xg.grad, [k.grad for k in ks]

    def plain(h, ks):
        for li, layer in enumerate(plan.layers):
            h = ttf.conv_cf_ref(h, ks[li], bms[li], plan, layer, "z",
                                act_in=layer.gelu_in)
        return h

    dx, dks = grads(lambda xg, ks: ttf.tail_apply(plan, xg, ks, bms))
    want_dx, want_dks = grads(plain)
    mask = ttf.border_mask(plan)
    _close((dx * mask).numpy(), (want_dx * mask).numpy(), 1e-4)
    for li, (a, b) in enumerate(zip(dks, want_dks)):
        live = (kks[li] != 0).float() if plan.layers[li].sparse else 1.0
        _close((a * live).numpy(), (b * live).numpy(), 1e-4)


def _tf32_parts(v, nearest):
    """(big, small as the tensor core reads it) of fp32 `v`: big keeps 10
    mantissa bits (truncated as the kernels do, or rounded to nearest as
    cvt.rna does), small = v - big with its low 13 bits dropped."""
    bits = v.view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    big = (bits & np.uint32(0xFFFFE000)).view(np.float32)
    small = (v - big).astype(np.float32)
    small = (small.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return big.astype(np.float64), small.astype(np.float64)


@pytest.mark.parametrize("k", [1584, 21200], ids=["K_L1", "K_dx_prefix"])
@pytest.mark.parametrize("nearest", [False, True], ids=["truncate", "rna"])
def test_three_tf32_products_keep_fp32_accuracy(k, nearest, record_property):
    """An emulation of the kernels' product at the K of the tail's L1 and of
    the prefix's dx pass: a_small*b_big + a_big*b_small + a_big*b_big with
    TF32 operands, summed exactly, stays within CONV_TOL of the exact
    product (it is ~2^-20 of it); one TF32 product alone does not come
    near, which is why the kernels pay for three."""
    rng = np.random.RandomState(k)
    a = rng.randn(48, k).astype(np.float32)
    b = rng.randn(k, 64).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ab, as_ = _tf32_parts(a, nearest)
    bb, bs = _tf32_parts(b, nearest)
    three = as_ @ bb + ab @ bs + ab @ bb
    one = ab @ bb
    scale = max(1.0, np.abs(exact).max())
    err3 = np.abs(three - exact).max() / scale
    err1 = np.abs(one - exact).max() / scale
    record_property("err_3xtf32", float(err3))
    record_property("err_1xtf32", float(err1))
    print(f"K={k} {'rna' if nearest else 'truncate'}: 3xTF32 {err3:.2e}, "
          f"one TF32 {err1:.2e} of the largest output (CONV_TOL {CONV_TOL})")
    assert err3 <= 0.01 * CONV_TOL
    assert err1 > 100 * err3
    if not nearest:
        assert err1 > CONV_TOL      # the kernels' split, one product: out


def test_tiles_and_splits_fill_the_card():
    """The launch geometry at HNeRV Bunny-3M: the prefix's dx pass (64
    tiles) splits K to fill the card once, the large layers do not split;
    the dW chunks are whole stages that cover every position."""
    assert [ttf._tile_m(c) for c in (48, 56, 64, 176, 592, 848)] == [
        64, 64, 64, 96, 128, 128]
    assert [ttf.conv_f32_tile(c)[0] for c in (48, 56, 64, 96, 176, 592,
                                              848)] == [64, 64, 64, 96, 96,
                                                        128, 96]

    def splits(cout, mp, batch, rows):
        return ttf.conv_f32_geometry(cout, mp, batch,
                                     rows // ttf.K_STEP)["splits"]
    s = splits(64, 4096, 2, 21216)
    assert s > 1 and 64 * s <= ttf.H100_SMS
    assert splits(848, 4096, 1, 1600) == 1
    assert splits(592, 53248, 1, 1600) == 1
    for nk, cout, positions in ((1604, 848, 8192), (1404, 176, 106496),
                                (1588, 592, 106496), (1336, 48, 106496),
                                (40, 16, 512)):
        splits, chunk = ttf._dw_split(nk, cout, positions)
        assert chunk % ttf.DW_STEP == 0 and splits * chunk >= positions
        assert (splits - 1) * chunk < positions
        assert chunk >= min(1024, positions)


def test_executed_macs_count_the_padding():
    plan, _ = ttf.plan_geometry(160, 320, [(5, 53, 176, 2), (5, 44, 148, 2)],
                                (3, 37, 3))
    for layer, k in zip(plan.layers, (1400, 1584, 1440)):
        assert ttf.conv_executed_macs(plan, layer) == plan.mp * k * (
            -(-layer.cout // 16) * 16)
        assert 2 * ttf.conv_executed_macs(plan, layer) >= ttf.conv_cf_flops(
            plan, layer)
