"""The port's channels-first tail (neuroquant_tpu_torch/ops/tail_fused.py)
against the JAX package's: plans and packed kernels bit for bit, and each
kernel's plain PyTorch version against the JAX kernel (Pallas in interpret
mode on the CPU) and its jnp twin. Inputs come from numpy seeds.

Tolerances: fp32 with a different summation order, 1e-5 absolute at
activations of order 1; layout passes are exact, out_img 1e-6 (the two
frameworks' tanh/sigmoid differ in the last ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroquant_tpu.ops import tail_fused as jtf
from neuroquant_tpu_torch.ops import tail_fused as ttf

B, H, W = 2, 8, 12
BUNNY_BLOCKS = [(5, 53, 176, 2), (5, 44, 148, 2)]
BUNNY_HEAD = (3, 37, 3)


def _plan_key(plan):
    return (plan.h, plan.w, plan.pad, plan.tm, plan.mp,
            tuple((L.cin, L.cout, L.side, L.off, L.gelu_in, L.sparse,
                   L.sparse_t) for L in plan.layers))


def _weights(rng, block_geoms, head_geom):
    blocks = [((rng.randn(k, k, cin, crr) * 0.3).astype(np.float32),
               (rng.randn(crr) * 0.1).astype(np.float32), r)
              for k, cin, crr, r in block_geoms]
    k, cin, cout = head_geom
    head = ((rng.randn(k, k, cin, cout) * 0.3).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32))
    return blocks, head


def _both_plans(h, w, block_geoms, head_geom, tm=0, seed=0):
    blocks, head = _weights(np.random.RandomState(seed), block_geoms,
                            head_geom)
    jp = jtf.plan_and_pack(h, w, [(jnp.asarray(a), jnp.asarray(b), r)
                                  for a, b, r in blocks],
                           (jnp.asarray(head[0]), jnp.asarray(head[1])), tm=tm)
    tp = ttf.plan_and_pack(h, w, [(torch.from_numpy(a), torch.from_numpy(b), r)
                                  for a, b, r in blocks],
                           (torch.from_numpy(head[0]),
                            torch.from_numpy(head[1])), tm=tm)
    return jp, tp


SMALL = dict(h=H, w=W, block_geoms=[(5, 5, 16, 2), (3, 4, 12, 2)],
             head_geom=(3, 3, 3), tm=128)
TINY_HNERV = dict(h=20, w=40, block_geoms=[(3, 17, 224, 4)],
                  head_geom=(3, 14, 3), tm=0)
BUNNY = dict(h=160, w=320, block_geoms=BUNNY_BLOCKS, head_geom=BUNNY_HEAD,
             tm=0)


class TestPlanEquality:
    @pytest.mark.parametrize("case", [SMALL, TINY_HNERV, BUNNY],
                             ids=["small", "tiny_hnerv", "bunny"])
    def test_plan_and_pack_bit_exact(self, case):
        (jplan, jkks, jbms, jf, jch), (tplan, tkks, tbms, tf_, tch) = \
            _both_plans(**case)
        assert _plan_key(tplan) == _plan_key(jplan)
        assert (tf_, tch) == (jf, jch)
        for a, b in zip(jkks, tkks):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(jbms, tbms):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    @pytest.mark.parametrize("case", [SMALL, TINY_HNERV, BUNNY],
                             ids=["small", "tiny_hnerv", "bunny"])
    def test_plan_geometry(self, case):
        args = (case["h"], case["w"], case["block_geoms"], case["head_geom"],
                case["tm"])
        jplan, jf = jtf.plan_geometry(*args)
        tplan, tf_ = ttf.plan_geometry(*args)
        assert _plan_key(tplan) == _plan_key(jplan) and tf_ == jf
        # and equal to plan_and_pack's plan
        tplan2 = _both_plans(**case)[1][0]
        assert _plan_key(tplan2) == _plan_key(tplan)

    def test_bunny_union_cut(self):
        """The head's union K is 36 blocks of 37 channels: 4x below the
        9 taps x 592 channels of the dense packed kernel; at L1 the union
        equals the dense set."""
        plan, _ = ttf.plan_geometry(160, 320, BUNNY_BLOCKS, BUNNY_HEAD)
        l1, head = plan.layers[1], plan.layers[2]
        hb = ttf._k_blocks(plan, head)
        assert len(hb) == 36 and sum(n for *_, n in hb) == 36 * 37
        assert head.taps * head.cin == 4 * 36 * 37
        assert sum(n for *_, n in ttf._k_blocks(plan, l1)) == l1.taps * l1.cin


class TestPackedGeometry:
    @pytest.mark.parametrize("k,r", [(1, 2), (3, 2), (3, 4), (5, 2), (5, 4)])
    def test_axis_maps(self, k, r):
        from neuroquant_tpu.ops import packed_decode as jpd
        from neuroquant_tpu_torch.ops import packed_decode as tpd

        np.testing.assert_array_equal(tpd._axis_map(k, r),
                                      np.asarray(jpd._axis_map(k, r)))
        np.testing.assert_array_equal(tpd._inv_axis_map(k, r),
                                      np.asarray(jpd._inv_axis_map(k, r)))

    @pytest.mark.parametrize("r", [2, 4])
    def test_space_to_depth_round_trip(self, r):
        from neuroquant_tpu.ops import packed_decode as jpd
        from neuroquant_tpu_torch.ops import packed_decode as tpd

        x = np.random.RandomState(r).randn(2, 8, 12, 3).astype(np.float32)
        perm = tpd.compose_shuffle_perm(tpd.identity_perm(2), 2, r // 2)
        for p in (None, perm):
            want = np.asarray(jpd.space_to_depth(jnp.asarray(x), r, p))
            got = tpd.space_to_depth(torch.from_numpy(x), r, p)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                tpd.depth_to_space(got, r, p).numpy(), x)


@pytest.fixture(scope="module")
def small_case():
    (jplan, jkks, jbms, f, ch), (tplan, tkks, tbms, _, _) = _both_plans(**SMALL)
    rng = np.random.RandomState(1)
    mask = jtf._mask_np(tplan.h, tplan.w, tplan.pad, tplan.mp)
    xs = [(rng.randn(B, L.cin, tplan.mp) * mask).astype(np.float32)
          for L in tplan.layers]
    return jplan, jkks, jbms, tplan, tkks, tbms, xs


EMITS = [("z", False), ("y", False), ("z", True), ("y", True)]


class TestConvCF:
    @pytest.mark.parametrize("li", [0, 1, 2], ids=["f1", "f2", "head_f4"])
    @pytest.mark.parametrize("emit,act_in", EMITS)
    def test_matches_jax_kernel_and_twin(self, small_case, li, emit, act_in):
        jplan, jkks, jbms, tplan, tkks, tbms, xs = small_case
        x = xs[li]
        jl = jplan.layers[li]
        want_k = np.asarray(jtf._conv_cf(
            jnp.asarray(x), jkks[li], jbms[li], None, jplan, jl, jnp.float32,
            emit=emit, act_in=act_in))
        want_t = np.asarray(jtf._conv_cf_jnp(
            jnp.asarray(x), jkks[li], jbms[li], None, jplan, jl, jnp.float32,
            emit=emit, act_in=act_in))
        xt = torch.from_numpy(x)
        got_ref = ttf.conv_cf_ref(xt, tkks[li], tbms[li], tplan,
                                  tplan.layers[li], emit, act_in).numpy()
        got = ttf.conv_cf(xt, tkks[li], tbms[li], tplan, tplan.layers[li],
                          emit, act_in).numpy()
        for g in (got_ref, got):
            np.testing.assert_allclose(g, want_k, atol=1e-5, rtol=0)
            np.testing.assert_allclose(g, want_t, atol=1e-5, rtol=0)

    @pytest.mark.parametrize("li", [1, 2], ids=["f2", "head_f4"])
    def test_union_k_equals_dense(self, small_case, li):
        _, _, _, tplan, tkks, tbms, xs = small_case
        layer = tplan.layers[li]
        assert layer.sparse is not None
        x = torch.from_numpy(xs[li])
        dense = ttf.conv_cf_ref(x, tkks[li], tbms[li], tplan, layer, "y", True)
        union = ttf.conv_cf_ref(x, tkks[li], tbms[li], tplan, layer, "y", True,
                                blocks=ttf._k_blocks(tplan, layer))
        np.testing.assert_allclose(union.numpy(), dense.numpy(), atol=1e-5,
                                   rtol=0)

    def test_tail_apply_matches_jax(self, small_case):
        jplan, jkks, jbms, tplan, tkks, tbms, xs = small_case
        want = np.asarray(jtf.tail_apply(jplan, jnp.asarray(xs[0]), jkks,
                                         jbms))
        got = ttf.tail_apply(tplan, torch.from_numpy(xs[0]), tkks, tbms)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _bf16_units(got, want):
    """|got - want| over the bf16 spacing at `want` (2^-7 of the power of
    two at or below it)."""
    _, e = np.frexp(want)
    return np.abs(got - want) / np.ldexp(1.0, e - 8)


class TestLayoutKernels:
    @pytest.mark.parametrize("c", [5, 8, 13])
    def test_pack_cf_exact(self, c):
        plan = _both_plans(**SMALL)[1][0]
        x = np.random.RandomState(c).randn(B, H, W, c).astype(np.float32)
        want = np.asarray(jtf.pack_cf(jnp.asarray(x), plan, jnp.float32))
        got_ref = ttf.pack_cf_ref(torch.from_numpy(x), plan).numpy()
        got = ttf.pack_cf(torch.from_numpy(x), plan).numpy()
        np.testing.assert_array_equal(got_ref, want)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("out_bias", ["sigmoid", "tanh", "0.5"])
    def test_unpack_frames(self, out_bias):
        # the JAX kernel needs a grid width >= 32: the tiny HNeRV tail's plan
        (jplan, _, _, f, ch), (tplan, *_) = _both_plans(**TINY_HNERV)
        cp, h, w = 48, tplan.h, tplan.w
        z = np.random.RandomState(2).randn(B, cp, tplan.mp).astype(np.float32)
        want = np.asarray(jtf.unpack_frames(jnp.asarray(z), jplan, f, ch,
                                            out_bias, jnp.float32))
        np.testing.assert_allclose(want, np.asarray(jtf._unpack_jnp(
            jnp.asarray(z), jplan, f, ch, out_bias, jnp.float32)), atol=1e-6)
        got_ref = ttf.unpack_frames_ref(torch.from_numpy(z), tplan, f, ch,
                                        out_bias).numpy()
        got = ttf.unpack_frames(torch.from_numpy(z), tplan, f, ch,
                                out_bias).numpy()
        assert got.shape == want.shape == (B, h * f, w * f, 3)
        np.testing.assert_allclose(got_ref, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


    def test_unpack_frames_width_tiled(self):
        """At f=4 and w=480 the JAX unpack takes its width-tiled kernel
        (``_unpack_kernel5``, 240-wide tiles, interpret mode here); the
        port's one kernel and plain version compute the same function."""
        geoms = ([(3, 17, 224, 4)], (3, 14, 3))
        jplan, f = jtf.plan_geometry(4, 480, *geoms)
        tplan, _ = ttf.plan_geometry(4, 480, *geoms)
        assert jtf._unpack_wt(jplan, f) == 240 < jplan.w
        z = np.random.RandomState(7).randn(B, 48, tplan.mp).astype(np.float32)
        want = np.asarray(jtf.unpack_frames(jnp.asarray(z), jplan, f, 48,
                                            "tanh", jnp.float32))
        got = ttf.unpack_frames(torch.from_numpy(z), tplan, f, 48,
                                "tanh").numpy()
        assert got.shape == want.shape == (B, 16, 1920, 3)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


    # The bf16 forms of the plain versions against the JAX kernels with a
    # bf16 dtype (Pallas in interpret mode): pack_cf from fp32 and from
    # bf16 bit for bit (one rounding to nearest even, or none);
    # unpack_frames from bf16 z to fp32 frames at 1e-6 and to bf16 frames
    # within one bf16 unit (out_img in fp32, then one rounding; the two
    # frameworks' tanh/sigmoid differ in the last ulp), at the plan of the
    # JAX full-width kernel and at the width-tiled one.
    @pytest.mark.parametrize("src", ["fp32", "bf16"])
    @pytest.mark.parametrize("c", [5, 13])
    def test_pack_cf_bf16_exact(self, c, src):
        plan = _both_plans(**SMALL)[1][0]
        x = np.random.RandomState(c).randn(B, H, W, c).astype(np.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        if src == "bf16":
            jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
        want = jtf.pack_cf(jx, plan, jnp.bfloat16)
        assert want.dtype == jnp.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        for got in (ttf.pack_cf_ref(tx, plan, torch.bfloat16),
                    ttf.pack_cf(tx, plan, torch.bfloat16)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), want)

    @staticmethod
    def _unpack(jplan, tplan, f, ch, out_bias, out, seed):
        z = np.random.RandomState(seed).randn(B, 48, tplan.mp).astype(
            np.float32)
        jz = jnp.asarray(z).astype(jnp.bfloat16)
        tz = torch.from_numpy(z).to(torch.bfloat16)
        jdt, tdt = ((jnp.float32, torch.float32) if out == "fp32"
                    else (jnp.bfloat16, torch.bfloat16))
        want = jtf.unpack_frames(jz, jplan, f, ch, out_bias, jdt)
        assert want.dtype == jdt
        want = np.asarray(want.astype(jnp.float32))
        for got in (ttf.unpack_frames_ref(tz, tplan, f, ch, out_bias, tdt),
                    ttf.unpack_frames(tz, tplan, f, ch, out_bias, tdt)):
            assert got.dtype == tdt and got.shape == want.shape
            got = got.float().numpy()
            if out == "fp32":
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
            else:
                assert _bf16_units(got, want).max() <= 1.0

    @pytest.mark.parametrize("out", ["fp32", "bf16"])
    @pytest.mark.parametrize("out_bias", ["sigmoid", "tanh", "0.5"])
    def test_unpack_frames_bf16(self, out_bias, out):
        (jplan, _, _, f, ch), (tplan, *_) = _both_plans(**TINY_HNERV)
        self._unpack(jplan, tplan, f, ch, out_bias, out, 3)

    @pytest.mark.parametrize("out", ["fp32", "bf16"])
    def test_unpack_frames_bf16_width_tiled(self, out):
        geoms = ([(3, 17, 224, 4)], (3, 14, 3))
        jplan, f = jtf.plan_geometry(4, 480, *geoms)
        tplan, _ = ttf.plan_geometry(4, 480, *geoms)
        assert jtf._unpack_wt(jplan, f) == 240 < jplan.w
        self._unpack(jplan, tplan, f, 48, "tanh", out, 8)


class TestWrappers:
    def test_cpu_uses_plain_version_and_counts_nothing(self, small_case):
        _, _, _, tplan, tkks, tbms, xs = small_case
        ttf.reset_launch_counts()
        x = torch.from_numpy(xs[0])
        out = ttf.conv_cf(x, tkks[0], tbms[0], tplan, tplan.layers[0], "y")
        ref = ttf.conv_cf_ref(x, tkks[0], tbms[0], tplan, tplan.layers[0],
                              "y")
        assert torch.equal(out, ref)
        assert set(ttf.KERNEL_LAUNCHES) == {
            "tail_conv_cf", "tail_conv_dw_cf", "pack_cf", "unpack_cf",
            "unpack_frames", "fq_uaq", "fq_ada", "fq_uaq_bwd",
            "fq_ada_bwd", "tail_conv_cf_bf16", "tail_conv_dw_cf_bf16",
            "pack_cf_bf16", "unpack_cf_bf16", "unpack_frames_bf16",
            "tail_conv_cf_wgmma"}
        assert not any(ttf.KERNEL_LAUNCHES.values())

    def test_other_devices_raise(self, small_case):
        _, _, _, tplan, tkks, tbms, xs = small_case
        x = torch.empty((B, tplan.layers[0].cin, tplan.mp), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            ttf.conv_cf(x, tkks[0], tbms[0], tplan, tplan.layers[0])
        with pytest.raises(ValueError, match="unsupported device"):
            ttf.pack_cf(torch.empty((B, H, W, 5), device="meta"), tplan)

    def test_gelu_is_the_as_formula(self):
        x = np.linspace(-6, 6, 4001).astype(np.float32)
        got = ttf._gelu(torch.from_numpy(x)).numpy()
        # same formula; the frameworks' exp may differ in the last ulp
        np.testing.assert_allclose(got, np.asarray(jtf._gelu(jnp.asarray(x))),
                                   atol=2e-7, rtol=0)
        exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, exact, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# The fp32 conv kernel's launch geometry and index maps (csrc/
# tail_conv_cf.cu, its TMA ring and 3xTF32 wgmma), emulated in numpy: the
# kernel runs only on the card, the maps that decide what it copies and
# multiplies are held here. No JAX in these.
# --------------------------------------------------------------------------
def _f32_layers():
    """(id, plan, layer) of HNeRV and NeRV Bunny-3M's kernel-path convs:
    the fused prefix blocks (HNeRV 64 -> 848, k5, 40x80; NeRV 36 -> 384,
    k3), then each tail's layers."""
    import os

    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.models import tail_plan_for

    out = []
    for arch, sub, prefix in (("hnerv", "HNeRV", (5, 64, 848)),
                              ("nerv", "NeRV", (3, 36, 384)),
                              ("pnerv", "PNeRV", None)):
        cfg = get_config(os.path.join(os.path.dirname(__file__), "..",
                                      "configs", sub,
                                      "Bunny_1280x640_3M.yaml"))
        if prefix is not None:
            pp = ttf._prefix_plan(40, 80, *prefix)
            out.append((f"{arch}-prefix", pp, pp.layers[0]))
        plan = tail_plan_for(arch, cfg)[0]
        out += [(f"{arch}-L{i}", plan, layer)
                for i, layer in enumerate(plan.layers)]
    return out


F32_LAYERS = _f32_layers()


def _f32_pass(plan, layer, which):
    lay = layer if which == "forward" else layer.transposed()
    steps = ttf._box_plan(ttf._conv_steps(ttf._k_blocks(plan, lay), lay.cin,
                                          lay.taps)[0])
    return lay, steps


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("which", ["forward", "dx"])
@pytest.mark.parametrize("name,plan,layer", F32_LAYERS,
                         ids=[n for n, _, _ in F32_LAYERS])
def test_f32_conv_tiles_cover_and_fit(name, plan, layer, which, batch):
    """The tile covers cout and Mp once (64 channels for cout <= 64, else
    96 or 128, whichever pads cout less), the splits cover K in whole
    stages of at least 8 a split, and the ring and its barriers fit one
    block on each SM."""
    lay, steps = _f32_pass(plan, layer, which)
    geo = ttf.conv_f32_geometry(lay.cout, plan.mp, batch, len(steps))
    bm, bn = geo["bm"], geo["bn"]
    gx, gy, gz = geo["grid"]
    assert bn == 128 and bm in (64, 96, 128)
    pads = {t: -(-lay.cout // t) * t for t in (96, 128)}
    assert bm == 64 if lay.cout <= 64 else (
        gy * bm == min(pads.values()) and (bm == 128 or pads[96] < pads[128]))
    assert (gy - 1) * bm < lay.cout <= gy * bm
    assert gx * bn == plan.mp and gz == batch * geo["splits"]
    kt = geo["ktiles"]
    assert kt * ttf.K_STAGE == len(steps) * ttf.K_STEP
    assert geo["splits"] == 1 or (gx * gy * batch < ttf.H100_SMS
                                  and kt // geo["splits"] >= 8)
    assert geo["blocks_per_sm"] == 1
    assert geo["smem"] <= ttf.SMEM_PER_BLOCK
    assert geo["stage_bytes"] % 1024 == 0
    assert geo["stage_bytes"] == (ttf.K_STAGE * ttf.F32_SEG * 4
                                  + 2 * bm * ttf.K_STAGE * 4)
    assert geo["stages"] >= 4
    # TMA: a staged row of 16-byte multiples, each box of 4 rows lands on
    # 128 bytes, the realigned reads stay inside the staged row
    assert ttf.F32_SEG * 4 % 16 == 0 and 4 * ttf.F32_SEG * 4 % 128 == 0
    assert 3 + ttf.CONV_TILE_N <= ttf.F32_SEG
    # every stage of 8 steps is covered by its boxes once, 32 rows
    for k0 in range(0, len(steps), 8):
        rows = steps[k0:k0 + 8, 3]
        assert rows.sum() == ttf.K_STAGE
        cover = np.zeros(8, int)
        for j in np.nonzero(rows)[0]:
            cover[j:j + rows[j] // ttf.K_STEP] += 1
        assert (cover == 1).all()


def test_f32_conv_splits_at_bunny():
    """Only the prefix's dx pass splits K: 4 ways at batch 1, 2 at batch 2
    (32 and 64 tiles of 128 positions x 64 channels, K = 21,216 rows); the
    other main-path passes have a tile per SM or more."""
    plan, layer = F32_LAYERS[0][1:]
    lt = layer.transposed()
    _, steps = _f32_pass(plan, layer, "dx")
    assert len(steps) * ttf.K_STEP == 21216 and lt.cout == 64
    assert [ttf.conv_f32_geometry(64, plan.mp, b, len(steps))["splits"]
            for b in (1, 2)] == [4, 2]
    for name, plan, layer in F32_LAYERS[1:4]:
        for which in ("forward", "dx"):
            lay, steps = _f32_pass(plan, layer, which)
            assert ttf.conv_f32_geometry(lay.cout, plan.mp, 1,
                                         len(steps))["splits"] == 1, name


@pytest.mark.parametrize("r", range(4))
def test_f32_conv_fragment_loads_hit_32_banks(r):
    """Each warp's load of one A fragment element (x^T, read straight from
    the staged x rows at row k, position + (shift & 3)) touches 32 distinct
    banks for every shift residue r: the staged row of F32_SEG = 136 floats
    is 8 mod 32, so the 8 positions g and the 4 rows t4 of a warp's lanes
    fall on 32 banks."""
    seg = ttf.F32_SEG
    assert seg % 32 == 8
    for wg in range(2):
        for wl in range(4):
            apos = 64 * wg + 16 * wl
            for q in range(4):
                for e in range(4):
                    banks = {((8 * q + t4 + 4 * (e >> 1)) * seg + apos + g
                              + 8 * (e & 1) + r) % 32
                             for g in range(8) for t4 in range(4)}
                    assert len(banks) == 32, (wg, wl, q, e)


def test_f32_conv_takes_every_bunny_pass():
    """Every fp32 conv pass of HNeRV, NeRV and PNeRV Bunny-3M, at batch 1
    and 2, is one the TMA launcher takes (whole stages of 8 steps, Mp a
    multiple of the 128-position tile, cout a multiple of 4, at most 65535
    blocks along z), and its weight operand is the (K rows, cout) rows of
    the kernel, K-major."""
    for name, plan, layer in F32_LAYERS:
        for which in ("forward", "dx"):
            lay, steps = _f32_pass(plan, layer, which)
            assert len(steps) % 8 == 0 and plan.mp % ttf.CONV_TILE_N == 0
            assert lay.cout % 4 == 0, (name, which, lay.cout)
            for batch in (1, 2):
                geo = ttf.conv_f32_geometry(lay.cout, plan.mp, batch,
                                            len(steps))
                assert geo["grid"][2] <= 65535
    plan, _ = ttf.plan_geometry(6, 10, [(3, 8, 16, 2), (3, 4, 44, 2)],
                                (3, 11, 3), tm=128)
    layer = plan.layers[2]
    kk = torch.randn(layer.side, layer.side, layer.cin, layer.cout)
    _, wrow = ttf._conv_steps(ttf._k_blocks(plan, layer), layer.cin,
                              layer.taps)
    want = ttf._w_operand(kk, torch.as_tensor(wrow))
    got = ttf.conv_w_operand(kk, plan, layer)
    assert got.shape == (layer.cout, len(wrow))
    assert torch.equal(got, want.t())
    assert torch.equal(ttf.conv_w_operand(kk.bfloat16(), plan, layer),
                       want.bfloat16())
