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
            "pack_cf_bf16", "unpack_cf_bf16", "unpack_frames_bf16"}
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
