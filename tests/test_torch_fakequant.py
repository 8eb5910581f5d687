"""The port's fused fake-quant module (ops/fused_fakequant.py) and
``fq_impl='pallas'`` against the JAX package's ``ops/pallas_fakequant.py``,
on numpy-seeded weights. On the CPU the port runs its plain version (the
CUDA kernel is held against it on the card, tests/test_torch_kernels_cuda.py)
and the JAX package its Pallas kernels in interpret mode.

Tolerances: forward 1e-6 absolute on weights of |w| < 1 (the JAX kernel
multiplies by a Hadamard matrix where the plain chain adds and subtracts),
integer codes equal; the Functions' gradients 1e-5 of each one's largest
value; through a decode 1e-4 of the largest (fp32 sums over every position
in another order), the loss 1e-5 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.ops import pallas_fakequant as jpf
from neuroquant_tpu.ops import quant as JQ
from neuroquant_tpu.ops.hadamard import fwht as jax_fwht
from neuroquant_tpu.ops.hadamard import pad_cin_to_pow2 as jax_pad
from neuroquant_tpu.quantization import qmodel as jqm
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.ops import fused_fakequant as tff
from neuroquant_tpu_torch.ops import quant as TQ
from neuroquant_tpu_torch.ops import tail_fused as ttf
from neuroquant_tpu_torch.ops.hadamard import fwht, pad_cin_to_pow2
from neuroquant_tpu_torch.quantization import calibrate as tcal
from neuroquant_tpu_torch.quantization import qmodel as tqm
from neuroquant_tpu_torch.quantization.spec import make_spec
from neuroquant_tpu_torch.utils.convert import (
    quant_state_from_numpy, state_dict_from_jax)

BITS = 4
MODES = {"uaq": (False, True), "soft": (True, True), "hard": (True, False)}


def _case(cin, hadamard, channel_wise, seed=0, khw=(3, 3), cout=5):
    """Weight (R = 45 rows: not a multiple of 8), scales from the max init
    in the quantization domain, alphas off their init by noise so that
    both clip bounds of h(alpha) occur."""
    rng = np.random.RandomState(seed + cin)
    w = (rng.randn(*khw, cin, cout) * 0.2).astype(np.float32)
    wt = torch.from_numpy(w)
    dom = fwht(pad_cin_to_pow2(wt), axis=2) if hadamard else wt
    d, z = TQ.init_weight_scale(dom, BITS, channel_wise, "max")
    a = TQ.adaround_init_alpha(dom, d) + 3 * torch.from_numpy(
        rng.randn(*dom.shape).astype(np.float32))
    return w, d.numpy(), z.numpy(), a.numpy()


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


class TestForward:
    @pytest.mark.parametrize("mode", list(MODES))
    @pytest.mark.parametrize("cin,hadamard,channel_wise", [
        (5, True, True), (37, True, True), (53, True, True),
        (64, True, True), (37, True, False), (5, False, True),
        (53, False, False)])
    def test_plain_version_matches_jax(self, mode, cin, hadamard,
                                       channel_wise):
        ada, soft = MODES[mode]
        w, d, z, a = _case(cin, hadamard, channel_wise)
        ja = jnp.asarray(a) if ada else None
        kern = np.asarray(jpf.fused_fake_quant_hwio(
            jnp.asarray(w), jnp.asarray(d), jnp.asarray(z), BITS,
            hadamard=hadamard, alpha=ja, soft=soft))
        ref = np.asarray(jpf._jnp_reference(
            jnp.asarray(w), jnp.asarray(d), jnp.asarray(z), ja, BITS,
            hadamard, soft))
        wt, dt, zt, at = _t(w, d, z, a)
        got = tff.fake_quant_ref(wt, dt, zt, at if ada else None, BITS,
                                 hadamard, soft)
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.numpy(), kern, atol=1e-6, rtol=0)
        # the wrapper takes the plain version for a CPU tensor
        ttf.reset_launch_counts()
        out = tff.fused_fake_quant_hwio(wt, dt, zt, BITS, hadamard,
                                        at if ada else None, soft)
        assert torch.equal(out, got)
        assert not any(ttf.KERNEL_LAUNCHES.values())
        if mode == "soft":
            return
        # the integer codes behind the values
        jdom = (jax_fwht(jax_pad(jnp.asarray(w)), axis=2) if hadamard
                else jnp.asarray(w))
        tdom = fwht(pad_cin_to_pow2(wt), axis=2) if hadamard else wt
        if ada:
            want = JQ.adaround_int_codes(jdom, d, z, ja, BITS)
            codes = TQ.adaround_int_codes(tdom, dt, zt, at, BITS)
        else:
            want = JQ.uaq_int_codes(jdom, d, z, BITS)
            codes = TQ.uaq_int_codes(tdom, dt, zt, BITS)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want))

    def test_other_devices_raise(self):
        w = torch.empty((3, 3, 8, 4), device="meta")
        s = torch.empty((1, 1, 1, 4), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tff.fused_fake_quant_hwio(w, s, s, BITS)

    def test_row_strides(self):
        """The kernel's addressing of an HWIO view of an OIHW parameter, of
        a contiguous HWIO tensor, and of a view it must copy."""
        oihw = torch.arange(6 * 5 * 3 * 3, dtype=torch.float32).reshape(
            6, 5, 3, 3)
        view = oihw.permute(2, 3, 1, 0)
        assert tff._row_strides(view) == (45, 1, 9)
        hwio = view.contiguous()
        assert tff._row_strides(hwio) == (1, 30, 6)
        for t in (view, hwio):
            so, sk, sc = tff._row_strides(t)
            vals = t.as_strided((t.numel(),), (1,))       # the storage
            for o, k, c in ((0, 0, 0), (5, 8, 4), (2, 4, 3)):
                assert vals[o * so + k * sk + c * sc] == t[k // 3, k % 3, c,
                                                           o]
        odd = torch.zeros((4, 3, 5, 6))[::2]     # kernel rows strided apart
        assert tff._row_strides(odd) is None
        copy, strides = tff._strided(odd)
        assert copy.is_contiguous() and strides == (1, 30, 6)
        assert tff._row_strides(torch.zeros((1, 1, 16, 92))) == (1, 1472, 92)


def _rel_close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


class TestFunctionGradients:
    """Kernel-forward Functions: their backward is the VJP of the plain
    version, so the gradients are the plain chain's, and the JAX
    wrappers'."""

    @pytest.mark.parametrize("hadamard", [True, False])
    @pytest.mark.parametrize("channel_wise", [True, False])
    def test_uaq_grads_match_jax(self, hadamard, channel_wise):
        w, d, z, _ = _case(5, hadamard, channel_wise, seed=10, cout=6)
        wt = np.random.RandomState(3).randn(*w.shape).astype(np.float32)

        def jf(w_, d_, z_):
            return (jpf.pallas_uaq_fake_quant(w_, d_, z_, BITS, hadamard)
                    * wt).sum()

        want = jax.grad(jf, argnums=(0, 1, 2))(
            jnp.asarray(w), jnp.asarray(d), jnp.asarray(z))
        leaves = [t.requires_grad_() for t in _t(w, d, z)]
        out = tff.uaq_fake_quant(*leaves, BITS, hadamard)
        (out * torch.from_numpy(wt)).sum().backward()
        plain = [t.detach().clone().requires_grad_() for t in leaves]
        ref = tff.fake_quant_ref(*plain, None, BITS, hadamard)
        (ref * torch.from_numpy(wt)).sum().backward()
        assert torch.equal(out.detach(), ref.detach())
        for t, p, wg in zip(leaves, plain, want):
            assert t.grad.shape == t.shape
            assert torch.equal(t.grad, p.grad)
            _rel_close(t.grad.numpy(), wg, 1e-5)

    @pytest.mark.parametrize("soft", [True, False])
    @pytest.mark.parametrize("hadamard", [True, False])
    def test_adaround_grads_match_jax(self, soft, hadamard):
        w, d, z, a = _case(8, hadamard, True, seed=11, cout=4)
        wt = np.random.RandomState(4).randn(*w.shape).astype(np.float32)

        def jf(w_, d_, z_, a_):
            return (jpf.pallas_ada_fake_quant(w_, d_, z_, a_, 6, hadamard,
                                              soft) * wt).sum()

        want = jax.grad(jf, argnums=(0, 1, 2, 3))(
            jnp.asarray(w), jnp.asarray(d), jnp.asarray(z), jnp.asarray(a))
        leaves = [t.requires_grad_() for t in _t(w, d, z, a)]
        out = tff.ada_fake_quant(*leaves, 6, hadamard, soft)
        (out * torch.from_numpy(wt)).sum().backward()
        if soft:
            assert float(np.abs(np.asarray(want[3])).max()) > 0
        for t, wg in zip(leaves, want):
            got = (t.grad if t.grad is not None
                   else torch.zeros_like(t)).numpy()
            _rel_close(got, wg, 1e-5)
        # the floor passes nothing to the weight
        assert leaves[0].grad is None or not bool(leaves[0].grad.any())

    def test_only_needed_gradients_are_computed(self):
        w, d, z, a = _case(8, True, True, seed=12, cout=4)
        wt, dt, zt, at = _t(w, d, z, a)
        at.requires_grad_()
        tff.ada_fake_quant(wt, dt, zt, at, BITS, True, True).sum().backward()
        assert at.grad is not None and wt.grad is None and dt.grad is None
        out = tff.uaq_fake_quant(wt, dt, zt, BITS, True)
        assert not out.requires_grad


@pytest.fixture(scope="module")
def tiny(tiny_hnerv_cfg):
    cfg = dict(tiny_hnerv_cfg)
    jm = jax_build_model("hnerv", cfg)
    x = np.random.RandomState(0).rand(2, 80, 160, 3).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    emb = np.asarray(jm.apply(params, jnp.asarray(x), method="encode"))
    tm = build_model("hnerv", cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(
        "hnerv", jax.tree_util.tree_map(np.asarray, params)), strict=True)
    tm.eval()
    sd = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    return cfg, jm, params, emb, tm, sd


class TestQuantizeParams:
    def test_spec_accepts_both_impls(self, tiny_hnerv_cfg):
        assert make_spec("hnerv", tiny_hnerv_cfg).fq_impl == "jnp"
        spec = make_spec("hnerv", tiny_hnerv_cfg, fq_impl="pallas")
        assert spec.with_bits([4] * spec.num_layers).fq_impl == "pallas"
        with pytest.raises(ValueError, match="fq_impl"):
            make_spec("hnerv", tiny_hnerv_cfg, fq_impl="triton")

    @pytest.mark.parametrize("mode,soft", [("uaq", True), ("adaround", True),
                                           ("adaround", False)])
    def test_pallas_impl_matches_jnp_impl_and_jax(self, tiny, mode, soft):
        """quantize_params(fq_impl='pallas'): the same weights as 'jnp' in
        the port and as the JAX package's; value and state gradients
        through a decode (UAQ and soft AdaRound)."""
        cfg, jm, params, emb, tm, sd = tiny
        jspec = dataclasses.replace(
            jax_make_spec("hnerv", cfg, hadamard=True), fq_impl="pallas")
        tspec_p = make_spec("hnerv", cfg, hadamard=True, fq_impl="pallas")
        tspec_j = make_spec("hnerv", cfg, hadamard=True)
        jstate = jqm.init_quant_state(params, jspec)
        if mode == "adaround":
            # alphas moved off their init, where a weight with an integer
            # x/delta has h(alpha) exactly on its clip bound and the
            # frameworks' sigmoids decide whether it gets a gradient
            rng = np.random.RandomState(5)
            jstate = {
                ln: {k: (v + 0.3 * rng.randn(*v.shape).astype(np.float32)
                         if k.endswith("alpha") else v)
                     for k, v in s.items()}
                for ln, s in jqm.adaround_upgrade(params, jspec,
                                                  jstate).items()}
        np_state = jax.tree_util.tree_map(np.asarray, jstate)
        keys = ("w_delta", "b_delta") if mode == "uaq" else ("w_alpha",
                                                             "b_alpha")

        def jf(st):
            qp = jqm.quantize_params(params, jspec, st, mode=mode, soft=soft)
            return (jm.apply(qp, jnp.asarray(emb), method="decode")
                    ** 2).mean(), qp

        # jitted, as the JAX calibration runs it: the eager FWHT divides by
        # sqrt(n) where the jitted one multiplies by its reciprocal, and a
        # last-bit difference at an integer x/delta moves a floor by one
        (jv, _), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jstate)

        def run(spec):
            st = quant_state_from_numpy(np_state)
            if soft:
                for s in st.values():
                    for k in keys:
                        s[k].requires_grad_()
            qp = tqm.quantize_params(sd, spec, st, mode=mode, soft=soft)
            if not soft:
                return qp, None, st
            val = (functional_call(
                tcal._Decoder(tm, "decode"),
                {f"model.{k}": v for k, v in qp.items()},
                (torch.from_numpy(emb),)) ** 2).mean()
            val.backward()
            return qp, float(val.detach()), st

        qp_p, v_p, st_p = run(tspec_p)
        qp_j, v_j, st_j = run(tspec_j)
        # the weights against the jitted JAX plain chain: the JAX kernel's
        # Hadamard matrix products (here in interpret mode) flip a few
        # rounding decisions on these weights (17 of one layer's 34272
        # elements), which the value's and the gradients' tolerances absorb
        jspec_j = dataclasses.replace(jspec, fq_impl="jnp")
        want_sd = state_dict_from_jax("hnerv", jax.tree_util.tree_map(
            np.asarray, jax.jit(lambda st: jqm.quantize_params(
                params, jspec_j, st, mode=mode, soft=soft))(jstate)))
        for k in qp_p:
            assert torch.equal(qp_p[k].detach(), qp_j[k].detach()), k
            np.testing.assert_allclose(qp_p[k].detach().numpy(),
                                       want_sd[k].numpy(), atol=1e-6, rtol=0)
        if not soft:
            return
        assert v_p == v_j
        assert v_p == pytest.approx(float(jv), rel=1e-5)
        for ln in tspec_p.layer_names:
            for k in keys:
                assert torch.equal(st_p[ln][k].grad, st_j[ln][k].grad)
                _rel_close(st_p[ln][k].grad.numpy(), jg[ln][k], 1e-4)
