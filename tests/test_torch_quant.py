"""The port's quantization (neuroquant_tpu_torch/quantization, ops/quant.py,
ops/hadamard.py) against the JAX package's on the same weights: scale init
for every method, fake-quantized weights for UAQ, hard AdaRound and mixed
rounding, and the integer codes.

Deltas to 1e-6 relative (fp32 reductions in another order); zero points and
integer codes exactly; fake-quantized weights to 1e-6 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.ops import hadamard as jhad
from neuroquant_tpu.ops import quant as JQ
from neuroquant_tpu.quantization import qmodel as jqm
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu_torch.ops import hadamard as thad
from neuroquant_tpu_torch.ops import quant as TQ
from neuroquant_tpu_torch.quantization import qmodel as tqm
from neuroquant_tpu_torch.quantization.spec import make_spec
from neuroquant_tpu_torch.utils.convert import (
    quant_state_from_numpy, state_dict_from_jax)

PRECISION = (6, 5, 4, 5, 5, 6, 6)


@pytest.fixture(scope="module")
def params(tiny_hnerv_cfg):
    model = jax_build_model("hnerv", dict(tiny_hnerv_cfg, fused_tail="off"))
    p = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 80, 160, 3)))
    sd = state_dict_from_jax("hnerv", jax.tree_util.tree_map(np.asarray, p))
    return p, sd


def _specs(cfg, **kw):
    n = len(cfg["dec_strides"]) + 2
    bits = PRECISION[:n]
    return (jax_make_spec("hnerv", cfg, **kw).with_bits(bits),
            make_spec("hnerv", cfg, **kw).with_bits(bits))


def _np_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


def _assert_state(got, want):
    assert set(got) == set(want)
    for name in want:
        for leaf in want[name]:
            g = got[name][leaf].numpy()
            w = np.asarray(want[name][leaf])
            assert g.shape == w.shape, (name, leaf, g.shape, w.shape)
            if leaf.endswith("zp"):
                np.testing.assert_array_equal(g, w, err_msg=f"{name}/{leaf}")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                           err_msg=f"{name}/{leaf}")


class TestScaleInit:
    @pytest.mark.parametrize("method", ["max", "gaussian", "mse", "l1", "l2"])
    @pytest.mark.parametrize("hadamard", [True, False])
    def test_init_quant_state(self, params, tiny_hnerv_cfg, method, hadamard):
        p, sd = params
        jspec, tspec = _specs(tiny_hnerv_cfg, scale_method=method,
                              hadamard=hadamard)
        _assert_state(tqm.init_quant_state(sd, tspec),
                      jqm.init_quant_state(p, jspec))

    @pytest.mark.parametrize("channel_wise,sym", [(False, False),
                                                  (True, True)])
    def test_layer_wise_and_symmetric(self, params, tiny_hnerv_cfg,
                                      channel_wise, sym):
        p, sd = params
        jspec, tspec = _specs(tiny_hnerv_cfg, channel_wise=channel_wise,
                              sym=sym, hadamard=True)
        _assert_state(tqm.init_quant_state(sd, tspec),
                      jqm.init_quant_state(p, jspec))

    def test_gaussian_variance_quirk(self):
        x = np.random.RandomState(0).randn(4096).astype(np.float32) * 2
        d, _ = TQ._init_scale_flat(torch.from_numpy(x), 8, "gaussian", False)
        jd, _ = JQ._init_scale_flat(jnp.asarray(x), 8, "gaussian", False)
        mu, var = float(x.mean()), float(x.var())
        lo, hi = min(mu - 6 * var, 0), max(mu + 6 * var, 0)
        assert float(d) == pytest.approx(max((hi - lo) / 255, 1e-8), rel=1e-5)
        assert float(d) == pytest.approx(float(jd), rel=1e-6)

    @pytest.mark.parametrize("n", [32, 64])
    def test_fwht_matches_bit_for_bit(self, n):
        # against the jitted transform, as quantize_params runs it
        x = np.random.RandomState(1).randn(3, 3, n, 5).astype(np.float32)
        np.testing.assert_array_equal(
            thad.fwht(torch.from_numpy(x), axis=2).numpy(),
            np.asarray(jax.jit(lambda v: jhad.fwht(v, axis=2))(x)))


def _states(p, sd, jspec, tspec, mode):
    """(jax state, port state): uaq scale init, or AdaRound upgraded
    ('adaround' every layer, 'mixed' only the first and last layers)."""
    js = jqm.init_quant_state(p, jspec)
    if mode != "uaq":
        only = (None if mode == "adaround"
                else (jspec.layer_names[0], jspec.layer_names[-1]))
        js = jqm.adaround_upgrade(p, jspec, js, only=only)
    return js, quant_state_from_numpy(_np_state(js))


class TestQuantizeParams:
    @pytest.mark.parametrize("mode", ["uaq", "adaround", "mixed"])
    def test_fake_quant_weights_and_codes(self, params, tiny_hnerv_cfg, mode):
        p, sd = params
        jspec, tspec = _specs(tiny_hnerv_cfg, hadamard=True)
        js, ts = _states(p, sd, jspec, tspec, mode)
        qmode = "uaq" if mode == "uaq" else "adaround"
        want = jqm.quantize_params(p, jspec, js, mode=qmode, soft=False)
        got = tqm.quantize_params(sd, tspec, ts, mode=qmode, soft=False)
        codes = jqm.collect_int_codes(p, jspec, js, mode=qmode)
        for name, path, pre, bits in zip(jspec.layer_names,
                                         jspec.layer_paths,
                                         tspec.layer_keys, jspec.n_bits):
            jl = jqm._get(want, path)
            np.testing.assert_allclose(
                got[f"{pre}.weight"].permute(2, 3, 1, 0).numpy(),
                np.asarray(jl["kernel"]), atol=1e-6, rtol=0)
            np.testing.assert_allclose(got[f"{pre}.bias"].numpy(),
                                       np.asarray(jl["bias"]), atol=1e-6,
                                       rtol=0)
            w, b = tqm._get(sd, pre)
            s = ts[name]
            wd = tqm._hadamard_weight(w)
            if "w_alpha" in s:
                wc = TQ.adaround_int_codes(wd, s["w_delta"], s["w_zp"],
                                           s["w_alpha"], bits)
                bc = TQ.adaround_int_codes(b, s["b_delta"], s["b_zp"],
                                           s["b_alpha"], bits)
            else:
                wc = TQ.uaq_int_codes(wd, s["w_delta"], s["w_zp"], bits)
                bc = TQ.uaq_int_codes(b, s["b_delta"], s["b_zp"], bits)
            np.testing.assert_array_equal(wc.numpy(),
                                          np.asarray(codes[name]["w"]))
            np.testing.assert_array_equal(bc.numpy(),
                                          np.asarray(codes[name]["b"]))

    def test_f16_round(self):
        x = np.random.RandomState(2).rand(257).astype(np.float32) * 1e-2
        np.testing.assert_array_equal(
            TQ.f16_round(torch.from_numpy(x)).numpy(),
            np.asarray(JQ.f16_round(jnp.asarray(x))))


class TestGradients:
    """The calibration's gradients: STE rounding, the clip's half gradient
    on a bound, AdaRound's soft targets and regularizer, against
    ``jax.grad`` of the JAX functions. 1e-4 relative to the largest
    gradient: a per-layer delta's gradient is a sum over every weight with
    cancellations, taken in another order."""

    @staticmethod
    def _close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))

    @pytest.mark.parametrize("channel_wise", [True, False])
    def test_uaq_ste(self, channel_wise):
        rng = np.random.RandomState(4)
        x = rng.randn(3, 3, 8, 6).astype(np.float32)
        shape = (1, 1, 1, 6) if channel_wise else ()
        d, zp = TQ.init_weight_scale(torch.from_numpy(x), 4, channel_wise,
                                     "max")
        d, zp = d.numpy(), zp.numpy()
        wt = rng.randn(*x.shape).astype(np.float32)
        jf = lambda x_, d_: (JQ.uaq_fake_quant(x_, d_, zp, 4) * wt).sum()  # noqa
        jgx, jgd = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(d))
        xt = torch.from_numpy(x).requires_grad_()
        dt = torch.from_numpy(d.reshape(shape)).requires_grad_()
        out = TQ.uaq_fake_quant(xt, dt, torch.from_numpy(zp), 4)
        (out * torch.from_numpy(wt)).sum().backward()
        # forward values are those of the plain round
        np.testing.assert_array_equal(
            out.detach().numpy(),
            np.asarray(JQ.uaq_fake_quant(jnp.asarray(x), jnp.asarray(d),
                                         jnp.asarray(zp), 4)))
        self._close(xt.grad, jgx)
        self._close(dt.grad, jgd)

    def test_clip_passes_half_on_a_bound(self):
        x = torch.tensor([-1.0, 0.0, 1.0, 3.0, 4.0], requires_grad=True)
        TQ._clip(x, 0.0, 3.0).sum().backward()
        jg = jax.grad(lambda v: jnp.clip(v, 0.0, 3.0).sum())(
            jnp.asarray(x.detach().numpy()))
        np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))

    def test_adaround_soft_and_reg(self):
        rng = np.random.RandomState(5)
        x = rng.randn(3, 3, 8, 6).astype(np.float32)
        d = np.full((1, 1, 1, 6), 0.2, np.float32)
        zp = np.full((1, 1, 1, 6), 8.0, np.float32)
        a = rng.randn(*x.shape).astype(np.float32) * 2
        wt = rng.randn(*x.shape).astype(np.float32)

        def jf(a_, d_):
            q = JQ.adaround_fake_quant(jnp.asarray(x), d_, zp, a_, 4)
            return (q * wt).sum() + 0.01 * JQ.adaround_reg(a_, 6.5)

        jga, jgd = jax.grad(jf, argnums=(0, 1))(jnp.asarray(a),
                                                 jnp.asarray(d))
        at = torch.from_numpy(a).requires_grad_()
        dt = torch.from_numpy(d).requires_grad_()
        q = TQ.adaround_fake_quant(torch.from_numpy(x), dt,
                                   torch.from_numpy(zp), at, 4)
        ((q * torch.from_numpy(wt)).sum()
         + 0.01 * TQ.adaround_reg(at, 6.5)).backward()
        self._close(at.grad, jga)
        self._close(dt.grad, jgd)
        np.testing.assert_allclose(
            TQ.adaround_init_alpha(torch.from_numpy(x),
                                   torch.from_numpy(d)).numpy(),
            np.asarray(JQ.adaround_init_alpha(jnp.asarray(x),
                                              jnp.asarray(d))),
            rtol=1e-5, atol=1e-5)


class TestCalibrationState:
    @pytest.mark.parametrize("only", [None, "mixed"])
    def test_adaround_upgrade(self, params, tiny_hnerv_cfg, only):
        p, sd = params
        jspec, tspec = _specs(tiny_hnerv_cfg, hadamard=True)
        names = (None if only is None
                 else (jspec.layer_names[1], jspec.layer_names[3]))
        js = jqm.init_quant_state(p, jspec)
        want = jqm.adaround_upgrade(p, jspec, js, only=names)
        got = tqm.adaround_upgrade(
            sd, tspec, quant_state_from_numpy(_np_state(js)), only=names)
        assert set(got) == set(want)
        for name in want:
            assert set(got[name]) == set(want[name]), name
            for leaf, w in want[name].items():
                w = np.asarray(w)
                g = got[name][leaf].numpy()
                if leaf.endswith("alpha"):
                    # -log of a ratio: 1e-5 of the residue's resolution
                    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                               err_msg=f"{name}/{leaf}")
                else:
                    np.testing.assert_array_equal(g, w,
                                                  err_msg=f"{name}/{leaf}")

    def test_adaround_upgrade_keeps_a_delta_that_f16_rounds_to_zero(
            self, params, tiny_hnerv_cfg):
        """Phase 1's Adam can walk a channel's delta across zero; where
        float16 rounds it to 0 (|delta| < 2^-25) the hand-off keeps its sign
        at the smallest float16, so every alpha stays finite (the JAX
        package divides by the zero); other deltas round as the JAX
        package's do, and their alphas match."""
        p, sd = params
        jspec, tspec = _specs(tiny_hnerv_cfg, hadamard=True)
        js = _np_state(jqm.init_quant_state(p, jspec))
        name = jspec.layer_names[2]
        d = js[name]["w_delta"].copy()
        d.reshape(-1)[:3] = [1e-9, -2e-8, 0.0]
        js[name]["w_delta"] = d
        js[name]["b_delta"] = np.float32(-1e-10)
        got = tqm.adaround_upgrade(sd, tspec, quant_state_from_numpy(js))
        want = jqm.adaround_upgrade(p, jspec, js)
        tiny = 2.0 ** -24
        wd = got[name]["w_delta"].reshape(-1).numpy()
        np.testing.assert_array_equal(wd[:3], [tiny, -tiny, tiny])
        np.testing.assert_array_equal(
            wd[3:], np.asarray(want[name]["w_delta"]).reshape(-1)[3:])
        assert float(got[name]["b_delta"]) == -tiny
        for ln, s in got.items():
            for leaf, v in s.items():
                assert bool(torch.isfinite(v).all()), (ln, leaf)
        # the JAX hand-off divides by the zero
        assert not np.isfinite(np.asarray(want[name]["w_alpha"])).all()
        np.testing.assert_allclose(
            got[name]["w_alpha"].numpy()[..., 3:],
            np.asarray(want[name]["w_alpha"])[..., 3:], rtol=1e-4,
            atol=1e-4)

    def test_round_loss(self, params, tiny_hnerv_cfg):
        p, sd = params
        jspec, tspec = _specs(tiny_hnerv_cfg, hadamard=True)
        js, ts = _states(p, sd, jspec, tspec, "mixed")
        for b in (20.0, 7.25, 2.0):
            want = float(jqm.round_loss(js, jspec, b, 0.01))
            got = float(tqm.round_loss(ts, tspec, b, 0.01))
            assert got == pytest.approx(want, rel=1e-5)

    @pytest.mark.parametrize("mode", ["uaq", "adaround", "mixed"])
    def test_collect_int_codes_exact(self, params, tiny_hnerv_cfg, mode):
        p, sd = params
        jspec, tspec = _specs(tiny_hnerv_cfg, hadamard=True)
        js, ts = _states(p, sd, jspec, tspec, mode)
        qmode = "uaq" if mode == "uaq" else "adaround"
        want = jqm.collect_int_codes(p, jspec, js, mode=qmode)
        got = tqm.collect_int_codes(sd, tspec, ts, mode=qmode)
        for name in jspec.layer_names:
            for leaf in ("w", "b", "w_delta", "w_zp", "b_delta", "b_zp"):
                np.testing.assert_array_equal(
                    got[name][leaf].numpy(), np.asarray(want[name][leaf]),
                    err_msg=f"{name}/{leaf}")
            assert got[name]["w"].dtype == torch.int32
            assert got[name]["bits"] == want[name]["bits"]

    def test_average_bits_exact(self, params, tiny_hnerv_cfg):
        p, sd = params
        jspec, tspec = _specs(tiny_hnerv_cfg)
        assert tqm.average_bits(sd, tspec) == jqm.average_bits(p, jspec)

    def test_quantize_params_is_differentiable(self, params, tiny_hnerv_cfg):
        """Gradients reach the deltas; a state that wants none builds no
        graph (the decode-time call)."""
        p, sd = params
        _, tspec = _specs(tiny_hnerv_cfg, hadamard=True)
        ts = tqm.init_quant_state(sd, tspec)
        out = tqm.quantize_params(sd, tspec, ts)
        assert all(not v.requires_grad for v in out.values())
        name = tspec.layer_names[2]
        ts[name]["w_delta"].requires_grad_()
        out = tqm.quantize_params(sd, tspec, ts)
        w = next(v for k, v in out.items() if v.requires_grad
                 and k.endswith("weight"))
        w.sum().backward()
        assert ts[name]["w_delta"].grad is not None

    def test_fq_impl_pallas_names_its_item(self, params, tiny_hnerv_cfg):
        """fq_impl='pallas' names the fused kernel of
        ops/fused_fakequant.py (ROADMAP queue A item 11): the same
        fake-quantized weights as 'jnp', here through its plain version."""
        _, sd = params
        spec = make_spec("hnerv", tiny_hnerv_cfg, hadamard=True,
                         fq_impl="pallas")
        assert spec.fq_impl == "pallas"
        plain = make_spec("hnerv", tiny_hnerv_cfg, hadamard=True)
        state = tqm.init_quant_state(sd, spec)
        got = tqm.quantize_params(sd, spec, state)
        want = tqm.quantize_params(sd, plain, state)
        assert all(torch.equal(got[k], want[k]) for k in want)
        with pytest.raises(ValueError, match="fq_impl"):
            make_spec("hnerv", tiny_hnerv_cfg, fq_impl="cuda")
