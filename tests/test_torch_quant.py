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
        from neuroquant_tpu_torch.utils.convert import layer_prefix

        p, sd = params
        jspec, tspec = _specs(tiny_hnerv_cfg, hadamard=True)
        js, ts = _states(p, sd, jspec, tspec, mode)
        qmode = "uaq" if mode == "uaq" else "adaround"
        want = jqm.quantize_params(p, jspec, js, mode=qmode, soft=False)
        got = tqm.quantize_params(sd, tspec, ts, mode=qmode, soft=False)
        codes = jqm.collect_int_codes(p, jspec, js, mode=qmode)
        for name, path, bits in zip(jspec.layer_names, jspec.layer_paths,
                                    jspec.n_bits):
            pre = layer_prefix(path)
            jl = jqm._get(want, path)
            np.testing.assert_allclose(
                got[f"{pre}.weight"].permute(2, 3, 1, 0).numpy(),
                np.asarray(jl["kernel"]), atol=1e-6, rtol=0)
            np.testing.assert_allclose(got[f"{pre}.bias"].numpy(),
                                       np.asarray(jl["bias"]), atol=1e-6,
                                       rtol=0)
            w, b = tqm._get(sd, path)
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
