"""The port's HNeRV against the JAX package's: encode and decode on the same
weights and frames, through the kernel path (fused tail + fused prefix
block, the plain versions on the CPU) and the unpacked path; checkpoint
loading; parameter-count goldens.

Tolerance 3e-5 absolute on [0, 1] frames: fp32 with another summation
order, and the fused tail's A&S GELU (within 1.5e-7 of the exact-erf GELU
the JAX XLA path uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.utils.torch_compat import params_to_state_dict, save_pth
from neuroquant_tpu_torch.models import build_model, param_counts
from neuroquant_tpu_torch.utils.convert import state_dict_from_jax

BUNNY = dict(
    crop_h=640, crop_w=1280, diff_enc=False, stage_block=1,
    enc_strides=[5, 4, 4, 2, 2], enc_channel=[64, 64, 64, 64, 16],
    channel_reduce=1.2, channel_lbound=12, dec_in_channel=92,
    dec_kernels=[1, 3, 5, 5, 5], dec_strides=[5, 4, 4, 2, 2],
    dec_norm="none", dec_acts="gelu", out_bias="tanh", loss="l2", epoch=300,
    workers=0, eval_freq=30, batch_size=1, learning_rate=0.0005)


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_case(tiny_hnerv_cfg):
    rng = np.random.RandomState(0)
    frames = rng.rand(2, 80, 160, 3).astype(np.float32)
    model = jax_build_model("hnerv", dict(tiny_hnerv_cfg, fused_tail="off"))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(frames))
    return frames, params


def _port(cfg, params):
    model = build_model("hnerv", cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax("hnerv", _np_params(params)),
                          strict=True)
    return model.eval()


class TestParity:
    @pytest.mark.parametrize("path", ["kernel", "unpacked"])
    def test_encode_decode(self, jax_case, tiny_hnerv_cfg, monkeypatch, path):
        from neuroquant_tpu.models import layers

        # the JAX fused prefix runs only on grids >= PREFIX_MIN_GRID; the
        # port fuses it at any size, so the tiny grid needs the gate at 1
        monkeypatch.setattr(layers, "PREFIX_MIN_GRID", 1)
        frames, params = jax_case
        extra = (dict(fused_tail="pallas") if path == "kernel"
                 else dict(packed_tail="off"))
        cfg = dict(tiny_hnerv_cfg, **extra)
        jm = jax_build_model("hnerv", cfg)
        emb = jm.apply(params, jnp.asarray(frames), method="encode")
        want = np.asarray(jm.apply(params, emb, method="decode"))

        tm = _port(cfg, params)
        assert (tm.pack_start is None) == (path == "unpacked")
        with torch.no_grad():
            temb = tm.encode(torch.from_numpy(frames))
            got = tm.decode(temb).numpy()
        np.testing.assert_allclose(temb.numpy(), np.asarray(emb), atol=1e-5,
                                   rtol=1e-5)
        assert got.shape == want.shape == frames.shape
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)

    def test_kernel_path_equals_unpacked(self, jax_case, tiny_hnerv_cfg):
        frames, params = jax_case
        x = torch.from_numpy(frames)
        with torch.no_grad():
            a = _port(tiny_hnerv_cfg, params)(x)
            b = _port(dict(tiny_hnerv_cfg, packed_tail="off"), params)(x)
            c = _port(dict(tiny_hnerv_cfg, fused_prefix="off"), params)(x)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5, rtol=0)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=3e-5, rtol=0)

    def test_packed_weights_follow_the_weights(self, jax_case,
                                               tiny_hnerv_cfg):
        """The kernel path packs its weights once and keeps them while the
        weights stay; a load_state_dict or an in-place update repacks."""
        frames, params = jax_case
        x = torch.from_numpy(frames)
        model = _port(tiny_hnerv_cfg, params)
        other = build_model("hnerv", tiny_hnerv_cfg, device="cpu").eval()
        other.reset_parameters(torch.Generator().manual_seed(3))
        with torch.no_grad():
            emb = model.encode(x)
            first = model.decode(emb)
            kept = dict(model._packed)
            assert set(kept) == {("prefix", 5, 10, torch.float32),
                                 ("tail", 20, 40, torch.float32)}
            model.decode(emb)
            assert all(model._packed[k][1] is kept[k][1] for k in kept)

            model.load_state_dict(other.state_dict())
            np.testing.assert_allclose(model.decode(emb).numpy(),
                                       other.decode(emb).numpy(), atol=1e-6)
            model.head_layer.bias.add_(0.25)
            other.head_layer.bias.add_(0.25)
            np.testing.assert_allclose(model.decode(emb).numpy(),
                                       other.decode(emb).numpy(), atol=1e-6)
        model.load_state_dict(_port(tiny_hnerv_cfg, params).state_dict())
        with torch.no_grad():
            np.testing.assert_array_equal(model.decode(emb).numpy(),
                                          first.numpy())
        # with gradients on nothing is kept, so no graph outlives a call
        model._packed.clear()
        model.decode(emb.detach())
        assert model._packed == {}


class TestCheckpoints:
    def test_state_dict_from_jax_matches_torch_compat(self, jax_case):
        _, params = jax_case
        want = params_to_state_dict("hnerv", params)
        got = state_dict_from_jax("hnerv", _np_params(params))
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    def test_jax_pth_loads_strict(self, jax_case, tiny_hnerv_cfg, tmp_path):
        _, params = jax_case
        path = str(tmp_path / "model.pth")
        save_pth(path, "hnerv", params)
        model = build_model("hnerv", tiny_hnerv_cfg, device="cpu")
        model.load_state_dict(torch.load(path, weights_only=True), strict=True)
        np.testing.assert_array_equal(
            model.head_layer.weight.detach().numpy(),
            np.transpose(np.asarray(params["params"]["head_layer"]["kernel"]),
                         (3, 2, 0, 1)))


class TestBunny:
    def test_param_count_goldens(self):
        model = build_model("hnerv", BUNNY, device="cpu")
        enc, dec, tot = param_counts("hnerv", BUNNY, model, 640 * 1280, 132)
        assert (f"Encoder_{round(enc, 2)}M_Decoder_{round(dec, 2)}M"
                f"_Total_{round(tot, 2)}M") == \
            "Encoder_0.31M_Decoder_2.65M_Total_2.66M"

    @pytest.mark.parametrize("size", ["tiny", "bunny"])
    def test_tail_plan_for_matches_jax(self, tiny_hnerv_cfg, size):
        from neuroquant_tpu.models import example_input as jax_example_input
        from neuroquant_tpu.models import tail_plan_for as jax_tail_plan_for
        from neuroquant_tpu_torch.models import example_input, tail_plan_for

        cfg = BUNNY if size == "bunny" else tiny_hnerv_cfg
        (jplan, jf, jch), (tplan, tf_, tch) = (jax_tail_plan_for("hnerv", cfg),
                                               tail_plan_for("hnerv", cfg))
        assert (tf_, tch) == (jf, jch)
        assert (tplan.h, tplan.w, tplan.pad, tplan.tm, tplan.mp) == (
            jplan.h, jplan.w, jplan.pad, jplan.tm, jplan.mp)
        assert [(L.cin, L.cout, L.side, L.off, L.gelu_in, L.sparse)
                for L in tplan.layers] == [
            (L.cin, L.cout, L.side, L.off, L.gelu_in, L.sparse)
            for L in jplan.layers]
        assert tuple(example_input("hnerv", cfg, 2, device="cpu").shape) == \
            tuple(jax_example_input("hnerv", cfg, 2).shape)

    def test_bunny_resolves_pack_start_3(self):
        from neuroquant_tpu.models.hnerv import HNeRVConfig
        from neuroquant_tpu.ops.packed_decode import resolve_pack_start

        c = HNeRVConfig.from_cfg(BUNNY)
        chans = c.decoder_channels()
        want = resolve_pack_start(c.packed_tail, c.dec_kernels, c.dec_strides,
                                  c.dec_norm, [c.dec_in_channel] + chans[:-1],
                                  chans, c.crop_h, c.crop_w)
        assert build_model("hnerv", BUNNY, device="cpu").pack_start == want == 3
