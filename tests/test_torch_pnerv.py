"""The port's PNeRV1 and PNeRV2 against the JAX package's, on the 80x160
fixture with the tiny PNeRV (kfc grid 10x20, 10 channels, strides [2, 2,
2]) and at Bunny-3M's shapes: KFcBias and BatchNorm2d, the decode on the
fused tail's kernel path (their plain versions on the CPU) and on the plain
chain, ``decode_cf`` and its gradients, the bf16 fusion stages,
``decode_jvp``'s tangent, weights across the packages, the quantized
layers, parameter counts, the output directory and the fused tail's plan.
The JAX package runs its fused tail through the kernels' plain reference,
as its own CPU tests run it (``fused_tail: jnp``, the jnp twin of the Pallas
kernels), and its forward mode on the XLA packed path (``off``).

Tolerances: fp32 decode 1e-5 absolute on [0, 1] frames (fp32 in another
order; the fused tail's A&S GELU); the bf16 fusion stages 2e-3 absolute
(measured: 2.4e-4 PNeRV1, bf16 rounding in another conv order), and the
bf16 decode differs from the fp32 one by more than 1e-5; decode_cf's
gradients 1e-4 of each leaf's largest; the tangent 1e-4 of its largest
(the value 1e-5); KFcBias and BatchNorm2d 1e-5 absolute."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.models import layers as jlayers
from neuroquant_tpu.utils.torch_compat import (
    params_to_state_dict, save_pth, state_dict_to_params)
from neuroquant_tpu_torch.models import (
    build_model, example_input, param_counts, quant_layer_paths,
    tail_plan_for)
from neuroquant_tpu_torch.models.layers import BatchNorm2d, KFcBias
from neuroquant_tpu_torch.quantization import make_spec
from neuroquant_tpu_torch.utils.convert import (
    layer_prefix, save_pth as port_save_pth, state_dict_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "configs", "PNeRV",
                       "Bunny_1280x640_3M.yaml")) as _f:
    BUNNY = yaml.safe_load(_f)
ARCHS = ("pnerv", "pnerv2")
TOL = 1e-5
BF16_TOL = 2e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def setup(tiny_pnerv_cfg, frame_dir):
    """Per arch: the JAX init on a seed, its state dict and the port's
    model on it (kernel path), on two of the fixture's frames."""
    cfg = dict(tiny_pnerv_cfg)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)[:2]
    out = {"cfg": cfg, "frames": frames}
    for arch in ARCHS:
        jm = jax_build_model(arch, dict(cfg, fused_tail="jnp"))
        params = jax.jit(jax_build_model(arch, cfg).init)(
            jax.random.PRNGKey(0), jnp.asarray(frames))
        sd = state_dict_from_jax(arch, _np(params))
        tm = build_model(arch, cfg, device="cpu")
        tm.load_state_dict(sd, strict=True)
        out[arch] = dict(jm=jm, params=params, sd=sd, tm=tm)
    return out


def _port(arch, cfg, sd, **extra):
    tm = build_model(arch, dict(cfg, **extra), device="cpu")
    tm.load_state_dict(sd, strict=True)
    return tm


class TestLayers:
    def test_kfc_bias_matches_jax_and_init_shapes(self):
        rng = np.random.RandomState(0)
        jm = jlayers.KFcBias(in_height=2, in_width=3, out_height=8,
                             out_width=12, channels=5)
        x = rng.randn(2, 2, 3, 5).astype(np.float32)
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
        # biases at zero in both inits: give them values to test the sum
        params = jax.tree_util.tree_map(
            lambda v: v + rng.randn(*v.shape).astype(np.float32) * 0.1,
            _np(params))
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        m = KFcBias(2, 3, 8, 12, 5)
        m.reset_parameters(torch.Generator().manual_seed(0))
        shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
        assert shapes == {k: v.shape for k, v in
                          params["params"].items()} == {
            "w_L": (1, 5, 8, 2), "w_R": (1, 5, 3, 12), "b_h": (8, 1),
            "b_w": (1, 12), "b_c": (5, 1)}
        assert all(not m.state_dict()[k].any() for k in ("b_h", "b_w",
                                                         "b_c"))
        # kaiming fan-out: std sqrt(2 / (C * last dim)) for both factors
        big = KFcBias(64, 64, 64, 64, 64)
        big.reset_parameters(torch.Generator().manual_seed(0))
        assert float(big.w_L.detach().std()) == pytest.approx(
            (2 / (64 * 64)) ** 0.5, rel=0.02)
        m.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in params["params"].items()})
        got = m(torch.from_numpy(x)).detach().numpy()
        assert got.shape == want.shape == (2, 8, 12, 5)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    def test_batch_norm_uses_batch_statistics(self):
        rng = np.random.RandomState(1)
        x = (rng.randn(3, 4, 5, 6) * 2 + 1).astype(np.float32)
        jm = jlayers.BatchNorm2d(features=6)
        params = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        params["params"]["scale"] = rng.rand(6).astype(np.float32) + 0.5
        params["params"]["bias"] = rng.randn(6).astype(np.float32)
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        m = BatchNorm2d(6)
        assert sorted(m.state_dict()) == ["bias", "weight"]
        m.load_state_dict({"weight": torch.from_numpy(
            params["params"]["scale"]), "bias": torch.from_numpy(
            params["params"]["bias"])})
        got = m(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        # a frame's output depends on its batch: frame 0 alone differs
        alone = m(torch.from_numpy(x[:1])).detach().numpy()
        assert np.abs(alone - got[:1]).max() > 1e-2


class TestDecode:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("path", ["kernel", "plain"])
    def test_decode_matches_jax(self, setup, arch, path):
        """The kernel path (the post-fusion tail on tail_conv_cf, pack_cf,
        unpack_frames) and the packed_tail: off chain, against the JAX
        decode on its fused tail."""
        s, a = setup, setup[arch]
        want = np.asarray(a["jm"].apply(a["params"],
                                        jnp.asarray(s["frames"])))
        extra = {} if path == "kernel" else dict(packed_tail="off")
        tm = _port(arch, s["cfg"], a["sd"], **extra)
        assert tm.tail_packed == (path == "kernel")
        with torch.no_grad():
            got = tm(torch.from_numpy(s["frames"])).numpy()
            if path == "kernel":
                assert set(tm._packed) == {("tail", 40, 80, torch.float32)}
        assert got.shape == want.shape == s["frames"].shape
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    def test_decode_takes_the_configured_activation(self, setup):
        """dec_acts other than gelu: no packed tail (as in JAX), every block
        and the shortcuts on the configured activation."""
        s, a = setup, setup["pnerv"]
        cfg = dict(s["cfg"], dec_acts="relu")
        jm = jax_build_model("pnerv", cfg)
        want = np.asarray(jm.apply(a["params"], jnp.asarray(s["frames"])))
        tm = _port("pnerv", cfg, a["sd"])
        assert not tm.tail_packed
        with torch.no_grad():
            got = tm(torch.from_numpy(s["frames"])).numpy()
            gelu = a["tm"](torch.from_numpy(s["frames"])).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        assert np.abs(got - gelu).max() > 1e-3

    @pytest.mark.parametrize("arch", ARCHS)
    def test_decode_cf_and_weight_gradients(self, setup, arch):
        s, a = setup, setup[arch]
        jm = a["jm"]
        emb = jm.apply(a["params"], jnp.asarray(s["frames"]),
                       method="encode")
        shape = jm.apply(a["params"], emb, method="decode_cf").shape
        wt = np.random.RandomState(1).randn(*shape).astype(np.float32)

        def jf(p):
            out = jm.apply(p, emb, method="decode_cf")
            return (out * wt).sum(), out

        (_, want), jg = jax.value_and_grad(jf, has_aux=True)(a["params"])
        tm = a["tm"]
        tm.zero_grad()
        got = tm.decode_cf(torch.from_numpy(np.array(emb)))
        (got * torch.from_numpy(wt)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=TOL, rtol=0)
        want_g = state_dict_from_jax(arch, _np(jg))
        for name, prm in tm.named_parameters():
            if name.startswith("enc_layers."):
                assert prm.grad is None
                continue
            _close(prm.grad.numpy(), want_g[name].numpy(), 1e-4)
        tm.zero_grad()

    @pytest.mark.parametrize("arch", ARCHS)
    def test_bf16_fusion_matches_jax(self, setup, arch):
        """bsm_dtype bfloat16: PNeRV1's BSM convs and gate in bf16 against
        the JAX bf16 stage at a measured tolerance, and unlike the fp32
        decode; PNeRV2 runs its stages in fp32 whatever the key says, as
        the JAX package's does."""
        s, a = setup, setup[arch]
        cfg = dict(s["cfg"], bsm_dtype="bfloat16")
        jm = jax_build_model(arch, dict(cfg, fused_tail="jnp"))
        want = np.asarray(jm.apply(a["params"], jnp.asarray(s["frames"])))
        tm = _port(arch, cfg, a["sd"])
        x = torch.from_numpy(s["frames"])
        with torch.no_grad():
            got = tm(x).numpy()
            fp32 = a["tm"](x).numpy()
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)
        gap = np.abs(got - fp32).max()
        if arch == "pnerv":
            assert tm.cfg.bsm_dtype == "bfloat16" and gap > 1e-5, gap
        else:
            np.testing.assert_array_equal(got, fp32)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_float64_fusion_matches_jax(self, setup, arch):
        """bsm_dtype float32 in a model moved to float64: every BSM conv
        runs in float64 (as the JAX stage runs in its input's dtype), and
        the plain-chain decode matches the JAX decode in float64 to 1e-12
        absolute (float64 in another order)."""
        s, a = setup, setup[arch]
        cfg = dict(s["cfg"], packed_tail="off")
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(
                lambda v: jnp.asarray(np.asarray(v, np.float64)),
                a["params"])
            want = np.asarray(jax_build_model(arch, cfg).apply(
                p64, jnp.asarray(s["frames"].astype(np.float64))))
        assert want.dtype == np.float64
        tm = _port(arch, cfg, a["sd"]).to(torch.float64)
        dtypes = []
        bsm = [*tm.dec_bsm_z, *getattr(tm, "dec_bsm_r", []), *tm.dec_bsm_h]
        hooks = [m.register_forward_hook(
            lambda m, i, o: dtypes.append(o.dtype)) for m in bsm]
        with torch.no_grad():
            got = tm(torch.from_numpy(s["frames"].astype(np.float64)))
        for h in hooks:
            h.remove()
        assert dtypes == [torch.float64] * len(bsm)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("route", ["off", "pallas_hvp"])
    def test_decode_tangent_matches_jax_jvp(self, setup, arch, route):
        """decode_jvp with tangents on every quantized conv, on the plain
        chain and on the kernels' forward-mode tail, against ``jax.jvp``
        of the JAX decode in the conv kernels (the KFc, BatchNorm and
        encoder leaves without tangent)."""
        s, a = setup, setup[arch]
        rng = np.random.RandomState(2)
        tm = _port(arch, s["cfg"], a["sd"], fused_tail=route)
        keys = tm.jvp_keys()
        assert keys == [f"{layer_prefix(p, arch)}.weight"
                        for p in quant_layer_paths(arch, s["cfg"])]
        dws = [(rng.randn(*a["sd"][k].shape) * 0.01).astype(np.float32)
               for k in keys]
        tangent = state_dict_to_params(
            arch, dict(zip(keys, dws)),
            jax.tree_util.tree_map(np.zeros_like, _np(a["params"])))
        x = jnp.asarray(s["frames"])
        jm = jax_build_model(arch, dict(s["cfg"], fused_tail="off"))
        y, dy = jax.jvp(lambda p: jm.apply(p, x), (a["params"],),
                        (tangent,))
        with torch.no_grad():
            emb = tm.encode(torch.from_numpy(s["frames"]))
            got, dgot = tm.decode_jvp(emb, [torch.from_numpy(d)
                                            for d in dws])
            assert tm.decode_jvp(emb)[1] is None
            if route == "pallas_hvp":
                assert torch.equal(tm.decode(emb), got)
        assert float(np.abs(np.asarray(dy)).max()) > 0
        _close(got.numpy(), y, 1e-5)
        _close(dgot.numpy(), dy, 1e-4)


class TestWeights:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_state_dict_both_ways(self, setup, arch):
        """The port's conversion equals ``params_to_state_dict`` key for
        key, the KFc leaves verbatim; the JAX ``state_dict_to_params``
        takes the port's state dict back to the same leaves."""
        a = setup[arch]
        want = params_to_state_dict(arch, a["params"])
        got = state_dict_from_jax(arch, _np(a["params"]))
        assert list(got) == list(want)
        assert set(got) == set(a["tm"].state_dict())
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        back = state_dict_to_params(
            arch, {k: v.numpy() for k, v in a["tm"].state_dict().items()},
            a["params"])
        for u, v in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(a["params"])):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))

    def test_pth_files_load_in_both_packages(self, setup, tmp_path):
        from neuroquant_tpu.utils.torch_compat import load_pth
        from neuroquant_tpu_torch.methods.common import load_pth as tload

        s, a = setup, setup["pnerv"]
        save_pth(str(tmp_path / "jax.pth"), "pnerv", a["params"])
        model = build_model("pnerv", s["cfg"], device="cpu")
        model.load_state_dict(torch.load(tmp_path / "jax.pth",
                                         weights_only=True), strict=True)
        other = build_model("pnerv", s["cfg"], device="cpu", seed=4)
        port_save_pth(str(tmp_path / "port.pth"), other)
        back = state_dict_from_jax(
            "pnerv", _np(load_pth(str(tmp_path / "port.pth"), "pnerv",
                                  a["params"])))
        tload(str(tmp_path / "port.pth"), model)
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(back[k].numpy(), v.numpy())
            np.testing.assert_array_equal(
                v.numpy(), other.state_dict()[k].numpy())


class _ShapesOnly:
    """A JAX model whose init gives the parameters' shapes, no values: no
    forward pass at 640x1280."""

    def __init__(self, model):
        self.model = model

    def init(self, rng, x):
        return jax.eval_shape(self.model.init, rng, x)


class TestLayout:
    @pytest.mark.parametrize("arch,n", [("pnerv", 19), ("pnerv1", 19),
                                        ("pnerv2", 15)])
    def test_quant_layer_paths_match_jax(self, arch, n):
        from neuroquant_tpu.models import quant_layer_paths as jpaths

        for cfg in (BUNNY, None):
            got = quant_layer_paths(arch, cfg)
            assert got == jpaths(arch, cfg) and len(got) == n
        model = build_model(arch, dict(BUNNY, crop_h=80, crop_w=160,
                                       enc_strides=[5, 4, 4],
                                       kfc_h_w_c=[10, 20, 4]), device="cpu")
        spec = make_spec(arch, BUNNY)
        assert [pre + ".weight" for pre in spec.layer_keys] == [
            layer_prefix(p, arch) + ".weight"
            for p in quant_layer_paths(arch, BUNNY)] == model.jvp_keys()

    @pytest.mark.parametrize("size", ["tiny", "bunny"])
    def test_param_counts_and_run_directory_match_jax(self, size,
                                                      tiny_pnerv_cfg,
                                                      monkeypatch):
        """The JAX ``setup_run`` (on parameter shapes) and the port's: the
        same counts and directory (Bunny-3M: PNeRV1
        Encoder_0.35M_Decoder_2.41M_Total_2.42M, PNeRV2
        Encoder_0.35M_Decoder_2.25M_Total_2.27M)."""
        from types import SimpleNamespace

        from neuroquant_tpu.methods import common as jcommon
        from neuroquant_tpu_torch.methods import common as tcommon

        monkeypatch.setattr(jcommon, "build_model", lambda arch, cfg:
                            _ShapesOnly(jax_build_model(arch, cfg)))
        base = BUNNY if size == "bunny" else tiny_pnerv_cfg
        n = 132 if size == "bunny" else 8
        for arch in ARCHS:
            run = {}
            for name, common in (("jax", jcommon), ("port", tcommon)):
                args = SimpleNamespace(arch=arch, outf="o", seed=0,
                                       full_data_length=n)
                cfg = dict(base)
                if name == "jax":
                    common.setup_run(args, cfg, jax.random.PRNGKey(0))
                else:
                    common.setup_run(args, cfg, device="cpu")
                run[name] = (args.outf, args.encoder_param,
                             args.decoder_param, args.total_param)
            assert run["port"][0] == run["jax"][0], (arch, run)
            assert run["port"][1:] == pytest.approx(run["jax"][1:],
                                                    abs=1e-12)
            model = build_model(arch, base, device="cpu")
            assert param_counts(arch, base, model, base["crop_h"]
                                * base["crop_w"], n) == pytest.approx(
                run["jax"][1:], abs=1e-12)
            if size == "bunny":
                assert run["port"][0] == {
                    "pnerv": "o/Encoder_0.35M_Decoder_2.41M_Total_2.42M",
                    "pnerv2": "o/Encoder_0.35M_Decoder_2.25M_Total_2.27M",
                }[arch]

    @pytest.mark.parametrize("size", ["tiny", "bunny"])
    def test_tail_plan_for_matches_jax(self, tiny_pnerv_cfg, size):
        from neuroquant_tpu.models import example_input as jax_example_input
        from neuroquant_tpu.models import tail_plan_for as jax_tail_plan_for

        cfg = BUNNY if size == "bunny" else tiny_pnerv_cfg
        for arch in ARCHS:
            # the JAX package packs Bunny's tied tail where its kernels run
            (jplan, jf, jch) = jax_tail_plan_for(
                arch, dict(cfg, fused_tail="pallas"))
            (tplan, tf_, tch) = tail_plan_for(arch, cfg)
            assert (tf_, tch) == (jf, jch) == (2, 12)
            assert (tplan.h, tplan.w, tplan.pad, tplan.tm, tplan.mp) == (
                jplan.h, jplan.w, jplan.pad, jplan.tm, jplan.mp)
            assert [(L.cin, L.cout, L.side, L.off, L.gelu_in, L.sparse)
                    for L in tplan.layers] == [
                (L.cin, L.cout, L.side, L.off, L.gelu_in, L.sparse)
                for L in jplan.layers]
            assert tail_plan_for(arch, dict(cfg, packed_tail="off")) is None
            got = example_input(arch, cfg, 2, device="cpu")
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax_example_input(arch, cfg, 2)))

    def test_bunny_geometry(self):
        """PNeRV1 Bunny-3M: the tail enters at 320x640 with 100 channels,
        block 100 -> 400 (pack start 0, its cin padded to 104) and the head
        at f = 2 (12 channels, padded to 16); the KFc shortcut of the last
        stage maps the (2, 4) embedding to 320x640."""
        plan, f, ch = tail_plan_for("pnerv", BUNNY)
        assert (plan.h, plan.w, f, ch) == (320, 640, 2, 12)
        assert [(L.cin, L.cout) for L in plan.layers] == [(104, 400),
                                                          (400, 16)]
        model = build_model("pnerv", BUNNY, device="cpu")
        assert model.tail_packed and model.n_fused == 4
        assert tuple(model.dec_shortcuts[9].w_L.shape) == (1, 16, 320, 2)
        assert tuple(model.dec_shortcuts[9].w_R.shape) == (1, 16, 4, 640)
        assert tuple(model.dec_layers[4].conv[0].weight.shape) == (
            400, 100, 3, 3)
        assert model.cfg.bsm_dtype == "bfloat16"
