"""The port's NeRV against the JAX package's, on the 80x160 fixture with the
tiny NeRV (fc (1, 2)) and at Bunny-3M's shapes: the position encoding, the
decode through the kernel path (fused tail and fused prefix block, the
plain versions on the CPU) and the unpacked path, ``decode_cf`` and its
gradients, ``decode_jvp``'s tangent, the Omega and Fisher scores on both
HVP routes, weights across the packages, parameter counts, the output
directory and the fused tail's plan. The JAX fused prefix runs with its
grid gate at 1, as the port fuses at any grid.

Tolerances: the encoding's table bit for bit, its fp32 formula 1e-5
absolute; decode 3e-5 absolute on [0, 1] frames (fp32 in another order, the
fused tail's A&S GELU, JAX's transposed-conv layer 0); decode_cf's
gradients 1e-4 of each leaf's largest; the tangent 1e-4 of its largest
(the value 1e-5); Hv 1e-4 of each leaf's largest; per-layer omega scores
1e-4 of the layer's sum of |Hv * v|; per-layer Fisher scores 1e-5
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.models import layers as jlayers
from neuroquant_tpu.quantization import qmodel as jqm
from neuroquant_tpu.quantization import sensitivity as jsens
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu.utils.torch_compat import (
    params_to_state_dict, save_pth, state_dict_to_params)
from neuroquant_tpu_torch.models import (
    build_model, example_input, param_counts, quant_layer_paths,
    tail_plan_for)
from neuroquant_tpu_torch.models.layers import PositionEncoding
from neuroquant_tpu_torch.quantization import (
    get_perturbation, hessian_vector_product, make_spec,
    sensitivity_criterion)
from neuroquant_tpu_torch.utils.convert import (
    quant_state_from_numpy, save_pth as port_save_pth, state_dict_from_jax)

BUNNY = dict(
    crop_h=640, crop_w=1280, diff_enc=False, base=1.25, level=80,
    channel_reduce=2, channel_lbound=24, dec_in_channel=145,
    dec_kernels=[3, 3, 3, 3, 3], dec_strides=[5, 4, 4, 2, 2],
    dec_norm="none", dec_acts="gelu", out_bias="tanh", loss="l2", epoch=300,
    workers=4, eval_freq=30, batch_size=1, learning_rate=0.0005)
BITS = (5, 6, 3, 4, 5)
SEED = 903
BATCH = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_fused_prefix():
    mp = pytest.MonkeyPatch()
    mp.setattr(jlayers, "PREFIX_MIN_GRID", 1)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def setup(tiny_nerv_cfg, frame_dir, jax_fused_prefix):
    cfg = dict(tiny_nerv_cfg, n_frames=8)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    norm_idx = np.arange(8, dtype=np.float32) / 8
    jm = {ft: jax_build_model("nerv", dict(cfg, fused_tail=ft))
          for ft in ("off", "pallas")}
    params = jax.jit(jm["off"].init)(jax.random.PRNGKey(0),
                                     jnp.asarray(norm_idx[:1]))
    sd = state_dict_from_jax("nerv", _np(params))
    tm = {}
    for ft in ("off", "pallas_hvp", "auto"):
        tm[ft] = build_model("nerv", dict(cfg, fused_tail=ft), device="cpu")
        tm[ft].load_state_dict(sd, strict=True)
        tm[ft].eval()
    return dict(cfg=cfg, frames=frames, norm_idx=norm_idx, jm=jm,
                params=params, sd=sd, tm=tm)


class TestPositionEncoding:
    @pytest.mark.parametrize("level,n", [(16, 8), (80, 132)],
                             ids=["fixture", "bunny"])
    def test_table_is_the_jax_table_bit_for_bit(self, level, n):
        """Every frame's row, through the module as the decode calls it,
        equal to the JAX ``_reference_table`` and to the JAX module's
        output."""
        want = jlayers.PositionEncoding(base=1.25, level=level,
                                        n_frames=n)._reference_table()
        pos = np.arange(n, dtype=np.float32) / n
        got = PositionEncoding(1.25, level, n)(torch.from_numpy(pos))
        assert got.shape == (n, 1, 1, 2 * level)
        np.testing.assert_array_equal(got.reshape(n, -1).numpy(), want)
        jpe = jlayers.PositionEncoding(base=1.25, level=level, n_frames=n)
        out = jpe.apply({}, jnp.asarray(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(out))

    def test_row_is_the_rounded_position(self):
        """pos -> row clip(round(pos * n), 0, n - 1), half to even."""
        pe = PositionEncoding(1.25, 4, 8)
        table = pe(torch.arange(8, dtype=torch.float32) / 8)
        pos = torch.tensor([0.0624, 0.0625, 0.1875, 0.99, -0.2, 1.5])
        rows = [0, 0, 2, 7, 0, 7]
        np.testing.assert_array_equal(pe(pos).numpy(), table[rows].numpy())

    def test_fp32_formula_matches_jax(self):
        pos = np.random.RandomState(0).rand(6).astype(np.float32)
        jpe = jlayers.PositionEncoding(base=1.25, level=16)
        want = np.asarray(jpe.apply({}, jnp.asarray(pos)))
        got = PositionEncoding(1.25, 16)(torch.from_numpy(pos)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    def test_table_is_made_once_per_device(self):
        from neuroquant_tpu_torch.models import layers

        layers._pe_table.cache_clear()
        pe = PositionEncoding(1.25, 16, 8)
        for i in range(3):
            pe(torch.tensor([i / 8]))
        info = layers._pe_table.cache_info()
        assert (info.misses, info.hits) == (1, 2)


class TestDecode:
    @pytest.mark.parametrize("path", ["kernel", "unpacked"])
    def test_decode_matches_jax(self, setup, path):
        s = setup
        extra = (dict(fused_tail="pallas") if path == "kernel"
                 else dict(packed_tail="off"))
        cfg = dict(s["cfg"], **extra)
        jm = jax_build_model("nerv", cfg)
        want = np.asarray(jm.apply(s["params"], jnp.asarray(s["norm_idx"])))
        tm = build_model("nerv", cfg, device="cpu")
        tm.load_state_dict(s["sd"], strict=True)
        assert (tm.pack_start is None) == (path == "unpacked")
        with torch.no_grad():
            got = tm(torch.from_numpy(s["norm_idx"])).numpy()
        assert got.shape == want.shape == s["frames"].shape
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)

    def test_kernel_path_equals_unpacked(self, setup):
        """The fused prefix block and tail against the plain chain and
        against the kernel path without the fused prefix; the packed
        weights kept per geometry."""
        s = setup
        idx = torch.from_numpy(s["norm_idx"])
        outs = []
        for extra in ({}, dict(packed_tail="off"), dict(fused_prefix="off")):
            tm = build_model("nerv", dict(s["cfg"], **extra), device="cpu")
            tm.load_state_dict(s["sd"], strict=True)
            with torch.no_grad():
                outs.append(tm(idx).numpy())
            if not extra:
                assert tm.pack_start == 2
                assert set(tm._packed) == {("prefix", 5, 10, torch.float32),
                                           ("tail", 20, 40, torch.float32)}
        for other in outs[1:]:
            np.testing.assert_allclose(outs[0], other, atol=3e-5, rtol=0)

    def test_decode_cf_and_weight_gradients(self, setup):
        s = setup
        jm = s["jm"]["pallas"]
        emb = jm.apply(s["params"], jnp.asarray(s["norm_idx"][:2]),
                       method="encode")
        shape = jm.apply(s["params"], emb, method="decode_cf").shape
        wt = np.random.RandomState(1).randn(*shape).astype(np.float32)

        def jf(p):
            out = jm.apply(p, emb, method="decode_cf")
            return (out * wt).sum(), out

        (_, want), jg = jax.value_and_grad(jf, has_aux=True)(s["params"])
        tm = s["tm"]["auto"]
        tm.zero_grad()
        got = tm.decode_cf(torch.from_numpy(np.array(emb)))
        (got * torch.from_numpy(wt)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=3e-5, rtol=0)
        want_g = state_dict_from_jax("nerv", _np(jg))
        names = [n for n, _ in tm.named_parameters()]
        assert set(names) == set(want_g) and len(names) == 10
        for name, prm in tm.named_parameters():
            _close(prm.grad.numpy(), want_g[name].numpy(), 1e-4)
        tm.zero_grad()

    @pytest.mark.parametrize("route", ["off", "pallas_hvp"])
    def test_decode_tangent_matches_jax_jvp(self, setup, route):
        """decode_jvp with tangents on every decoder conv, on the plain
        unpacked decode and on the kernels' forward-mode prefix and tail,
        against ``jax.jvp`` of the JAX decode in the conv kernels."""
        s = setup
        rng = np.random.RandomState(2)
        convs = ["decoder.0.weight", "decoder.1.conv.0.weight",
                 "decoder.2.conv.0.weight", "decoder.3.conv.0.weight",
                 "head_layer.weight"]
        dws = [(rng.randn(*s["sd"][k].shape) * 0.01).astype(np.float32)
               for k in convs]
        tangent = state_dict_to_params(
            "nerv", dict(zip(convs, dws)),
            jax.tree_util.tree_map(np.zeros_like, _np(s["params"])))
        jm = s["jm"]["off"]
        idx = jnp.asarray(s["norm_idx"][:2])
        (y, dy) = jax.jvp(lambda p: jm.apply(p, idx), (s["params"],),
                          (tangent,))
        tm = s["tm"][route]
        with torch.no_grad():
            emb = tm.encode(torch.from_numpy(s["norm_idx"][:2]))
            got, dgot = tm.decode_jvp(emb, [torch.from_numpy(d)
                                            for d in dws])
            if route == "pallas_hvp":
                assert torch.equal(tm.decode(emb), got)
        assert float(np.abs(np.asarray(dy)).max()) > 0
        _close(got.numpy(), y, 1e-5)
        _close(dgot.numpy(), dy, 1e-4)


@pytest.fixture(scope="module")
def scores(setup):
    """The JAX criterion's per-layer omega and Fisher scores on its plain
    execution, its Hv summed over the same batches, and the batches."""
    s = setup
    jspec = jax_make_spec("nerv", s["cfg"], hadamard=True).with_bits(BITS)
    jstate = jqm.init_quant_state(s["params"], jspec)
    n = s["frames"].shape[0]
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(SEED), n))
    nb = min(jsens.MAX_BATCHES, n // BATCH)
    batches = perm[:nb * BATCH].reshape(nb, BATCH)
    args = (s["jm"]["off"], s["params"], jspec, jstate,
            jnp.asarray(s["frames"]), jnp.asarray(s["norm_idx"]), BATCH)
    _, omega = jsens.sensitivity_criterion("omega", "nerv", *args, seed=SEED,
                                           log_fn=lambda m: None)
    _, fisher = jsens.sensitivity_criterion("fisher_diag", "nerv", *args,
                                            seed=SEED, log_fn=lambda m: None)
    vec = [np.asarray(v) for v in jqm.get_perturbation(s["params"], jspec,
                                                       jstate)]
    return dict(jstate=jstate, batches=batches, omega=omega, fisher=fisher,
                vec=vec)


@pytest.mark.parametrize("route", ["off", "pallas_hvp"])
def test_omega_matches_jax(setup, scores, route):
    """Per-layer omega scores on the plain unpacked decode (--hvp_impl
    xla) and on the kernels' forward-mode tail (--hvp_impl pallas), the
    model encoding the frames' indices, against the JAX criterion."""
    s, j = setup, scores
    model = s["tm"][route]
    tspec = make_spec("nerv", s["cfg"], hadamard=True).with_bits(BITS)
    tstate = quant_state_from_numpy(_np(j["jstate"]))
    vec = get_perturbation(s["sd"], tspec, tstate)
    for g, w in zip(vec, j["vec"]):
        _close(g.numpy(), w, 1e-6)
    frames, norm_idx = (torch.from_numpy(s["frames"]),
                        torch.from_numpy(s["norm_idx"]))
    hv = hessian_vector_product(model, tspec, vec, frames, norm_idx,
                                j["batches"])
    mags = [float((h * v).abs().sum()) for h, v in zip(hv, vec)]
    _, per_layer = sensitivity_criterion(
        "omega", "nerv", model, s["sd"], tspec, tstate, frames, norm_idx,
        BATCH, log_fn=lambda m: None, batches=j["batches"])
    assert len(per_layer) == 5
    for got, want, mag in zip(per_layer, j["omega"], mags):
        assert mag > 0 and abs(got - want) <= 1e-4 * mag, (got, want, mag)


@pytest.mark.parametrize("route", ["off", "auto"])
def test_fisher_diag_matches_jax(setup, scores, route):
    s, j = setup, scores
    tspec = make_spec("nerv", s["cfg"], hadamard=True).with_bits(BITS)
    _, got = sensitivity_criterion(
        "fisher_diag", "nerv", s["tm"][route], s["sd"], tspec,
        quant_state_from_numpy(_np(j["jstate"])),
        torch.from_numpy(s["frames"]), torch.from_numpy(s["norm_idx"]),
        BATCH, log_fn=lambda m: None, batches=j["batches"])
    for g, w in zip(got, j["fisher"]):
        assert w > 0 and g == pytest.approx(w, rel=1e-5)


class TestWeights:
    def test_state_dict_both_ways(self, setup):
        """The port's conversion equals ``params_to_state_dict`` key for key
        (decoder and head, no encoder); the JAX ``state_dict_to_params``
        takes the port's state dict back to the same leaves."""
        s = setup
        want = params_to_state_dict("nerv", s["params"])
        got = state_dict_from_jax("nerv", _np(s["params"]))
        assert list(got) == list(want)
        assert not any(k.startswith("encoder.") for k in got)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        tm = s["tm"]["auto"]
        back = state_dict_to_params(
            "nerv", {k: v.numpy() for k, v in tm.state_dict().items()},
            s["params"])
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(s["params"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_pth_files_load_in_both_packages(self, setup, tmp_path):
        from neuroquant_tpu.utils.torch_compat import load_pth
        from neuroquant_tpu_torch.methods.common import load_pth as tload

        s = setup
        save_pth(str(tmp_path / "jax.pth"), "nerv", s["params"])
        model = build_model("nerv", s["cfg"], device="cpu")
        model.load_state_dict(torch.load(tmp_path / "jax.pth",
                                         weights_only=True), strict=True)
        other = build_model("nerv", s["cfg"], device="cpu", seed=4)
        port_save_pth(str(tmp_path / "port.pth"), other)
        jp = load_pth(str(tmp_path / "port.pth"), "nerv", s["params"])
        back = state_dict_from_jax("nerv", _np(jp))
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


class TestBunny:
    def test_param_counts_and_run_directory_match_jax(self, monkeypatch):
        """The JAX ``setup_run`` (on parameter shapes) and the port's: the
        same counts and directory, Encoder_0.0M_Decoder_3.08M_Total_3.08M,
        and both set cfg['n_frames'] to the clip's length."""
        from types import SimpleNamespace

        from neuroquant_tpu.methods import common as jcommon
        from neuroquant_tpu_torch.methods import common as tcommon

        monkeypatch.setattr(jcommon, "build_model", lambda arch, cfg:
                            _ShapesOnly(jax_build_model(arch, cfg)))
        run = {}
        for name, common in (("jax", jcommon), ("port", tcommon)):
            args = SimpleNamespace(arch="nerv", outf="o", seed=0,
                                   full_data_length=132)
            cfg = dict(BUNNY)
            if name == "jax":
                common.setup_run(args, cfg, jax.random.PRNGKey(0))
            else:
                common.setup_run(args, cfg, device="cpu")
            assert cfg["n_frames"] == 132
            run[name] = (args.outf, args.encoder_param, args.decoder_param,
                         args.total_param)
        assert run["port"][0] == run["jax"][0] == \
            "o/Encoder_0.0M_Decoder_3.08M_Total_3.08M"
        assert run["port"][1:] == pytest.approx(run["jax"][1:], abs=1e-12)
        model = build_model("nerv", BUNNY, device="cpu")
        assert param_counts("nerv", BUNNY, model, 640 * 1280, 132) == \
            pytest.approx(run["jax"][1:], abs=1e-12)

    @pytest.mark.parametrize("size", ["tiny", "bunny"])
    def test_tail_plan_for_matches_jax(self, tiny_nerv_cfg, size):
        from neuroquant_tpu.models import example_input as jax_example_input
        from neuroquant_tpu.models import tail_plan_for as jax_tail_plan_for

        cfg = BUNNY if size == "bunny" else tiny_nerv_cfg
        (jplan, jf, jch), (tplan, tf_, tch) = (jax_tail_plan_for("nerv", cfg),
                                               tail_plan_for("nerv", cfg))
        assert (tf_, tch) == (jf, jch)
        assert (tplan.h, tplan.w, tplan.pad, tplan.tm, tplan.mp) == (
            jplan.h, jplan.w, jplan.pad, jplan.tm, jplan.mp)
        assert [(L.cin, L.cout, L.side, L.off, L.gelu_in, L.sparse)
                for L in tplan.layers] == [
            (L.cin, L.cout, L.side, L.off, L.gelu_in, L.sparse)
            for L in jplan.layers]
        got = example_input("nerv", cfg, 4, device="cpu")
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_example_input("nerv", cfg, 4)))

    def test_bunny_geometry(self):
        """Bunny-3M resolves the pack start 3, the JAX package's: decoder[0]
        160 -> 145 * 2 * 4 with a (2, 4) shuffle, the fused prefix block
        36 -> 24 * 16 at 40x80, the tail from 160x320 on."""
        from neuroquant_tpu.models.nerv import NeRVConfig
        from neuroquant_tpu.ops.packed_decode import resolve_pack_start

        c = NeRVConfig.from_cfg(BUNNY)
        chans = c.decoder_channels()
        want = resolve_pack_start(c.packed_tail, c.dec_kernels, c.dec_strides,
                                  c.dec_norm, [c.dec_in_channel] + chans[:-1],
                                  chans, c.crop_h, c.crop_w)
        model = build_model("nerv", BUNNY, device="cpu")
        assert model.pack_start == want == 3
        assert model.cfg.decoder_channels() == chans == [72, 36, 24, 24, 24]
        assert (model.cfg.fc_h, model.cfg.fc_w) == (2, 4)
        assert tuple(model.decoder[0].weight.shape) == (1160, 160, 1, 1)
        assert tuple(model.blocks[2].conv[0].weight.shape) == (384, 36, 3, 3)


def test_registry_takes_nerv_and_the_pnerv_archs(tiny_nerv_cfg,
                                                tiny_pnerv_cfg):
    """build_model and the layer list for NeRV and, since they are ported,
    each PNeRV name (any case); an unknown arch raises as in JAX."""
    from neuroquant_tpu.models import quant_layer_paths as jpaths

    assert build_model("NeRV", tiny_nerv_cfg, device="cpu").pack_start == 2
    for arch, cls in (("pnerv", "PNeRV1"), ("pnerv1", "PNeRV1"),
                      ("PNeRV2", "PNeRV2")):
        model = build_model(arch, tiny_pnerv_cfg, device="cpu")
        assert type(model).__name__ == cls and model.tail_packed
        assert (quant_layer_paths(arch, tiny_pnerv_cfg)
                == jpaths(arch.lower(), tiny_pnerv_cfg))
    with pytest.raises(ValueError, match="model arch wrong"):
        build_model("vnerv", tiny_nerv_cfg, device="cpu")
