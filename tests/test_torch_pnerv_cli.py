"""PNeRV's four stages in the port against the JAX package, on the 80x160
fixture with the tiny PNeRV: stage 1's epoch on the JAX package's own
shuffle and the ``regress`` CLI for PNeRV1 and PNeRV2; the
``calibrate_network`` artifacts (the same integer codes and eval blocks as
JAX's, with embeddings; ``--fq_impl pallas`` with ``--adaround_layers``;
PNeRV2); ``compress`` (the same stream bytes and report, a content half);
each package's ``eval_quantized`` on the other's artifact and stream;
``bit_assign`` on both --hvp_impl routes. The port runs on the CPU (its
kernels' plain versions), the JAX package as its CPU stages run. PNeRV's
BatchNorm takes batch statistics, so where a stage draws batches the port
is given the JAX package's (the same batch composition).

Tolerances: the epoch's losses rtol 1e-4 and leaves within 2 * lr * steps;
PSNR 1e-3 dB and MS-SSIM 1e-5; integer codes and stream bytes exact;
per-layer omega and Fisher scores 1e-3 relative to the candidate's largest
layer score."""

import glob
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu import metrics as jmetrics
from neuroquant_tpu import schedules as jsched
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.methods import regress as jregress
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu_torch import schedules as tsched
from neuroquant_tpu_torch.methods import common as tcommon
from neuroquant_tpu_torch.methods import regress
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.quantization import sensitivity as tsens
from neuroquant_tpu_torch.utils.convert import state_dict_from_jax

SEED = 903
LR_TYPE = "cosine_0.1_1_0.1"
N_LAYERS = 11          # the tiny PNeRV1: 1 + 3 + 3 * 2 + 1


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tiny_pnerv_cfg, frame_dir, tmp_path_factory):
    """The JAX init's weights as a JAX-written .pth (PNeRV1 and PNeRV2),
    the config as yaml (1 epoch, eval every epoch) and a run directory."""
    from neuroquant_tpu.utils.torch_compat import save_pth

    cfg = dict(tiny_pnerv_cfg)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    d = tmp_path_factory.mktemp("pnerv")
    out = dict(cfg=cfg, frames=frames, dir=d)
    for arch, name in (("pnerv", "ck.pth"), ("pnerv2", "ck2.pth")):
        jm = jax_build_model(arch, cfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(frames[:1]))
        save_pth(str(d / name), arch, params)
        out[arch] = dict(jm=jm, params=params)
    with open(d / "tiny.yaml", "w") as f:
        yaml.safe_dump(dict(cfg, epoch=1, eval_freq=1), f)
    return out


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(regress, "_summary_writer", lambda log_dir: None)


def _recording(monkeypatch, common):
    """Every ``common.evaluate`` result of a run, in order."""
    seen = []
    orig = common.evaluate

    def evaluate(*a, **k):
        out = orig(*a, **k)
        seen.append([float(np.mean(v)) for v in out[0]])
        return out

    monkeypatch.setattr(common, "evaluate", evaluate)
    return seen


def _same_metrics(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-3 if i % 2 == 0 else 1e-5      # PSNR dB | MS-SSIM
        np.testing.assert_allclose(float(np.mean(g)), float(np.mean(w)),
                                   atol=tol, rtol=0)


def _jax_psnr(jm, params, frames, bs=2):
    """The clip's mean PSNR, decoded in frame-order batches of `bs` (the
    batch statistics of PNeRV's BatchNorm)."""
    out = [np.asarray(jmetrics.psnr_fn_single(
        jm.apply(params, jnp.asarray(frames[i:i + bs])),
        jnp.asarray(frames[i:i + bs]))) for i in range(0, len(frames), bs)]
    return float(np.concatenate(out).mean())


class TestStage1:
    def test_epoch_on_jax_shuffle(self, setup):
        """One epoch at batch 2 of the JAX ``make_train_epoch`` against the
        port's, fed the JAX permutation: per-step losses and the weights."""
        s = setup
        jm, params = s["pnerv"]["jm"], s["pnerv"]["params"]
        n, bs, lr = 8, 2, s["cfg"]["learning_rate"]
        spe = n // bs
        train_ind = list(range(n))
        opt = optax.adam(jsched.make_lr_schedule(LR_TYPE, lr, spe), eps=1e-8)
        run = jregress.make_train_epoch(
            jm, "pnerv", "l2", opt, jnp.asarray(s["frames"]),
            jnp.zeros(n), spe, bs, train_ind)
        erng = jax.random.split(jax.random.PRNGKey(SEED))[1]
        perm = np.asarray(jax.random.permutation(
            jax.random.split(erng)[0], jnp.asarray(train_ind)))
        params, _, jlosses, _ = run(params, opt.init(params), erng)

        tm = build_model("pnerv", s["cfg"], device="cpu")
        tm.load_state_dict(state_dict_from_jax("pnerv", _np(
            s["pnerv"]["params"])), strict=True)
        topt = torch.optim.Adam(tm.parameters(), lr=lr, eps=1e-8)
        trun = regress.make_train_epoch(
            tm, "l2", topt, tsched.make_lr_schedule(LR_TYPE, lr, spe),
            torch.from_numpy(s["frames"]), torch.zeros(n), spe, bs)
        losses, _ = trun(perm, 0)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                                   rtol=1e-4, atol=0)
        want = state_dict_from_jax("pnerv", _np(params))
        for name, v in tm.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr * spe, err_msg=name)

    @pytest.mark.parametrize("arch,ck", [("pnerv1", "ck.pth"),
                                         ("pnerv2", "ck2.pth")])
    def test_regress_cli(self, setup, frame_dir, monkeypatch, arch, ck):
        """``regress --arch pnerv1`` and ``pnerv2``: the JAX package's run
        directory, checkpoints that the JAX package loads to the trained
        weights; the JAX .pth through --eval_only --weight evaluating to
        the JAX model's PSNR."""
        from neuroquant_tpu.utils.torch_compat import load_pth

        s = setup
        jarch = "pnerv" if arch == "pnerv1" else arch
        monkeypatch.chdir(s["dir"])
        seen = _recording(monkeypatch, tcommon)
        argv = ["--config", "tiny.yaml", "--arch", arch, "--data_path",
                frame_dir, "--vid", "tiny", "--device", "cpu"]
        tm = regress.main(argv + ["--outf", f"r_{arch}"])
        (d,) = glob.glob(os.path.join("results", f"r_{arch}", "*",
                                      "Encoder_*"))
        assert os.path.basename(d) == {
            "pnerv1": "Encoder_0.01M_Decoder_0.03M_Total_0.03M",
            "pnerv2": "Encoder_0.01M_Decoder_0.02M_Total_0.02M"}[arch]
        trained = {k: v.numpy() for k, v in tm.state_dict().items()}
        back = state_dict_from_jax(jarch, _np(load_pth(
            os.path.join(d, "epoch1.pth"), jarch, s[jarch]["params"])))
        assert set(back) == set(trained)
        for k, v in back.items():
            np.testing.assert_array_equal(v.numpy(), trained[k])
        assert len(seen) == 1 and np.isfinite(seen[0][0])
        regress.main(argv + ["--outf", f"e_{arch}", "--eval_only",
                             "--weight", ck])
        want = _jax_psnr(s[jarch]["jm"], s[jarch]["params"], s["frames"])
        assert abs(seen[1][0] - want) <= 1e-3


def _calibrate(package, frame_dir, outf, *extra, arch="pnerv",
               ck="ck.pth", n=N_LAYERS):
    argv = ["--config", "tiny.yaml", "--arch", arch, "--data_path",
            frame_dir, "--vid", "tiny", "--outf", outf, "--ckpt", ck,
            "--precision", *(["5"] * n), "--channel_wise", "--hadamard",
            "--batch_size", "2", "--data_split", "6_6_8", *extra]
    return package.main(argv)[0]


@pytest.fixture(scope="module")
def artifacts(setup, frame_dir):
    """calibrate_network --arch pnerv in each package with nearest rounding
    and no phase-1 epoch (their seeded shuffles differ, the result must
    not); in the port with AdaRound on layers 0, 4 and 10 only, on the
    fake-quant kernels' plain versions, and PNeRV2 with AdaRound:
    (artifact paths, each run's eval-block results)."""
    from neuroquant_tpu.methods import calibrate_network as jcal
    from neuroquant_tpu.methods import common as jcommon
    from neuroquant_tpu_torch.methods import calibrate_network as tcal

    mp = pytest.MonkeyPatch()
    mp.chdir(setup["dir"])
    try:
        seen = {"jax": _recording(mp, jcommon),
                "port": _recording(mp, tcommon)}
        paths = {
            "jax": _calibrate(jcal, frame_dir, "cj", "--iters_w", "8",
                              "--rounding", "nearest"),
            "port": _calibrate(tcal, frame_dir, "cp", "--iters_w", "8",
                               "--rounding", "nearest", "--device", "cpu"),
            "ada": _calibrate(tcal, frame_dir, "ca", "--iters_w", "12",
                              "--fq_impl", "pallas", "--adaround_layers",
                              "0", "4", "10", "--device", "cpu"),
            "pnerv2": _calibrate(tcal, frame_dir, "c2", "--iters_w", "8",
                                 "--device", "cpu", arch="pnerv2",
                                 ck="ck2.pth", n=9)}
        return {k: str(setup["dir"] / v) for k, v in paths.items()}, seen
    finally:
        mp.undo()


class TestStage3And4:
    def test_artifacts_match_jax(self, artifacts):
        paths, seen = artifacts
        arts = {}
        for k, p in paths.items():
            with open(p, "rb") as f:
                arts[k] = pickle.load(f)
        for k, art in arts.items():
            assert art["arch"] == ("pnerv2" if k == "pnerv2" else "pnerv")
            assert art["embeddings"].shape == (8, 1, 2, 8)
            assert any(k.startswith("dec_shortcuts.") for k in
                       art["state_dict"]) == (k != "pnerv2")
        np.testing.assert_allclose(arts["port"]["embeddings"],
                                   arts["jax"]["embeddings"], atol=1e-5,
                                   rtol=0)
        assert arts["port"]["mode"] == arts["jax"]["mode"] == "uaq"
        assert arts["ada"]["mode"] == arts["pnerv2"]["mode"] == "adaround"
        alphas = [n for n, s in arts["ada"]["quant_state"].items()
                  if "w_alpha" in s]
        names = list(arts["ada"]["quant_state"])
        assert alphas == [names[0], names[4], names[10]] == [
            "dec_exc/conv", "bsm_z_0", "head_layer"]
        j, t = arts["jax"]["int_codes"], arts["port"]["int_codes"]
        assert set(t) == set(j) and len(j) == N_LAYERS
        assert len(arts["pnerv2"]["int_codes"]) == 9
        for name in j:
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(t[name][leaf]),
                                              np.asarray(j[name][leaf]))
        # the four eval blocks: FP32, quantization off, on unoptimized, on
        assert len(seen["jax"]) == 4
        for got, want in zip(seen["port"][:4], seen["jax"]):
            _same_metrics(got, want)

    @pytest.mark.parametrize("which", ["jax", "ada", "pnerv2"])
    def test_streams_and_eval_both_ways(self, artifacts, frame_dir, which,
                                        tmp_path, capsys):
        """Both packages' compress give the same report and stream bytes,
        with the embeddings' content half; each package's eval_quantized
        reads the artifact and its stream to the other's metrics."""
        from neuroquant_tpu.methods import compress as jcompress
        from neuroquant_tpu.methods import eval_quantized as jeval
        from neuroquant_tpu_torch.methods import compress as tcompress
        from neuroquant_tpu_torch.methods import eval_quantized as teval

        art = artifacts[0][which]
        jout, tout = str(tmp_path / "jax.nqtb"), str(tmp_path / "port.nqtb")
        argv = ["--artifact", art, "--data_path", frame_dir]
        want = jcompress.main(argv + ["--out", jout])
        got = tcompress.main(argv + ["--out", tout])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
            == got
        assert got["embed_bits"] > 0
        assert {k: v for k, v in got.items() if k != "bitstream"} == \
            {k: v for k, v in want.items() if k != "bitstream"}
        with open(jout, "rb") as f, open(tout, "rb") as g:
            assert f.read() == g.read()
        argv = ["--artifact", art, "--data_path", frame_dir, "--data_split",
                "6_6_8"]
        stream = teval.main(argv + ["--from_bitstream", tout, "--device",
                                    "cpu"])
        _same_metrics(stream, jeval.main(argv + ["--from_bitstream", tout]))
        if which != "jax":
            # an AdaRound state's stream is lossless
            _same_metrics(stream, teval.main(argv + ["--device", "cpu"]))


def _per_layer_recording(monkeypatch, module):
    """Each candidate's per-layer scores of a bit_assign run."""
    seen = []
    orig = module.sensitivity_criterion

    def criterion(*a, **k):
        total, per_layer = orig(*a, **k)
        seen.append(per_layer)
        return total, per_layer

    monkeypatch.setattr(module, "sensitivity_criterion", criterion)
    return seen


@pytest.mark.parametrize("mode", ["omega", "fisher_diag"])
def test_bit_assign_matches_jax(setup, frame_dir, monkeypatch, mode):
    """bit_assign --arch pnerv on both --hvp_impl routes against the JAX
    package's default route, on the JAX package's batches: the same best
    candidate, each candidate's per-layer scores; without --candidates
    both raise (PNeRV has no default candidates)."""
    from neuroquant_tpu.methods import bit_assign as jba
    from neuroquant_tpu_torch.methods import bit_assign

    monkeypatch.chdir(setup["dir"])
    perm = np.array(jax.random.permutation(jax.random.PRNGKey(SEED), 8))
    monkeypatch.setattr(tsens, "draw_batches", lambda n, bs, seed:
                        torch.from_numpy(perm[:n // bs * bs].reshape(-1, bs)))
    lo, hi = ",".join(["3"] * N_LAYERS), ",".join(["6"] * N_LAYERS)
    argv = ["--config", "tiny.yaml", "--arch", "pnerv", "--data_path",
            frame_dir, "--vid", "tiny", "--ckpt", "ck.pth", "--batch_size",
            "2", "--channel_wise", "--init", "max", "--mode", mode]
    jseen = _per_layer_recording(monkeypatch, jba)
    want = jba.main(argv + ["--outf", f"bj_{mode}", "--candidates",
                            f"{lo};{hi}"])
    tseen = _per_layer_recording(monkeypatch, bit_assign)
    for route in ("xla", "pallas"):
        got = bit_assign.main(argv + ["--outf", f"bt_{mode}_{route}",
                                      "--hvp_impl", route, "--candidates",
                                      f"{lo};{hi}", "--device", "cpu"])
        assert got[:2] == want[:2] == ("candidate2", [6] * N_LAYERS)
    assert len(jseen) == 2 and len(tseen) == 4
    for i, got in enumerate(tseen):
        ref = jseen[i % 2]
        scale = max(abs(v) for v in ref)
        assert scale > 0 and len(got) == N_LAYERS
        np.testing.assert_allclose(got, ref, atol=1e-3 * scale, rtol=0)
    if mode == "omega":
        for pkg, extra in ((jba, []), (bit_assign, ["--device", "cpu"])):
            with pytest.raises(ValueError, match="no default candidates"):
                pkg.main(argv + ["--outf", "bn"] + extra)
