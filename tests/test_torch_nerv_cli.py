"""NeRV's four stages in the port against the JAX package, on the 80x160
fixture with the tiny NeRV: stage 1's 2-epoch trajectory on the JAX
package's own shuffles and the ``regress`` CLI's checkpoints; the
``calibrate_network`` artifact of both packages (its cfg with ``n_frames``,
no embeddings, the same integer codes and eval blocks); ``compress`` (the
same stream bytes and report); each package's ``eval_quantized`` on the
other's artifact and stream; ``bit_assign`` on both --hvp_impl routes.
The port runs on the CPU (its kernels' plain versions), the JAX package as
its CPU stages run.

Tolerances: trajectory losses rtol 1e-4 and leaves within 2 * lr * steps
(Adam's step is about +-lr whatever the gradient's size); PSNR 1e-3 dB
(0.01 dB for the trajectory's clip, after 8 Adam steps in another order)
and MS-SSIM 1e-5; integer codes and stream bytes exact; per-layer omega
and Fisher scores 1e-3 relative to the candidate's largest layer score."""

import glob
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
from neuroquant_tpu_torch import metrics as tmetrics
from neuroquant_tpu_torch import schedules as tsched
from neuroquant_tpu_torch.methods import common as tcommon
from neuroquant_tpu_torch.methods import regress
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.utils.convert import state_dict_from_jax

SEED = 903
LR_TYPE = "cosine_0.1_1_0.1"
BITS = ["5", "6", "3", "4", "5"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tiny_nerv_cfg, frame_dir, tmp_path_factory):
    """The JAX init's weights as a JAX-written .pth, the config as yaml
    (2 epochs, eval every epoch) and a run directory."""
    from neuroquant_tpu.utils.torch_compat import save_pth

    cfg = dict(tiny_nerv_cfg, n_frames=8)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    norm_idx = np.arange(8, dtype=np.float32) / 8
    jm = jax_build_model("nerv", cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.asarray(norm_idx[:1]))
    d = tmp_path_factory.mktemp("nerv")
    with open(d / "tiny.yaml", "w") as f:
        yaml.safe_dump(dict(tiny_nerv_cfg, epoch=2, eval_freq=1), f)
    save_pth(str(d / "ck.pth"), "nerv", params)
    return dict(cfg=cfg, frames=frames, norm_idx=norm_idx, jm=jm,
                params=params, dir=d)


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


class TestStage1:
    def test_two_epoch_trajectory_on_jax_shuffles(self, setup):
        """Two epochs at batch 2 of the JAX ``make_train_epoch`` against the
        port's, fed the JAX permutations, the model taking the frames'
        indices: per-step losses, the weights, the clip's PSNR."""
        s = setup
        n, epochs, bs, lr = 8, 2, 2, s["cfg"]["learning_rate"]
        spe = n // bs
        train_ind = list(range(n))
        opt = optax.adam(jsched.make_lr_schedule(LR_TYPE, lr, epochs * spe),
                         eps=1e-8)
        run = jregress.make_train_epoch(
            s["jm"], "nerv", "l2", opt, jnp.asarray(s["frames"]),
            jnp.asarray(s["norm_idx"]), spe, bs, train_ind)
        params, ostate = s["params"], opt.init(s["params"])
        rng = jax.random.PRNGKey(SEED)
        jlosses, perms = [], []
        for _ in range(epochs):
            rng, erng = jax.random.split(rng)
            perms.append(np.asarray(jax.random.permutation(
                jax.random.split(erng)[0], jnp.asarray(train_ind))))
            params, ostate, losses, _ = run(params, ostate, erng)
            jlosses += list(np.asarray(losses))
        idx = jnp.asarray(s["norm_idx"])
        jpsnr = np.asarray(jmetrics.psnr_fn_single(
            s["jm"].apply(params, idx), jnp.asarray(s["frames"])))

        tm = build_model("nerv", s["cfg"], device="cpu")
        tm.load_state_dict(state_dict_from_jax("nerv", _np(s["params"])),
                           strict=True)
        topt = torch.optim.Adam(tm.parameters(), lr=lr, eps=1e-8)
        tframes = torch.from_numpy(s["frames"])
        tidx = torch.from_numpy(s["norm_idx"])
        trun = regress.make_train_epoch(
            tm, "l2", topt,
            tsched.make_lr_schedule(LR_TYPE, lr, epochs * spe), tframes,
            tidx, spe, bs)
        losses = []
        for e in range(epochs):
            lo, _ = trun(perms[e], e * spe)
            losses += list(lo.numpy())
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)
        want = state_dict_from_jax("nerv", _np(params))
        for name, v in tm.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr * epochs * spe,
                                       err_msg=name)
        with torch.no_grad():
            psnr = tmetrics.psnr_fn_single(tm(tidx), tframes).numpy()
        np.testing.assert_allclose(psnr, jpsnr, atol=0.01, rtol=0)

    def test_regress_cli(self, setup, frame_dir, monkeypatch):
        """``regress --arch nerv``: the directory of the JAX package's
        naming, checkpoints that both packages load to the trained weights,
        --eval_only reproducing the last eval; the JAX .pth through
        --weight evaluating to the JAX model's PSNR."""
        from neuroquant_tpu.utils.torch_compat import load_pth

        s = setup
        monkeypatch.chdir(s["dir"])
        seen = _recording(monkeypatch, tcommon)
        argv = ["--config", "tiny.yaml", "--arch", "nerv", "--data_path",
                frame_dir, "--vid", "tiny", "--device", "cpu"]
        tm = regress.main(argv + ["--outf", "r1"])
        (d,) = glob.glob(os.path.join("results", "r1", "*", "Encoder_*"))
        assert os.path.basename(d) == "Encoder_0.0M_Decoder_0.14M_Total_0.14M"
        assert tm.cfg.n_frames == 8
        trained = {k: v.numpy() for k, v in tm.state_dict().items()}
        for name in ("model_latest.pth", "epoch2.pth"):
            back = state_dict_from_jax("nerv", _np(load_pth(
                os.path.join(d, name), "nerv", s["params"])))
            assert set(back) == set(trained)
            for k, v in back.items():
                np.testing.assert_array_equal(v.numpy(), trained[k])
        assert len(seen) == 2
        regress.main(argv + ["--outf", "r2", "--eval_only", "--weight",
                             os.path.join(d, "epoch2.pth")])
        assert abs(seen[2][0] - seen[1][0]) <= 1e-3
        regress.main(argv + ["--outf", "r3", "--eval_only", "--weight",
                             "ck.pth"])
        want = float(jmetrics.psnr_fn_single(
            s["jm"].apply(s["params"], jnp.asarray(s["norm_idx"])),
            jnp.asarray(s["frames"])).mean())
        assert abs(seen[3][0] - want) <= 1e-3


def _calibrate(package, frame_dir, outf, *extra):
    argv = ["--config", "tiny.yaml", "--arch", "nerv", "--data_path",
            frame_dir, "--vid", "tiny", "--outf", outf, "--ckpt", "ck.pth",
            "--precision", *BITS, "--channel_wise", "--hadamard",
            "--batch_size", "2", "--data_split", "6_6_8", *extra]
    return package.main(argv)[0]


@pytest.fixture(scope="module")
def artifacts(setup, frame_dir):
    """calibrate_network --arch nerv in each package with nearest rounding
    and no phase-1 epoch (their seeded shuffles differ, the result must
    not), and in the port with AdaRound on the fake-quant kernels' plain
    versions: (artifact paths, each run's eval-block results)."""
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
                              "--fq_impl", "pallas", "--device", "cpu")}
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
        for art in arts.values():
            assert art["arch"] == "nerv" and art["embeddings"] is None
            assert art["cfg"]["n_frames"] == 8
            assert not any(k.startswith("encoder.")
                           for k in art["state_dict"])
        assert arts["port"]["mode"] == arts["jax"]["mode"] == "uaq"
        assert arts["ada"]["mode"] == "adaround"
        j, t = arts["jax"]["int_codes"], arts["port"]["int_codes"]
        assert set(t) == set(j) and len(j) == 5
        for name in j:
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(t[name][leaf]),
                                              np.asarray(j[name][leaf]))
        # the four eval blocks: FP32, quantization off, on unoptimized, on
        assert len(seen["jax"]) == 4
        for got, want in zip(seen["port"][:4], seen["jax"]):
            _same_metrics(got, want)

    @pytest.mark.parametrize("which", ["jax", "port", "ada"])
    def test_streams_and_eval_both_ways(self, artifacts, frame_dir, which,
                                        tmp_path, capsys):
        """Both packages' compress give the same report and stream bytes
        (no content half: NeRV stores no embeddings); each package's
        eval_quantized reads the artifact and its stream to the other's
        metrics. An AdaRound state's stream is lossless."""
        import json

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
        assert got["embed_bits"] == 0 and got["arch"] == "nerv"
        assert {k: v for k, v in got.items() if k != "bitstream"} == \
            {k: v for k, v in want.items() if k != "bitstream"}
        with open(jout, "rb") as f, open(tout, "rb") as g:
            assert f.read() == g.read()
        argv = ["--artifact", art, "--data_path", frame_dir, "--data_split",
                "6_6_8"]
        state = teval.main(argv + ["--device", "cpu"])
        _same_metrics(state, jeval.main(argv))
        stream = teval.main(argv + ["--from_bitstream", tout, "--device",
                                    "cpu"])
        _same_metrics(stream, jeval.main(argv + ["--from_bitstream", tout]))
        if which == "ada":
            _same_metrics(stream, state)


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
    """bit_assign --arch nerv on both --hvp_impl routes against the JAX
    package's default route: the same best candidate, each candidate's
    per-layer scores; the default candidates are NeRV's."""
    from neuroquant_tpu.methods import bit_assign as jba
    from neuroquant_tpu_torch.methods import bit_assign

    monkeypatch.chdir(setup["dir"])
    argv = ["--config", "tiny.yaml", "--arch", "nerv", "--data_path",
            frame_dir, "--vid", "tiny", "--ckpt", "ck.pth", "--batch_size",
            "2", "--channel_wise", "--init", "max", "--mode", mode,
            "--candidates", "5,6,3,4,5;2,2,2,2,2"]
    jseen = _per_layer_recording(monkeypatch, jba)
    want = jba.main(argv + ["--outf", f"bj_{mode}"])
    tseen = _per_layer_recording(monkeypatch, bit_assign)
    for route in ("xla", "pallas"):
        got = bit_assign.main(argv + ["--outf", f"bt_{mode}_{route}",
                                      "--hvp_impl", route, "--device",
                                      "cpu"])
        assert got[:2] == want[:2] == ("candidate1", [5, 6, 3, 4, 5])
    assert len(jseen) == 2 and len(tseen) == 4
    for i, got in enumerate(tseen):
        ref = jseen[i % 2]
        scale = max(abs(v) for v in ref)
        assert scale > 0
        np.testing.assert_allclose(got, ref, atol=1e-3 * scale, rtol=0)
    assert bit_assign.NERV_CANDIDATES == jba.NERV_CANDIDATES
