"""Stage 1 (``regress``) in the port against the JAX package, on the 80x160
fixture with the tiny HNeRV: one training step from the JAX init and a
2-epoch trajectory on the JAX package's own shuffles, at batch 1 and 2;
the lr schedules; the 16 training losses; the QAT quantizers; the video
set's sample API; the CLI's checkpoints read by both packages, --weight,
--eval_only, --dump_vis (and calibrate_network's), --profile, and the
flags that are not ported. The port runs on the CPU (its kernels' plain
versions), the JAX package as its stage 1 runs on the CPU (the XLA packed
tail, jitted).

Tolerances: a step's loss 1e-5 relative and its gradients 1e-4 of each
leaf's largest |grad| (fp32 sums in another order); trajectory losses rtol
1e-4 and leaves within 2 * lr * steps (Adam's step is about +-lr whatever
the gradient's size, so a tiny difference in a near-zero gradient can flip
its sign); PSNR 0.01 dB; schedules 1e-7 relative (against the JAX
schedule in float64); losses and their
gradients 1e-5 (of the largest gradient; 1e-4 for the MS-SSIM losses'
gradients, the fp32 rounding of MS-SSIM itself); the QAT quantizers
1e-6."""

import glob
import os

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
from neuroquant_tpu.ops import quant as jquant
from neuroquant_tpu_torch import metrics as tmetrics
from neuroquant_tpu_torch import schedules as tsched
from neuroquant_tpu_torch.data import VideoDataSet
from neuroquant_tpu_torch.methods import common as tcommon
from neuroquant_tpu_torch.methods import regress
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.ops import quant as tquant
from neuroquant_tpu_torch.utils.convert import state_dict_from_jax

SEED = 903
LR_TYPE = "cosine_0.1_1_0.1"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tiny_hnerv_cfg, frame_dir):
    cfg = dict(tiny_hnerv_cfg)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    jm = jax_build_model("hnerv", cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(frames[:1]))
    return dict(cfg=cfg, frames=frames, jm=jm, params=params,
                apply=jax.jit(jm.apply),
                sd=state_dict_from_jax("hnerv", _np(params)))


def _port_model(s):
    tm = build_model("hnerv", s["cfg"], device="cpu")
    tm.load_state_dict(s["sd"], strict=True)
    return tm


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The CLI's optional TensorBoard writer: importing TensorBoard takes
    ~15 s where TensorFlow is installed."""
    monkeypatch.setattr(regress, "_summary_writer", lambda log_dir: None)


class TestTrainingStep:
    @pytest.mark.parametrize("batch", [[5], [5, 2]], ids=["b1", "b2"])
    def test_one_step_matches_jax(self, setup, batch):
        """Loss and the gradient of every leaf, encoder included, of one
        step from the JAX init: HNeRV's forward (the port's fused tail and
        its backward) and the l2 loss."""
        s = setup
        idx = np.array(batch)
        img = jnp.asarray(s["frames"][idx])

        @jax.jit
        def jstep(p):
            return jax.value_and_grad(lambda q: jmetrics.loss_fn(
                s["jm"].apply(q, img), img, "l2"))(p)

        jloss, jgrads = jstep(s["params"])
        tm = _port_model(s)
        timg = torch.from_numpy(s["frames"][idx])
        loss = tmetrics.loss_fn(tm(timg), timg, "l2")
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
        want = state_dict_from_jax("hnerv", _np(jgrads))
        names = [n for n, _ in tm.named_parameters()]
        assert set(names) == set(want)
        assert any(n.startswith("encoder.") for n in names)
        for name, prm in tm.named_parameters():
            _close(prm.grad.numpy(), want[name].numpy(), 1e-4)

    @pytest.mark.parametrize("bs", [1, 2])
    def test_two_epoch_trajectory_on_jax_shuffles(self, setup, bs):
        """Two epochs of the JAX ``make_train_epoch`` (optax Adam, the
        cosine schedule) against the port's, fed the JAX permutations:
        per-step losses, the weights after them and the clip's PSNR."""
        s = setup
        n, epochs, lr = len(s["frames"]), 2, s["cfg"]["learning_rate"]
        spe = n // bs
        train_ind = list(range(n))
        frames = jnp.asarray(s["frames"])
        norm_idx = jnp.arange(n, dtype=jnp.float32) / n
        opt = optax.adam(jsched.make_lr_schedule(LR_TYPE, lr, epochs * spe),
                         eps=1e-8)
        run = jregress.make_train_epoch(s["jm"], "hnerv", "l2", opt, frames,
                                        norm_idx, spe, bs, train_ind)
        params, ostate = s["params"], opt.init(s["params"])
        rng = jax.random.PRNGKey(SEED)
        jlosses, perms = [], []
        for _ in range(epochs):
            rng, erng = jax.random.split(rng)
            perms.append(np.asarray(jax.random.permutation(
                jax.random.split(erng)[0], jnp.asarray(train_ind))))
            params, ostate, losses, _ = run(params, ostate, erng)
            jlosses += list(np.asarray(losses))
        jpsnr = np.asarray(jmetrics.psnr_fn_single(s["apply"](params, frames),
                                                   frames))

        tm = _port_model(s)
        topt = torch.optim.Adam(tm.parameters(), lr=lr, eps=1e-8)
        tframes = torch.from_numpy(s["frames"])
        trun = regress.make_train_epoch(
            tm, "l2", topt,
            tsched.make_lr_schedule(LR_TYPE, lr, epochs * spe), tframes,
            torch.arange(n, dtype=torch.float32) / n, spe, bs)
        losses = []
        for e in range(epochs):
            lo, _ = trun(perms[e], e * spe)
            losses += list(lo.numpy())
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)
        want = state_dict_from_jax("hnerv", _np(params))
        for name, v in tm.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr * epochs * spe,
                                       err_msg=name)
        with torch.no_grad():
            psnr = tmetrics.psnr_fn_single(tm(tframes), tframes).numpy()
        np.testing.assert_allclose(psnr, jpsnr, atol=0.01, rtol=0)


class TestSchedules:
    @pytest.mark.parametrize("lr_type", [
        "cosine_0.1_1_0.1", "cosine_0.2_2_0.05", "cosine_0.0001_1_0.1",
        "hybrid_0.1_1_2_0.1_0.01", "hybrid_0.3_0.5_1_0.2_0.05"])
    def test_schedule_matches_jax(self, lr_type):
        """50 steps: to 1e-7 relative against the JAX schedule evaluated in
        float64; against it as the JAX package runs it, in float32, within
        2^-21 of the base lr: four float32 ulps of a multiplier of order 1,
        the rounding of its few float32 operations (1.1e-7 relative at the
        peak, more where 0.5 * (cos + 1) cancels)."""
        total, base = 600, 0.002
        jsch = jsched.make_lr_schedule(lr_type, base, total)
        tsch = tsched.make_lr_schedule(lr_type, base, total)
        steps = np.linspace(0, total - 1, 50).astype(int)
        got = [tsch(int(k)) for k in steps]
        assert all(isinstance(g, float) for g in got)
        with jax.enable_x64(True):
            want64 = [float(jsch(jnp.asarray(k, jnp.int64))) for k in steps]
        np.testing.assert_allclose(got, want64, rtol=1e-7, atol=0)
        want32 = [float(jsch(jnp.asarray(k, jnp.int32))) for k in steps]
        np.testing.assert_allclose(got, want32, rtol=0, atol=base * 2 ** -21)

    def test_unknown_kind_raises(self):
        with pytest.raises(NotImplementedError, match="step_1"):
            tsched.lr_multiplier("step_1", 0.5)


LOSSES = ["l2", "l1", "ssim"] + [f"Fusion{i}" for i in range(1, 13)]


def _pair(shape, seed):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0.1, 0.9, shape).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    return pred, gt


class TestLosses:
    @pytest.mark.parametrize("loss_type", LOSSES)
    def test_loss_and_gradient_match_jax(self, loss_type):
        """Each training loss and its gradient in pred; the MS-SSIM losses
        (Fusion10-12) on 176x176, over the 5-level pyramid's minimum side.
        Their gradients to 1e-4 of the largest: MS-SSIM's gradient in fp32
        is itself that far from its float64 value (the JAX package's 5.8e-5
        of the largest, the port's 3.2e-5, on such a pair: E[x^2] - E[x]^2
        cancels and the five levels' powers multiply), and the JAX function
        cannot run in float64 to compare the formulas without it."""
        msssim = loss_type in ("Fusion10", "Fusion11", "Fusion12")
        side = (176, 176) if msssim else (24, 40)
        pred, gt = _pair((2, *side, 3), LOSSES.index(loss_type))
        jval, jgrad = jax.value_and_grad(
            lambda p: jmetrics.loss_fn(p, jnp.asarray(gt), loss_type))(
                jnp.asarray(pred))
        p = torch.from_numpy(pred).requires_grad_()
        t = torch.from_numpy(gt).requires_grad_()
        val = tmetrics.loss_fn(p, t, loss_type)
        val.backward()
        assert t.grad is None                   # the target is detached
        assert float(val.detach()) == pytest.approx(float(jval), rel=1e-5,
                                                    abs=1e-6)
        _close(p.grad.numpy(), jgrad, 1e-4 if msssim else 1e-5)
        per = tmetrics.loss_fn(p, t, loss_type, batch_average=False)
        assert per.shape == (2,)

    def test_unknown_loss_raises(self):
        x = torch.zeros((1, 16, 16, 3))
        with pytest.raises(KeyError):
            tmetrics.loss_fn(x, x, "Fusion13")

    def test_metric_helpers_match_jax(self):
        small, _ = _pair((2, 24, 40, 3), 1)
        big, gt = _pair((2, 176, 176, 3), 2)
        outs = [big, np.clip(big + 0.05, 0, 1)]
        j, t = jnp.asarray, torch.from_numpy
        pairs = [
            (jmetrics.psnr_fn_batch([j(o) for o in outs], j(gt)),
             tmetrics.psnr_fn_batch([t(o) for o in outs], t(gt)), 1e-4),
            (jmetrics.msssim_fn_batch([j(o) for o in outs], j(gt)),
             tmetrics.msssim_fn_batch([t(o) for o in outs], t(gt)), 1e-5),
            (jmetrics.psnr_fn([j(big), j(small)], [j(gt), j(small * 0.9)]),
             tmetrics.psnr_fn([t(big), t(small)], [t(gt), t(small * 0.9)]),
             1e-4),
            (jmetrics.msssim_fn([j(small), j(big)], [j(small), j(gt)]),
             tmetrics.msssim_fn([t(small), t(big)], [t(small), t(gt)]),
             1e-5),
            (jmetrics.psnr2(j(big), j(gt)), tmetrics.psnr2(t(big), t(gt)),
             1e-4),
            (jmetrics.rgb_to_ycbcr(j(big)), tmetrics.rgb_to_ycbcr(t(big)),
             1e-6),
            (jmetrics.ycbcr_to_rgb(j(big)), tmetrics.ycbcr_to_rgb(t(big)),
             1e-6),
        ]
        for want, got, tol in pairs:
            assert tuple(got.shape) == tuple(want.shape)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=tol, rtol=0)


class TestQAT:
    def _weight(self, seed=0):
        return np.random.RandomState(seed).randn(3, 3, 6, 10).astype(
            np.float32) * 0.3

    @pytest.mark.parametrize("bits", [4, 8])
    def test_ffnerv_matches_jax(self, bits):
        w = self._weight()
        g = np.random.RandomState(1).randn(*w.shape).astype(np.float32)
        jval, jgrad = jax.value_and_grad(lambda x: (jquant.qat_fake_quant(
            x, bits, "ffnerv") * g).sum())(jnp.asarray(w))
        x = torch.from_numpy(w).requires_grad_()
        out = tquant.qat_fake_quant(x, bits, "ffnerv")
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(
            out.detach().numpy(),
            np.asarray(jquant.qat_fake_quant(jnp.asarray(w), bits, "ffnerv")),
            atol=1e-6, rtol=0)
        _close(x.grad.numpy(), jgrad, 1e-6)

    @pytest.mark.parametrize("training", [False, True],
                             ids=["eval", "train_jax_mask"])
    def test_hinerv_matches_jax(self, training, monkeypatch):
        """Eval mode, and training with the JAX draw's mask injected in
        place of the port's generator's."""
        w = self._weight(2)
        g = np.random.RandomState(3).randn(*w.shape).astype(np.float32)
        rng = jax.random.PRNGKey(7)

        def jf(x):
            return jquant.qat_fake_quant(x, 6, "hinerv", rng=rng,
                                         training=training)

        jout = np.asarray(jf(jnp.asarray(w)))
        jgrad = jax.grad(lambda x: (jf(x) * g).sum())(jnp.asarray(w))
        if training:
            mask = np.asarray(jax.random.uniform(rng, w.shape) > 0.9,
                              np.float32)
            assert 0 < mask.sum() < mask.size
            monkeypatch.setattr(tquant, "qat_mask",
                                lambda shape, generator=None, device=None:
                                torch.from_numpy(mask))
        x = torch.from_numpy(w).requires_grad_()
        out = tquant.qat_fake_quant(x, 6, "hinerv", training=training)
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-6,
                                   rtol=0)
        _close(x.grad.numpy(), jgrad, 1e-6)

    def test_port_mask_and_bad_mode(self):
        gen = torch.Generator().manual_seed(0)
        m = tquant.qat_mask((4000,), gen)
        assert set(np.unique(m.numpy())) == {0.0, 1.0}
        assert 0.07 < float(m.mean()) < 0.13
        with pytest.raises(ValueError, match="rounding mode"):
            tquant.qat_fake_quant(torch.zeros(3), 4, "lsq")


class TestVideoSet:
    @pytest.mark.parametrize("diff", [False, True])
    def test_samples_match_jax(self, tiny_hnerv_cfg, frame_dir, diff):
        cfg = dict(tiny_hnerv_cfg, diff_enc=diff)
        jds = JaxVideoDataSet(cfg, frame_dir)
        tds = VideoDataSet(cfg, frame_dir, device="cpu")
        np.testing.assert_array_equal(tds.norm_idx.numpy(),
                                      np.asarray(jds.norm_idx))
        for i in (0, 3, len(jds) - 1):
            want, got = jds[i], tds[i]
            assert set(got) == set(want)
            for k in want:
                if hasattr(want[k], "shape"):
                    np.testing.assert_array_equal(got[k].numpy(),
                                                  np.asarray(want[k]))
                else:
                    assert got[k] == want[k], k

    @pytest.mark.parametrize("drop_last", [False, True])
    def test_batches_match_jax(self, tiny_hnerv_cfg, frame_dir, drop_last):
        jds = JaxVideoDataSet(tiny_hnerv_cfg, frame_dir)
        tds = VideoDataSet(tiny_hnerv_cfg, frame_dir, device="cpu")
        order = [5, 1, 7, 2, 0]
        want = list(jds.batches(2, order, drop_last))
        got = list(tds.batches(2, order, drop_last))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _regress(cfg_path, frame_dir, outf, *extra):
    return regress.main(["--config", cfg_path, "--arch", "hnerv",
                         "--data_path", frame_dir, "--vid", "tiny", "--outf",
                         outf, "--device", "cpu", *extra])


def _run_dir(outf):
    return glob.glob(os.path.join("results", outf, "*", "Encoder_*"))[0]


def _log_text(run_dir):
    with open(glob.glob(os.path.join(run_dir, "*.log"))[0]) as f:
        return f.read()


def _recording(monkeypatch):
    """Every ``common.evaluate`` result of the run, in order."""
    seen = []
    orig = tcommon.evaluate

    def evaluate(*a, **k):
        out = orig(*a, **k)
        seen.append(out[0])
        return out

    monkeypatch.setattr(tcommon, "evaluate", evaluate)
    return seen


@pytest.fixture(scope="module")
def run_dir(setup, tmp_path_factory):
    """The config as yaml and a JAX-written .pth of the JAX init."""
    from neuroquant_tpu.utils.torch_compat import save_pth

    d = tmp_path_factory.mktemp("stage1")
    for name, epochs in (("tiny.yaml", 2), ("tiny1.yaml", 1)):
        with open(d / name, "w") as f:
            yaml.safe_dump(dict(setup["cfg"], epoch=epochs, eval_freq=1), f)
    save_pth(str(d / "jax_init.pth"), "hnerv", setup["params"])
    return d


class TestCLI:
    def test_checkpoints_read_by_both_packages(self, setup, run_dir,
                                               frame_dir, monkeypatch):
        """Two epochs at batch 2 with --snapshot_freq 1, --profile and the
        hybrid schedule: model_latest.pth, epoch1.pth and epoch2.pth, which
        the JAX ``load_pth`` and the port's read to the trained weights;
        the log lines; epoch 2's profiler trace; the last eval's PSNR
        reproduced by --eval_only --weight epoch2.pth."""
        from neuroquant_tpu.utils.torch_compat import load_pth

        monkeypatch.chdir(run_dir)
        seen = _recording(monkeypatch)
        tm = _regress("tiny.yaml", frame_dir, "t1", "--snapshot_freq", "1",
                      "--profile", "--lr_type", "hybrid_0.1_1_2_0.1_0.01")
        d = _run_dir("t1")
        assert len(glob.glob(os.path.join(d, "profile", "trace_*.json"))) \
            == 1
        assert os.path.basename(d) == "Encoder_0.01M_Decoder_0.1M_Total_0.1M"
        for name in ("model_latest.pth", "epoch1.pth", "epoch2.pth"):
            assert os.path.exists(os.path.join(d, name)), name
        trained = {k: v.numpy() for k, v in tm.state_dict().items()}
        for name in ("model_latest.pth", "epoch2.pth"):
            jp = load_pth(os.path.join(d, name), "hnerv", setup["params"])
            back = state_dict_from_jax("hnerv", _np(jp))
            assert set(back) == set(trained)
            for k, v in back.items():
                np.testing.assert_array_equal(v.numpy(), trained[k])
            fresh = build_model("hnerv", setup["cfg"], device="cpu", seed=5)
            tcommon.load_pth(os.path.join(d, name), fresh)
            for k, v in fresh.state_dict().items():
                np.testing.assert_array_equal(v.numpy(), trained[k])
        log = _log_text(d)
        for line in ("Epoch[2/2], Step [4/4], lr:", "pred_PSNR:",
                     "Time/epoch:", "Eval at epoch 1 for (80, 160)",
                     "Eval at epoch 2 for (80, 160)", "Training complete"):
            assert line in log, line
        assert len(seen) == 2
        _regress("tiny.yaml", frame_dir, "t1e", "--eval_only", "--weight",
                 os.path.join(d, "epoch2.pth"))
        assert len(seen) == 3
        assert abs(float(seen[2][0]) - float(seen[1][0])) <= 1e-3

    def test_jax_checkpoint_through_weight(self, setup, run_dir, frame_dir,
                                           monkeypatch):
        """A JAX-written .pth through --weight --eval_only --eval_fps: the
        PSNR of the JAX model on those weights, within 0.01 dB."""
        monkeypatch.chdir(run_dir)
        seen = _recording(monkeypatch)
        _regress("tiny.yaml", frame_dir, "t2", "--eval_only", "--eval_fps",
                 "--weight", "jax_init.pth")
        frames = jnp.asarray(setup["frames"])
        want = float(jmetrics.psnr_fn_single(
            setup["apply"](setup["params"], frames), frames).mean())
        assert abs(float(seen[0][0]) - want) <= 0.01
        log = _log_text(_run_dir("t2"))
        assert "[eval_fps] cpu decode throughput:" in log

    def test_dump_vis(self, setup, run_dir, frame_dir, monkeypatch):
        """--eval_only --dump_vis writes pred_<id>_<PSNR>.png per frame:
        the clipped decode as uint8, the PSNR in the name."""
        from PIL import Image

        monkeypatch.chdir(run_dir)
        _regress("tiny.yaml", frame_dir, "t3", "--eval_only", "--dump_vis",
                 "--weight", "jax_init.pth")
        pngs = sorted(glob.glob(os.path.join(_run_dir("t3"),
                                             "visualize_fp32", "*.png")))
        assert len(pngs) == 8
        tm = _port_model(setup)
        frames = torch.from_numpy(setup["frames"])
        with torch.no_grad():
            out = tm(frames)
            psnr = tmetrics.psnr_fn_single(out, frames).numpy()
        want = (torch.clamp(out, 0, 1) * 255).to(torch.uint8).numpy()
        for i, path in enumerate(pngs):
            assert os.path.basename(path) == \
                f"pred_{i:04d}_{round(float(psnr[i]), 2)}.png"
            np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                          want[i])

    def test_calibrate_network_dump_vis(self, setup, run_dir, frame_dir,
                                        monkeypatch):
        """calibrate_network --dump_vis writes the full-precision and the
        calibrated decodes' frames under visualize_calib_network."""
        from neuroquant_tpu_torch.methods import calibrate_network

        monkeypatch.chdir(run_dir)
        out_path, _, _ = calibrate_network.main([
            "--config", "tiny.yaml", "--arch", "hnerv", "--data_path",
            frame_dir, "--vid", "tiny", "--outf", "t4", "--ckpt",
            "jax_init.pth", "--precision", "6", "6", "6", "6", "6",
            "--channel_wise", "--batch_size", "2", "--iters_w", "8",
            "--rounding", "nearest", "--dump_vis", "--device", "cpu"])
        d = os.path.join(os.path.dirname(out_path), "visualize_calib_network")
        pngs = sorted(os.listdir(d))
        # the two blocks write the same 8 names, PSNR apart
        assert len({p[:9] for p in pngs}) == 8
        assert all(p.startswith("pred_") and p.endswith(".png") for p in pngs)

    @pytest.mark.parametrize("mode", ["ffnerv", "hinerv"])
    def test_qat_trains(self, run_dir, frame_dir, monkeypatch, mode):
        """--qat_mode: the decoder's weights trained through the QAT
        quantizer, every loss finite."""
        monkeypatch.chdir(run_dir)
        losses = []
        orig = regress.loss_fn

        def recording(*a, **k):
            out = orig(*a, **k)
            losses.append(float(out.detach()))
            return out

        monkeypatch.setattr(regress, "loss_fn", recording)
        _regress("tiny1.yaml", frame_dir, f"q_{mode}", "--qat_mode", mode,
                 "--qat_bits", "6")
        assert len(losses) == 4 and np.isfinite(losses).all()
        log = _log_text(_run_dir(f"q_{mode}"))
        assert f"QAT enabled: mode={mode} bits=6" in log

    @pytest.mark.parametrize("flag,item", [
        (["--mesh_devices", "2"], "item 14"),
        (["--matmul_precision", "bfloat16"], "item 16")])
    def test_unported_flags_name_their_item(self, flag, item):
        if item == "item 14":
            # ported: the flag parses (tests/test_torch_dp.py runs the CLI
            # with it)
            assert regress.parse_args(
                ["--config", "c.yaml", "--arch", "hnerv", "--device",
                 "cpu"] + flag).mesh_devices == 2
            return
        # item 16, ported: the flag parses (tests/test_torch_bf16_cli.py
        # runs the CLI with it) and 'default' stays the default
        assert regress.parse_args(
            ["--config", "c.yaml", "--arch", "hnerv", "--device", "cpu"]
            + flag).matmul_precision == "bfloat16"
        assert regress.parse_args(
            ["--config", "c.yaml", "--arch", "hnerv"]).matmul_precision \
            == "default"


def test_summarize_trace_groups_device_time(tmp_path):
    """Device events summed by kernel name, largest first; host events and
    older traces ignored."""
    import json
    import time

    from neuroquant_tpu_torch.utils.profiling import summarize_trace

    assert summarize_trace(str(tmp_path)) == []
    old = {"traceEvents": [{"ph": "X", "cat": "kernel", "name": "old",
                            "dur": 9e6}]}
    with open(tmp_path / "trace_1.json", "w") as f:
        json.dump(old, f)
    time.sleep(0.01)
    ev = [("kernel", "nq_tail_conv", 1500.0), ("kernel", "nq_tail_conv", 500),
          ("gpu_memcpy", "Memcpy HtoD", 250), ("cpu_op", "aten::add", 9000),
          ("kernel", "elementwise", 1000)]
    new = {"traceEvents": [{"ph": "X", "cat": c, "name": n, "dur": d}
                           for c, n, d in ev]}
    with open(tmp_path / "trace_2.json", "w") as f:
        json.dump(new, f)
    assert summarize_trace(str(tmp_path), top_k=2) == [
        (2.0, "nq_tail_conv"), (1.0, "elementwise")]


def test_device_rows_leave_out_annotated_ranges():
    """A profile's rows of device time: kernels and copies with their
    launches; the optimizer's annotated range (a span over kernels already
    counted), host ops and rows without device time left out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from neuroquant_tpu_torch.utils.profiling import device_rows

    def ev(key, us, count=1, dev=DeviceType.CUDA, annotation=False):
        return SimpleNamespace(key=key, self_device_time_total=us,
                               count=count, device_type=dev,
                               is_user_annotation=annotation)

    events = [ev("tail_conv_cf_kernel", 900.0, 8),
              ev("Optimizer.step#Adam.step", 1700.0, annotation=True),
              ev("aten::add", 40.0, dev=DeviceType.CPU),
              ev("Memcpy HtoD", 3.0), ev("idle", 0.0)]
    assert device_rows(events) == [(900.0, 8, "tail_conv_cf_kernel"),
                                   (3.0, 1, "Memcpy HtoD")]


def test_matmul_precision_switches_tf32_and_restores():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with regress.matmul_precision("tensorfloat32", "cuda"):
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before
    with regress.matmul_precision("tensorfloat32", "cpu"):
        assert torch.backends.cuda.matmul.allow_tf32 == before[1]
