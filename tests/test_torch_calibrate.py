"""Network-wise calibration in the port against the JAX package, on the
80x160 fixture with the tiny HNeRV: ``decode_cf`` and its gradients, the
temperature schedule, one calibration step of each phase, a 3-step
trajectory on the JAX package's own shuffles, resume, and the CLI's
artifact read back by both packages' ``eval_quantized``. Weights come from
the JAX init, frames from the fixture PNGs; the port runs on the CPU (its
kernels' plain versions) and the JAX package its jnp tail twin, as its CPU
calibration does.

Tolerances: a step's loss 1e-5 relative; gradients 1e-4 of each leaf's
largest |grad| (fp32 sums over every position in another order); decode
3e-5 absolute on [0, 1] values; artifact PSNR 1e-3 dB, MS-SSIM 1e-5."""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.models import tail_plan_for as jax_tail_plan_for
from neuroquant_tpu.ops import tail_fused as jtf
from neuroquant_tpu.quantization import calibrate as jcal
from neuroquant_tpu.quantization import qmodel as jqm
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu_torch.models import build_model, tail_plan_for
from neuroquant_tpu_torch.ops import tail_fused as ttf
from neuroquant_tpu_torch.quantization import calibrate as tcal
from neuroquant_tpu_torch.quantization import qmodel as tqm
from neuroquant_tpu_torch.quantization.spec import make_spec
from neuroquant_tpu_torch.utils.convert import (
    quant_state_from_numpy, state_dict_from_jax)

BITS = (6, 5, 4, 5, 6)
SEED = 903


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tiny_hnerv_cfg, frame_dir):
    cfg = dict(tiny_hnerv_cfg)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    jm = jax_build_model("hnerv", cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(frames[:1]))
    emb = np.asarray(jm.apply(params, jnp.asarray(frames), method="encode"))
    tm = build_model("hnerv", cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax("hnerv", _np(params)),
                       strict=True)
    tm.eval()
    sd = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    jspec = jax_make_spec("hnerv", cfg, hadamard=True).with_bits(BITS)
    tspec = make_spec("hnerv", cfg, hadamard=True).with_bits(BITS)
    jplan, f, ch = jax_tail_plan_for("hnerv", cfg)
    jpack = {"gt": jtf.pack_targets(jnp.asarray(frames), jplan, f),
             "mask": jtf.border_mask(jplan, ch=ch), "denom": 80 * 160}
    tplan, _, _ = tail_plan_for("hnerv", cfg)
    tpack = {"gt": ttf.pack_targets(torch.from_numpy(frames), tplan, f),
             "mask": ttf.border_mask(tplan, ch=ch), "denom": 80 * 160}
    np.testing.assert_array_equal(tpack["gt"].numpy(),
                                  np.asarray(jpack["gt"]))
    return dict(cfg=cfg, frames=frames, jm=jm, params=params, emb=emb,
                tm=tm, sd=sd, jspec=jspec, tspec=tspec, jpack=jpack,
                tpack=tpack)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


class TestDecodeCF:
    def test_forward_and_weight_gradients(self, setup):
        s = setup
        wt = np.random.RandomState(1).randn(
            *np.asarray(s["jpack"]["gt"][:2]).shape).astype(np.float32)
        emb = s["emb"][:2]

        def jf(p):
            out = s["jm"].apply(p, jnp.asarray(emb), method="decode_cf")
            return (out * wt).sum(), out

        (_, want), jg = jax.value_and_grad(jf, has_aux=True)(s["params"])
        tm = s["tm"]
        tm.zero_grad()
        got = tm.decode_cf(torch.from_numpy(emb))
        (got * torch.from_numpy(wt)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=3e-5, rtol=0)
        want_g = state_dict_from_jax("hnerv", _np(jg))
        n = 0
        for name, prm in tm.named_parameters():
            if not name.startswith(("decoder.", "head_layer.")):
                continue
            _close(prm.grad.numpy(), want_g[name].numpy(), 1e-4)
            n += 1
        assert n == 2 * len(s["tspec"].layer_names)
        tm.zero_grad()


class TestLinearTempDecay:
    @pytest.mark.parametrize("warmup", [0.0, 0.2, 0.5, 1.0])
    def test_matches_jax(self, warmup):
        jt = jcal.LinearTempDecay(132, rel_start_decay=warmup, start_b=20,
                                  end_b=2)
        tt = tcal.LinearTempDecay(132, rel_start_decay=warmup, start_b=20,
                                  end_b=2)
        for t in (0, 1, 26, 27, 66, 100, 131, 132):
            want = float(jt(jnp.asarray(t, jnp.int32)))
            got = tt(t)
            assert np.isfinite(got)
            assert got == pytest.approx(want, rel=1e-6, abs=1e-6), t
        if warmup == 1.0:
            assert tt(132) == 20.0


def _jax_states(s, phase):
    state = jqm.init_quant_state(s["params"], s["jspec"])
    if phase == 2:
        state = jqm.adaround_upgrade(s["params"], s["jspec"], state)
    return state


KEYS = {1: ("w_delta", "b_delta"), 2: ("w_alpha", "b_alpha")}
MODE = {1: "uaq", 2: "adaround"}


def _extras(s, iters, warmup):
    """Phase 2's round loss, for both packages, as model_reconstruction
    builds it."""
    jt = jcal.LinearTempDecay(iters, rel_start_decay=warmup, start_b=20,
                              end_b=2)

    def jextra(st, count):
        b = jt(count)
        active = count >= iters * warmup
        return (jnp.where(active, jqm.round_loss(st, s["jspec"], b, 0.01),
                          0.0), jnp.where(active, b, 0.0))

    tt = tcal.LinearTempDecay(iters, rel_start_decay=warmup, start_b=20,
                              end_b=2)

    def textra(st, count):
        if count < iters * warmup:
            return 0.0, 0.0
        b = tt(count)
        return tqm.round_loss(st, s["tspec"], b, 0.01), b

    return jextra, textra


def _jax_steps(s, state, phase, lr, batches, jextra):
    """The JAX calibration step as ``calibrate._run_phase`` runs it
    (value_and_grad of its loss, optax Adam), one batch after another:
    (losses, first step's gradients, final state)."""
    tstate, frozen = jcal._split_state(state, KEYS[phase])
    opt = optax.adam(lr, eps=1e-8)
    ostate = opt.init(tstate)
    pack = s["jpack"]

    def loss_at(ts, img, inputs, count):
        st = jcal._merge_state(ts, frozen)
        qp = jqm.quantize_params(s["params"], s["jspec"], st,
                                 mode=MODE[phase], soft=True)
        pred = s["jm"].apply(qp, inputs, method="decode_cf")
        diff = (pred.astype(jnp.float32) - img) * pack["mask"]
        rec = (diff * diff).sum() / (img.shape[0] * pack["denom"])
        rnd, b = jextra(st, count) if jextra is not None else (0.0, 0.0)
        return rec + rnd, (rec, rnd, b)

    step = jax.jit(jax.value_and_grad(loss_at, has_aux=True))
    losses, first = [], None
    for count, idx in enumerate(batches, 1):
        idx = jnp.asarray(idx)
        (loss, _), grads = step(tstate, pack["gt"][idx],
                                jnp.asarray(s["emb"])[idx],
                                jnp.asarray(count, jnp.int32))
        first = grads if first is None else first
        updates, ostate = opt.update(grads, ostate, tstate)
        tstate = optax.apply_updates(tstate, updates)
        losses.append(float(loss))
    return losses, first, jcal._merge_state(tstate, frozen)


class TestCalibrationStep:
    @pytest.mark.parametrize("phase", [1, 2])
    def test_one_step_matches_jax(self, setup, phase):
        """One step from the same state and batch: the loss and the
        gradient of every trainable leaf."""
        s = setup
        jstate = _jax_states(s, phase)
        jextra, textra = _extras(s, 10, 0.0) if phase == 2 else (None, None)
        batch = np.array([5, 2])
        losses, jgrads, _ = _jax_steps(s, jstate, phase, 0.001, [batch],
                                       jextra)
        tstate = quant_state_from_numpy(_np(jstate))
        for st in tstate.values():
            for k in KEYS[phase]:
                st[k].requires_grad_()
        loss = tcal.make_loss(s["tm"], s["sd"], s["tspec"], MODE[phase],
                              2.0, s["tpack"], textra)
        idx = torch.from_numpy(batch)
        total, _ = loss(tstate, s["tpack"]["gt"][idx],
                        torch.from_numpy(s["emb"])[idx], 1)
        total.backward()
        assert float(total.detach()) == pytest.approx(losses[0], rel=1e-5)
        for ln in s["tspec"].layer_names:
            for k in KEYS[phase]:
                _close(tstate[ln][k].grad.numpy(), jgrads[ln][k], 1e-4)

    def test_three_step_trajectory_on_jax_shuffles(self, setup, monkeypatch):
        """Phase 2 (iters=3, one epoch of 3 steps at batch 2 over 6 frames)
        through both packages' model_reconstruction, the port fed the JAX
        epoch permutation. Losses at rtol 1e-4. Leaves at atol 2*lr*steps:
        Adam's step is lr * m/sqrt(v), about +-lr whatever the gradient's
        size, so on a leaf whose gradient is near zero a tiny difference in
        it can flip the step's sign."""
        self._trajectory(setup, monkeypatch, "jnp")

    def test_three_step_trajectory_fq_impl_pallas(self, setup, monkeypatch):
        """The same trajectory with fq_impl='pallas' in both packages: the
        JAX Pallas fake-quant kernels in interpret mode, the port's fused
        module through its plain version; the same tolerances."""
        self._trajectory(setup, monkeypatch, "pallas")

    @staticmethod
    def _trajectory(setup, monkeypatch, fq_impl):
        s = dict(setup)
        s["jspec"] = dataclasses.replace(s["jspec"], fq_impl=fq_impl)
        s["tspec"] = dataclasses.replace(s["tspec"], fq_impl=fq_impl)
        train_ind, lr, iters, warmup = list(range(6)), 0.003, 3, 0.34
        kw = dict(arch="hnerv", batch_size=2, iters=iters, warmup=warmup,
                  lr=lr, seed=SEED, b_range=(20, 2), weight=0.01)
        want, mode = jcal.model_reconstruction(
            s["jm"], s["params"], s["jspec"],
            jqm.init_quant_state(s["params"], s["jspec"]),
            jnp.asarray(s["emb"]), jnp.asarray(s["frames"]), train_ind,
            log_fn=lambda m: None, **kw)
        assert mode == "adaround"
        rng = jax.random.PRNGKey(SEED)
        rng, _ = jax.random.split(rng)
        _, prng2 = jax.random.split(rng)
        perm = np.asarray(jax.random.permutation(
            jax.random.fold_in(prng2, 0), jnp.asarray(train_ind)))
        # the JAX step replayed here equals its model_reconstruction
        jextra, textra = _extras(s, iters, warmup)
        jlosses, _, jfinal = _jax_steps(s, _jax_states(s, 2), 2, lr,
                                        perm.reshape(3, 2), jextra)
        for ln in s["jspec"].layer_names:
            for k in want[ln]:
                np.testing.assert_allclose(np.asarray(jfinal[ln][k]),
                                           np.asarray(want[ln][k]),
                                           rtol=1e-6, atol=1e-6)
        losses = []
        orig = tcal.make_loss

        def recording(*a, **k):
            fn = orig(*a, **k)

            def loss(*args):
                out = fn(*args)
                losses.append(float(out[0]))
                return out
            return loss

        monkeypatch.setattr(tcal, "make_loss", recording)
        got, tmode = tcal.model_reconstruction(
            s["tm"], s["sd"], s["tspec"],
            tqm.init_quant_state(s["sd"], s["tspec"]),
            torch.from_numpy(s["emb"]), torch.from_numpy(s["frames"]),
            train_ind, log_fn=lambda m: None,
            epoch_orders=lambda phase, e: perm, **kw)
        assert tmode == "adaround"
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)
        for ln in s["jspec"].layer_names:
            assert set(got[ln]) == set(want[ln])
            for k in want[ln]:
                np.testing.assert_allclose(
                    got[ln][k].numpy(), np.asarray(want[ln][k]), rtol=0,
                    atol=2 * lr * iters if k.endswith("alpha") else 1e-6,
                    err_msg=f"{ln}/{k}")

    def test_resume_is_an_exact_continuation(self, setup, tmp_path):
        """Phase 2 checkpointed every 4 of 6 epochs; resuming from the
        epoch-3 checkpoint (state, Adam moments, count, the same shuffles)
        replays epochs 4-5 to the same state. To 1e-6, as the JAX
        package's own resume test: the CPU's BLAS may sum a large dW in
        another order in another process state (seen: 1.5e-8 on one
        alpha)."""
        s = setup
        kw = dict(arch="hnerv", batch_size=2, iters=18, warmup=0.2,
                  lr=0.003, seed=SEED, log_fn=lambda m: None)
        args = (s["tm"], s["sd"], s["tspec"])
        data = (torch.from_numpy(s["emb"]), torch.from_numpy(s["frames"]),
                list(range(6)))
        ckpt = str(tmp_path / "calib_resume.pkl")
        full, _ = tcal.model_reconstruction(
            *args, tqm.init_quant_state(s["sd"], s["tspec"]), *data,
            checkpoint_path=ckpt, ckpt_every_epochs=4, **kw)
        with open(ckpt, "rb") as f:
            saved = pickle.load(f)
        assert (saved["epoch"], saved["count"]) == (3, 12)
        logs = []
        resumed, _ = tcal.model_reconstruction(
            *args, tqm.init_quant_state(s["sd"], s["tspec"]), *data,
            checkpoint_path=ckpt, ckpt_every_epochs=100,
            **dict(kw, log_fn=logs.append))
        assert any("resuming" in m for m in logs)
        for ln in full:
            for k in full[ln]:
                np.testing.assert_allclose(resumed[ln][k].numpy(),
                                           full[ln][k].numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{ln}/{k}")

    def test_nearest_and_mixed_rounding(self, setup):
        s = setup
        kw = dict(arch="hnerv", batch_size=2, iters=60, warmup=0.2,
                  lr=0.003, seed=SEED, log_fn=lambda m: None)
        data = (torch.from_numpy(s["emb"]), torch.from_numpy(s["frames"]),
                list(range(6)))
        st0 = tqm.init_quant_state(s["sd"], s["tspec"])
        near, mode = tcal.model_reconstruction(
            s["tm"], s["sd"], s["tspec"], st0, *data, rounding="nearest",
            **kw)
        assert mode == "uaq"
        assert all("w_alpha" not in v for v in near.values())
        assert any(not torch.equal(near[ln]["w_delta"], st0[ln]["w_delta"])
                   for ln in near)                     # phase 1 ran
        only = (s["tspec"].layer_names[1], s["tspec"].layer_names[3])
        mixed, mode = tcal.model_reconstruction(
            s["tm"], s["sd"], s["tspec"], st0, *data, adaround_only=only,
            **dict(kw, iters=9))
        assert mode == "adaround"
        for ln, v in mixed.items():
            assert ("w_alpha" in v) == (ln in only), ln
            assert all(bool(torch.isfinite(t).all()) for t in v.values())


class TestCLI:
    def test_artifact_read_by_both_packages(self, setup, frame_dir,
                                            tmp_path, monkeypatch):
        """calibrate_network.main on the CPU (both phases, mixed rounding)
        writes an artifact that the JAX and the port's eval_quantized read
        to the same PSNR and MS-SSIM."""
        import yaml

        from neuroquant_tpu.methods import eval_quantized as jax_eval
        from neuroquant_tpu.utils.torch_compat import save_pth
        from neuroquant_tpu_torch.methods import calibrate_network
        from neuroquant_tpu_torch.methods import eval_quantized as port_eval

        s = setup
        monkeypatch.chdir(tmp_path)
        save_pth("ck.pth", "hnerv", s["params"])
        with open("tiny.yaml", "w") as f:
            yaml.safe_dump(s["cfg"], f)
        out_path, state, spec = calibrate_network.main([
            "--config", "tiny.yaml", "--arch", "hnerv", "--data_path",
            frame_dir, "--vid", "tiny", "--outf", "t3", "--ckpt", "ck.pth",
            "--precision", *map(str, BITS), "--channel_wise", "--hadamard",
            "--batch_size", "2", "--iters_w", "60", "--warmup", "0.2",
            "--lr", "0.003", "--adaround_layers", "1", "3",
            "--data_split", "6_6_8", "--device", "cpu"])
        assert os.path.exists(out_path)
        with open(out_path, "rb") as f:
            art = pickle.load(f)
        assert art["mode"] == "adaround" and art["arch"] == "hnerv"
        assert [("w_alpha" in art["quant_state"][n]) for n in
                spec.layer_names] == [False, True, False, True, False]
        for name, c in art["int_codes"].items():
            assert c["w"].dtype == np.int32 and c["w"].min() >= 0
        logs = [f for f in os.listdir(os.path.dirname(out_path))
                if f.endswith(".log")]
        with open(os.path.join(os.path.dirname(out_path), logs[0])) as f:
            text = f.read()
        for block in ("Full-precision model", "Close quantization model",
                      "Weight quantization model w/o opt",
                      "Weight quantization model w/ opt", "[calib] phase 1",
                      "[calib] phase 2"):
            assert block in text, block
        argv = ["--artifact", out_path, "--data_path", frame_dir,
                "--data_split", "6_6_8"]
        want = jax_eval.main(argv)
        got = port_eval.main(argv + ["--device", "cpu"])
        for i, (g, w) in enumerate(zip(got, want)):
            tol = 1e-3 if i % 2 == 0 else 1e-5      # PSNR dB | MS-SSIM
            np.testing.assert_allclose(float(np.mean(g)), float(np.mean(w)),
                                       atol=tol, rtol=0)

    @pytest.mark.parametrize("flag,item", [
        (["--scope", "block"], "item 13"), (["--scope", "layer"], "item 13"),
        (["--mesh_devices", "2"], "item 14"), (["--fq_impl", "pallas"],
                                               "item 11"),
        (["--compute_dtype", "bfloat16"], "item 16"),
        (["--dump_vis"], "item 8")])
    def test_unported_flags_name_their_item(self, flag, item):
        from neuroquant_tpu_torch.methods import calibrate_network

        if item == "item 11":
            # ported: the flag parses (tests/test_torch_coding.py runs the
            # CLI with it) and 'jnp' stays the default
            args = calibrate_network.parse_args(
                ["--config", "c.yaml", "--arch", "hnerv"] + flag)
            assert args.fq_impl == "pallas"
            assert calibrate_network.parse_args(
                ["--config", "c.yaml", "--arch", "hnerv"]).fq_impl == "jnp"
            return
        if item == "item 13":
            # ported: the flag parses
            # (tests/test_torch_calib_unit_cli.py runs the CLI with it)
            args = calibrate_network.parse_args(
                ["--config", "c.yaml", "--arch", "hnerv", "--device",
                 "cpu"] + flag)
            assert args.scope == flag[1]
            return
        if item == "item 14":
            # ported: the flag parses (tests/test_torch_dp.py runs the CLI
            # with it)
            assert calibrate_network.parse_args(
                ["--config", "c.yaml", "--arch", "hnerv", "--device",
                 "cpu"] + flag).mesh_devices == 2
            return
        if item == "item 8":
            # ported: the flag parses
            # (tests/test_torch_regress.py::TestCLI::
            # test_calibrate_network_dump_vis runs the CLI with it)
            assert calibrate_network.parse_args(
                ["--config", "c.yaml", "--arch", "hnerv"] + flag).dump_vis
            return
        # item 16, ported: the flag parses (tests/test_torch_bf16_cli.py
        # runs the CLI with it) and float32 stays the default
        assert calibrate_network.parse_args(
            ["--config", "c.yaml", "--arch", "hnerv", "--device", "cpu"]
            + flag).compute_dtype == "bfloat16"
        assert calibrate_network.parse_args(
            ["--config", "c.yaml", "--arch", "hnerv"]).compute_dtype \
            == "float32"
