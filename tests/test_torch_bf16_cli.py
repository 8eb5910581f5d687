"""The two reduced-precision flags through the port's CLIs on the CPU (the
kernels' plain versions), on the 80x160 fixture with the tiny HNeRV from
the JAX init: ``calibrate_network --compute_dtype bfloat16`` writes an
artifact that the JAX package's and the port's ``eval_quantized`` read to
the same PSNR and MS-SSIM, and ``regress --matmul_precision bfloat16``
trains an epoch with finite losses, its evals in fp32 frames.

Tolerances: the artifact's PSNR 1e-3 dB and MS-SSIM 1e-5 between the two
packages' evaluations (both decode it in fp32, as after an fp32
calibration); a bf16 calibration run only has to reach a finite state and
an artifact, its quality is the card's measurement (chip_smoke.py)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu_torch.methods import regress

BITS = ("6", "5", "4", "5", "6")


@pytest.fixture(scope="module")
def run_dir(tiny_hnerv_cfg, frame_dir, tmp_path_factory):
    """The config as yaml and a JAX-written .pth of the JAX init."""
    from neuroquant_tpu.utils.torch_compat import save_pth

    cfg = dict(tiny_hnerv_cfg, epoch=1, eval_freq=1)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    jm = jax_build_model("hnerv", cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(frames[:1]))
    d = tmp_path_factory.mktemp("bf16")
    with open(d / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    save_pth(str(d / "ck.pth"), "hnerv", params)
    return d


def test_calibrate_network_bf16_artifact_read_by_both_packages(
        run_dir, frame_dir, monkeypatch):
    from neuroquant_tpu.methods import eval_quantized as jax_eval
    from neuroquant_tpu_torch.methods import calibrate_network
    from neuroquant_tpu_torch.methods import eval_quantized as port_eval
    from neuroquant_tpu_torch.quantization import calibrate as tcal

    monkeypatch.chdir(run_dir)
    dtypes = []
    make_loss = tcal.make_loss

    def recording(*a, **k):
        dtypes.append(k.get("compute_dtype"))
        return make_loss(*a, **k)

    monkeypatch.setattr(tcal, "make_loss", recording)
    out_path, state, spec = calibrate_network.main([
        "--config", "tiny.yaml", "--arch", "hnerv", "--data_path",
        frame_dir, "--vid", "tiny", "--outf", "b3", "--ckpt", "ck.pth",
        "--precision", *BITS, "--channel_wise", "--hadamard",
        "--batch_size", "2", "--iters_w", "40", "--compute_dtype",
        "bfloat16", "--data_split", "6_6_8", "--device", "cpu"])
    assert dtypes == [torch.bfloat16, torch.bfloat16]   # both phases
    assert all(bool(torch.isfinite(t).all()) and t.dtype == torch.float32
               for v in state.values() for t in v.values())
    with open(out_path, "rb") as f:
        art = pickle.load(f)
    assert art["mode"] == "adaround" and art["arch"] == "hnerv"
    argv = ["--artifact", out_path, "--data_path", frame_dir,
            "--data_split", "6_6_8"]
    want = jax_eval.main(argv)
    got = port_eval.main(argv + ["--device", "cpu"])
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-3 if i % 2 == 0 else 1e-5      # PSNR dB | MS-SSIM
        np.testing.assert_allclose(float(np.mean(g)), float(np.mean(w)),
                                   atol=tol, rtol=0)


def test_regress_bf16_trains(run_dir, frame_dir, monkeypatch):
    """One epoch under --matmul_precision bfloat16: every step's loss
    finite, the training inside the bf16 precision, the trained weights
    fp32 and finite."""
    from neuroquant_tpu_torch.ops import precision

    monkeypatch.chdir(run_dir)
    monkeypatch.setattr(regress, "_summary_writer", lambda log_dir: None)
    losses, modes = [], []
    orig = regress.loss_fn

    def recording(*a, **k):
        out = orig(*a, **k)
        losses.append(float(out.detach()))
        modes.append(precision.bf16_products(a[0]))
        return out

    monkeypatch.setattr(regress, "loss_fn", recording)
    model = regress.main([
        "--config", "tiny.yaml", "--arch", "hnerv", "--data_path", frame_dir,
        "--vid", "tiny", "--outf", "b1", "--matmul_precision", "bfloat16",
        "--device", "cpu"])
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert all(modes)
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in model.parameters())
