"""The port's CLIs on a decoder with a batch norm and a non-GELU
activation (``dec_norm: batch``, ``dec_acts: relu``: the plain unpacked
chain, no port kernel), the tiny HNeRV on the 80x160 fixture, on the CPU,
from the port's init written by its ``save_pth`` (the serving slice
against the JAX package: ``test_torch_dec_norm_cli.py``):
- ``regress``: its ``.pth`` carries the trained norm;
- ``bit_assign`` on both ``--hvp_impl`` routes and with ``--remat``: one
  best candidate, one set of scores;
- ``calibrate_network --scope block`` and ``--scope layer`` (fisher_diag),
  then ``compress`` and ``eval_quantized --from_bitstream``; the fisher
  cache's per-sample gradients from batch-1 decodes, as the JAX package's;
- a stage-1 step over two gloo ranks equal to one process's over the whole
  batch: the decoder's batch norm takes both ranks' frames.
No JAX here.

Tolerances: bit_assign's per-layer scores on its two routes and with remat
1e-6 of the candidate's largest (the same plain chain); the gloo step in
float64 within 1e-5 of each leaf's largest, its losses 1e-9
(``test_torch_dp.py``'s)."""

import glob
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

import _dp_cases
from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu_torch.parallel import launch
from neuroquant_tpu_torch.utils.convert import is_block_norm, save_pth

BITS = ["5", "6", "3", "4", "5"]


@pytest.fixture(scope="module")
def setup(tiny_hnerv_cfg, tmp_path_factory):
    """The config (batch norm, relu) as yaml, one epoch evaluated once,
    and the port's init (seed 0) as a .pth."""
    from neuroquant_tpu_torch.models import build_model

    cfg = dict(tiny_hnerv_cfg, dec_norm="batch", dec_acts="relu")
    d = tmp_path_factory.mktemp("dec_norm_runs")
    with open(d / "tiny.yaml", "w") as f:
        yaml.safe_dump(dict(cfg, epoch=1, eval_freq=1), f)
    save_pth(str(d / "ck.pth"), build_model("hnerv", cfg, device="cpu",
                                            seed=0))
    return dict(cfg=cfg, dir=d)


def _calibrate(package, frame_dir, outf, *extra):
    return package.main([
        "--config", "tiny.yaml", "--arch", "hnerv", "--data_path",
        frame_dir, "--vid", "tiny", "--outf", outf, "--ckpt", "ck.pth",
        "--precision", *BITS, "--channel_wise", "--hadamard",
        "--batch_size", "2", "--data_split", "6_6_8", *extra])[0]


def test_regress_writes_the_norm(setup, frame_dir, monkeypatch):
    """One epoch of stage 1 from the JAX .pth: the checkpoint holds every
    block's batch norm, trained away from its init, and loads back to the
    trained model; the directory counts the norm's parameters."""
    from neuroquant_tpu_torch.methods import regress

    monkeypatch.chdir(setup["dir"])
    monkeypatch.setattr(regress, "_summary_writer", lambda log_dir: None)
    tm = regress.main(["--config", "tiny.yaml", "--arch", "hnerv",
                       "--data_path", frame_dir, "--vid", "tiny",
                       "--weight", "ck.pth", "--outf", "r1", "--device",
                       "cpu"])
    (d,) = glob.glob(os.path.join("results", "r1", "*", "Encoder_*"))
    sd = torch.load(os.path.join(d, "model_latest.pth"))
    norms = [k for k in sd if is_block_norm(k)]
    assert len(norms) == 6
    assert any(not torch.equal(sd[k], torch.ones_like(sd[k]))
               for k in norms if k.endswith("weight"))
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v.cpu()), k
    n_norm = sum(int(v.numel()) for k, v in sd.items() if is_block_norm(k))
    assert n_norm == 2 * sum(tm.cfg.decoder_channels())


def test_bit_assign_both_routes_and_remat(setup, frame_dir, monkeypatch):
    """bit_assign --mode omega on --hvp_impl xla and pallas (a decoder with
    a norm or a non-GELU activation takes the plain chain on both) and
    with --remat: one best candidate, one set of per-layer scores."""
    from neuroquant_tpu_torch.methods import bit_assign

    monkeypatch.chdir(setup["dir"])
    seen = []
    orig = bit_assign.sensitivity_criterion

    def criterion(*a, **k):
        total, per_layer = orig(*a, **k)
        seen.append(per_layer)
        return total, per_layer

    monkeypatch.setattr(bit_assign, "sensitivity_criterion", criterion)
    argv = ["--config", "tiny.yaml", "--arch", "hnerv", "--data_path",
            frame_dir, "--vid", "tiny", "--ckpt", "ck.pth", "--batch_size",
            "2", "--channel_wise", "--init", "max", "--mode", "omega",
            "--candidates", "5,6,3,4,5;2,2,2,2,2", "--device", "cpu"]
    best = [bit_assign.main(argv + ["--outf", f"b_{i}", *extra])[:2]
            for i, extra in enumerate((["--hvp_impl", "xla"],
                                       ["--hvp_impl", "pallas"],
                                       ["--hvp_impl", "pallas", "--remat"]))]
    assert best[0] == best[1] == best[2]
    assert len(seen) == 6
    for i in range(2, 6):
        ref = seen[i % 2]
        scale = max(abs(v) for v in ref)
        assert scale > 0
        np.testing.assert_allclose(seen[i], ref, atol=1e-6 * scale, rtol=0)


@pytest.mark.parametrize("scope", ["block", "layer"])
def test_unit_scope(setup, frame_dir, monkeypatch, scope):
    """calibrate_network --scope block and --scope layer (fisher_diag,
    whose gradient cache decodes each frame alone, as the JAX package's
    batch of one does under a batch norm): an AdaRound artifact that the
    port evaluates from its stream."""
    from neuroquant_tpu_torch.methods import calibrate_network, compress
    from neuroquant_tpu_torch.methods import eval_quantized

    monkeypatch.chdir(setup["dir"])
    extra = ["--opt_mode", "fisher_diag"] if scope == "layer" else []
    path = _calibrate(calibrate_network, frame_dir, f"u_{scope}", "--scope",
                      scope, "--iters_w", "8", "--device", "cpu", *extra)
    with open(path, "rb") as f:
        assert pickle.load(f)["mode"] == "adaround"
    stream = str(setup["dir"] / f"u_{scope}.nqtb")
    compress.main(["--artifact", path, "--data_path", frame_dir, "--out",
                   stream])
    got = eval_quantized.main(["--artifact", path, "--data_path", frame_dir,
                               "--data_split", "6_6_8", "--from_bitstream",
                               stream, "--device", "cpu"])
    assert 5.0 < float(np.mean(got[0])) < 60.0


def test_unit_grads_decode_each_frame_alone(setup, monkeypatch):
    """Under a batch norm the fisher cache's per-sample gradients come
    from batch-1 decodes (JAX: a vmapped batch of one); without one, from
    one decode of the batch."""
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization import calib_unit, make_spec
    from neuroquant_tpu_torch.quantization import init_quant_state

    sizes = []
    orig = calib_unit._decode

    def decode(model, params, x, **kw):
        sizes.append(int(x.shape[0]))
        return orig(model, params, x, **kw)

    monkeypatch.setattr(calib_unit, "_decode", decode)
    frames = torch.rand(3, 80, 160, 3, generator=torch.Generator()
                        .manual_seed(0))
    for norm, want in (("batch", [1] * 6), ("none", [3, 3])):
        cfg = dict(setup["cfg"], dec_norm=norm)
        model = build_model("hnerv", cfg, device="cpu", seed=0).eval()
        params = {k: v.detach() for k, v in model.state_dict().items()}
        spec = make_spec("hnerv", cfg, channel_wise=True)
        with torch.no_grad():
            cali = model.encode(frames)
        sizes.clear()
        g = calib_unit.harvest_unit_grads(model, params, spec,
                                          init_quant_state(params, spec), 2,
                                          cali)
        assert sizes == want and g.shape[0] == 3


def test_stage1_step_over_two_ranks(setup):
    """Two stage-1 epochs at batch 4 (2 + 2 frames) of the batch-norm
    decoder on two gloo ranks in float64: each step's loss and the
    weights as one process's over the whole batch, the ranks identical."""
    frames = np.random.RandomState(7).rand(4, 80, 160, 3).astype(np.float32)
    args = ("hnerv", dict(setup["cfg"]), frames, 4, 2)
    want = _dp_cases.train_case(None, *args)
    ranks = launch(_dp_cases.train_case, 2, "cpu", args)
    for r in ranks:
        np.testing.assert_allclose(r["losses"].numpy(),
                                   want["losses"].numpy(), rtol=1e-9)
        for k, w in want["weights"].items():
            scale = max(float(w.abs().max()), 1e-30)
            assert float((r["weights"][k] - w).abs().max()) <= 1e-5 * scale, k
    for k, v in ranks[0]["weights"].items():
        assert torch.equal(v, ranks[1]["weights"][k]), k
