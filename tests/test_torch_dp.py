"""Data parallelism in the port (``--mesh_devices``, ``parallel/mesh.py``)
on the CPU: two gloo ranks against one process for network-scope
``calibrate_network`` and ``regress``, the port's two-rank calibration
against the JAX package's on two of conftest's virtual CPU devices, uneven
shards and a rank with no frame, PNeRV's batch norm over the ranks, and the
refusals.

Tolerances: parameters and quant state after a data-parallel run within
1e-5 of each leaf's largest value of the one-process run's (the same steps;
the batch's sum is taken in another order); the JAX package's own bounds
between a data-parallel and a single-device run (``tests/test_dp_cli.py``:
final PSNR 0.15 dB for stage 1, the quantized PSNR 0.2 dB for
calibration), and 0.2 dB between the two packages' data-parallel
calibrations from one ``.pth``. The calibration's state is held at 1e-5 in
float64 on an even split and in fp32 on the uneven ones: in fp32 the other
order of the batch's sum can move a phase-1 delta across a float16
rounding boundary at the AdaRound hand-off (one delta of 224 did, on the
CLI run below, by one float16 step, 4e-4 of its layer's largest), and that
channel's alphas then start from other residues; the CLI runs are held to
the PSNR bounds."""

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import _dp_cases
from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu_torch.methods import calibrate_network, regress
from neuroquant_tpu_torch.parallel import launch, shard_batch
from neuroquant_tpu_torch.parallel.mesh import Mesh
from neuroquant_tpu_torch.utils.convert import state_dict_from_jax

LEAF_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _logs(outdir):
    logs = sorted(glob.glob(os.path.join(outdir, "**/*.log"),
                            recursive=True))
    assert logs, outdir
    with open(logs[-1]) as f:
        return f.read()


def _close_leaves(got, want, what):
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, (what, k)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= LEAF_TOL, (what, k, err)


@pytest.fixture(scope="module")
def files(tiny_hnerv_cfg, frame_dir, tmp_path_factory):
    """The tiny config as yaml, a stage-1 .pth of the JAX init (both
    packages read it), the JAX init's state dict and the fixture frames."""
    from neuroquant_tpu.utils.torch_compat import save_pth

    d = tmp_path_factory.mktemp("dp")
    cfg = dict(tiny_hnerv_cfg)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    jm = jax_build_model("hnerv", cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(frames[:1]))
    save_pth(str(d / "ck.pth"), "hnerv", params)
    with open(d / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    sd = {k: v.numpy() for k, v in
          state_dict_from_jax("hnerv", _np(params)).items()}
    return dict(dir=d, cfg=cfg, frames=frames, sd=sd)


@pytest.fixture(scope="module")
def calib_runs(files, frame_dir):
    """calibrate_network at batch 4, 40 steps (1 phase-1 and 19 phase-2
    epochs of 2 steps): the port in one process and on two gloo ranks, and
    the JAX package on a two-device mesh."""
    from neuroquant_tpu.methods import calibrate_network as jax_calibrate

    d = files["dir"]
    argv = ["--config", "tiny.yaml", "--arch", "hnerv", "--data_path",
            frame_dir, "--vid", "tiny", "--ckpt", "ck.pth", "--precision",
            "6", "5", "4", "5", "6", "--channel_wise", "--hadamard",
            "--batch_size", "4", "--iters_w", "40", "--lr", "0.003",
            "--warmup", "0.2", "--calib_ckpt_freq", "0"]
    cwd = os.getcwd()
    os.chdir(d)
    try:
        one = calibrate_network.main(argv + ["--outf", "c_one", "--device",
                                             "cpu"])
        dp = calibrate_network.main(argv + ["--outf", "c_dp", "--device",
                                            "cpu", "--mesh_devices", "2"])
        jax_calibrate.main(argv + ["--outf", "c_jax", "--mesh_devices",
                                   "2"])
    finally:
        os.chdir(cwd)
    return dict(one=one, dp=dp, dir=d)


def _qopt_psnr(outdir):
    vals = re.findall(r"best_pred_seen_psnr: ([\d.]+)", _logs(outdir))
    assert len(vals) >= 4, outdir
    return float(vals[3])      # the fourth block: quantized, calibrated


class TestCalibrate:
    def test_two_ranks_match_one_process(self, calib_runs):
        """Both runs write their artifact and the same layers' state; rank
        0 wrote the log, with every block and both phases; the quantized
        PSNR within 0.2 dB."""
        d = calib_runs["dir"]
        out_one, state_one, _ = calib_runs["one"]
        out_dp, state_dp, _ = calib_runs["dp"]
        assert os.path.exists(d / out_one) and os.path.exists(d / out_dp)
        assert {ln: sorted(v) for ln, v in state_dp.items()} == {
            ln: sorted(v) for ln, v in state_one.items()}
        text = _logs(str(d / "results/c_dp"))
        for line in ("data-parallel calibration over 2 ranks",
                     "Weight quantization model w/ opt", "[calib] phase 1",
                     "[calib] phase 2"):
            assert line in text, line
        p1 = _qopt_psnr(str(d / "results/c_one"))
        p2 = _qopt_psnr(str(d / "results/c_dp"))
        assert abs(p1 - p2) < 0.2, (p1, p2)

    def test_two_ranks_match_jax_two_devices(self, calib_runs):
        """Port --mesh_devices 2 against JAX --mesh_devices 2 from one
        .pth: the quantized PSNR within 0.2 dB."""
        d = calib_runs["dir"]
        p_port = _qopt_psnr(str(d / "results/c_dp"))
        p_jax = _qopt_psnr(str(d / "results/c_jax"))
        assert abs(p_port - p_jax) < 0.2, (p_port, p_jax)


def test_regress_two_ranks_match_one_process(files, frame_dir,
                                             monkeypatch):
    """Stage 1 at batch 4, 2 epochs of 2 steps: the weights within
    LEAF_TOL of the one-process run's, the final PSNR within 0.15 dB; rank
    0 wrote the checkpoints."""
    d = files["dir"]
    with open(d / "tiny_b4.yaml", "w") as f:
        yaml.safe_dump(dict(files["cfg"], epoch=2, eval_freq=2,
                            batch_size=4, learning_rate=0.004), f)
    argv = ["--config", "tiny_b4.yaml", "--arch", "hnerv", "--data_path",
            frame_dir, "--vid", "tiny", "--device", "cpu"]
    # no TensorBoard in this process (its import takes seconds); rank 0
    # of the spawned run has its own
    monkeypatch.setattr(regress, "_summary_writer", lambda log_dir: None)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        one = regress.main(argv + ["--outf", "r_one"]).state_dict()
        dp = regress.main(argv + ["--outf", "r_dp", "--mesh_devices",
                                  "2"]).state_dict()
    finally:
        os.chdir(cwd)
    _close_leaves(dp, {k: v.detach().numpy() for k, v in one.items()},
                  "regress")
    ck = glob.glob(str(d / "results/r_dp/**/epoch2.pth"), recursive=True)
    assert len(ck) == 1
    _close_leaves(torch.load(ck[0], weights_only=True),
                  {k: v.detach().numpy() for k, v in one.items()}, "pth")

    def final_psnr(run):
        vals = re.findall(r"pred_seen_psnr: ([\d.]+)",
                          _logs(str(d / f"results/{run}")))
        return float(vals[-1])

    assert "data-parallel training over 2 ranks" in _logs(
        str(d / "results/r_dp"))
    assert abs(final_psnr("r_one") - final_psnr("r_dp")) < 0.15


@pytest.mark.parametrize("n,size,want", [
    (4, 2, [2, 2]), (3, 2, [2, 1]), (1, 2, [1, 0]), (5, 3, [2, 2, 1])])
def test_shard_batch_splits_rows(n, size, want):
    rows = torch.arange(n)
    got = [shard_batch(rows, Mesh(r, size, torch.device("cpu"), None))
           for r in range(size)]
    assert [len(g) for g in got] == want
    assert torch.equal(torch.cat(got), rows)
    assert shard_batch(rows, None) is rows


@pytest.mark.parametrize("batch,dtype", [(4, torch.float64),
                                         (3, torch.float32),
                                         (1, torch.float32)])
def test_shards_match_one_process(files, batch, dtype):
    """20 steps (one phase-1 step, then phase 2) at batch 4 over two ranks
    (2 + 2 frames), batch 3 (2 + 1) and batch 1 (rank 1 has none, so it
    runs no decode and adds zero gradients): the state within LEAF_TOL of
    one process, the same on both ranks."""
    args = (files["cfg"], files["sd"], files["frames"][:batch], batch, 20,
            dtype)
    want = _dp_cases.calibrate_case(None, *args)
    ranks = launch(_dp_cases.calibrate_case, 2, "cpu", args)
    for ln, leaves in want["state"].items():
        w = {k: v.numpy() for k, v in leaves.items()}
        for r in ranks:
            _close_leaves(r["state"][ln], w, ln)
        for k in leaves:
            assert torch.equal(ranks[0]["state"][ln][k],
                               ranks[1]["state"][ln][k]), (ln, k)
    assert want["decodes"] == 20 and ranks[0]["decodes"] == 20
    assert ranks[1]["decodes"] == (20 if batch > 1 else 0)


@pytest.mark.parametrize("case,batch", [("train", 4), ("train", 3),
                                        ("calibrate", 4)])
def test_pnerv_batch_norm_spans_the_ranks(files, tiny_pnerv_cfg, case,
                                          batch):
    """PNeRV1's shortcut batch norm takes its statistics over both ranks'
    frames, as over the whole batch in one process: in float64, stage-1
    steps (forward and backward through the norm) at batch 4 (2 + 2
    frames) and 3 (2 + 1), and network calibration at batch 4; weights or
    state within LEAF_TOL of one process, each step's loss within 1e-9 of
    it, the ranks identical."""
    cfg = dict(tiny_pnerv_cfg)
    if case == "train":
        args = ("pnerv", cfg, files["frames"], batch, 2)
        fn, key = _dp_cases.train_case, "weights"
    else:
        args = (cfg, None, files["frames"], batch, 20, torch.float64,
                "pnerv")
        fn, key = _dp_cases.calibrate_case, "state"
    want = fn(None, *args)
    ranks = launch(fn, 2, "cpu", args)
    leaves = (lambda st: {f"{ln}/{k}": v for ln, s in st.items()
                          for k, v in s.items()}) if key == "state" else dict
    w = {k: v.numpy() for k, v in leaves(want[key]).items()}
    for r in ranks:
        _close_leaves(leaves(r[key]), w, case)
    for k, v in leaves(ranks[0][key]).items():
        assert torch.equal(v, leaves(ranks[1][key])[k]), k
    if case == "train":
        np.testing.assert_allclose(ranks[0]["losses"].numpy(),
                                   want["losses"].numpy(), rtol=1e-9)


def test_pnerv_refuses_a_rank_without_frames(tiny_pnerv_cfg):
    """Batch 1 over two ranks would leave rank 1 outside the batch norm's
    all-reduce: refused before any step; HNeRV (no batch norm) runs it."""
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.parallel.mesh import check_batch

    mesh = Mesh(1, 2, torch.device("cpu"), None)
    pnerv = build_model("pnerv", dict(tiny_pnerv_cfg), device="cpu")
    with pytest.raises(ValueError, match="leaves a rank no frame"):
        check_batch(pnerv, 1, mesh)
    check_batch(pnerv, 2, mesh)
    check_batch(pnerv, 1, None)


def test_unit_scope_refuses_mesh(capsys):
    """JAX's parser error, word for word."""
    with pytest.raises(SystemExit):
        calibrate_network.parse_args(["--config", "c.yaml", "--arch",
                                      "hnerv", "--scope", "layer",
                                      "--mesh_devices", "2"])
    assert ("--mesh_devices applies to network-wise calibration only "
            "(unit reconstruction minibatches cached tensors)"
            in capsys.readouterr().err)


@pytest.mark.parametrize("cli", ["calibrate_network", "regress"])
def test_more_ranks_than_cards_is_refused(cli):
    """On the card (the default device) --mesh_devices N needs N cards; it
    never falls back to fewer ranks or to the CPU."""
    mod = {"calibrate_network": calibrate_network, "regress": regress}[cli]
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match=f"need {n} devices, have"):
        mod.main(["--config", "c.yaml", "--arch", "hnerv", "--mesh_devices",
                  str(n)])
