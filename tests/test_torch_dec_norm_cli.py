"""The serving slice on a decoder with a batch norm and a non-GELU
activation (``dec_norm: batch``, ``dec_acts: relu``: the plain unpacked
chain, no port kernel), the tiny HNeRV on the 80x160 fixture, both
packages from one JAX-written ``.pth``, the port on the CPU:
``calibrate_network`` (nearest rounding, no phase-1 epoch) gives the same
integer codes and artifact keys (no block norm, as the JAX package writes
it) and the same eval blocks; both packages' ``compress`` give the same
stream bytes; each package's ``eval_quantized`` reads the other's artifact
and stream to its metrics. ``test_torch_dec_norm_runs.py`` runs the rest
of the CLIs on the same config in the port.

Tolerances: PSNR 1e-3 dB, MS-SSIM 1e-5 (``test_torch_nerv_cli.py``'s);
codes and stream bytes exact."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu_torch.methods import common as tcommon
from neuroquant_tpu_torch.utils.convert import is_block_norm

BITS = ["5", "6", "3", "4", "5"]


@pytest.fixture(scope="module")
def setup(tiny_hnerv_cfg, tmp_path_factory):
    """The config (batch norm, relu) as yaml, one epoch evaluated once,
    and the JAX init as a JAX-written .pth."""
    from neuroquant_tpu.utils.torch_compat import save_pth

    cfg = dict(tiny_hnerv_cfg, dec_norm="batch", dec_acts="relu")
    jm = jax_build_model("hnerv", cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((2, 80, 160, 3)))
    assert "norm_fn" in params["params"]["blocks_0"]
    d = tmp_path_factory.mktemp("dec_norm")
    with open(d / "tiny.yaml", "w") as f:
        yaml.safe_dump(dict(cfg, epoch=1, eval_freq=1), f)
    save_pth(str(d / "ck.pth"), "hnerv", params)
    return dict(cfg=cfg, dir=d)


def _same_metrics(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-3 if i % 2 == 0 else 1e-5      # PSNR dB | MS-SSIM
        np.testing.assert_allclose(float(np.mean(g)), float(np.mean(w)),
                                   atol=tol, rtol=0)


def _recording(mp, common):
    seen = []
    orig = common.evaluate

    def evaluate(*a, **k):
        out = orig(*a, **k)
        seen.append([float(np.mean(v)) for v in out[0]])
        return out

    mp.setattr(common, "evaluate", evaluate)
    return seen


def _calibrate(package, frame_dir, outf, *extra):
    return package.main([
        "--config", "tiny.yaml", "--arch", "hnerv", "--data_path",
        frame_dir, "--vid", "tiny", "--outf", outf, "--ckpt", "ck.pth",
        "--precision", *BITS, "--channel_wise", "--hadamard",
        "--batch_size", "2", "--data_split", "6_6_8", *extra])[0]


@pytest.fixture(scope="module")
def artifacts(setup, frame_dir):
    """calibrate_network in each package, nearest rounding and no
    phase-1 epoch (the seeded shuffles differ, the result must not):
    (artifact paths, each run's eval-block results)."""
    from neuroquant_tpu.methods import calibrate_network as jcal
    from neuroquant_tpu.methods import common as jcommon
    from neuroquant_tpu_torch.methods import calibrate_network as tcal

    mp = pytest.MonkeyPatch()
    mp.chdir(setup["dir"])
    try:
        seen = {"jax": _recording(mp, jcommon),
                "port": _recording(mp, tcommon)}
        args = ("--iters_w", "8", "--rounding", "nearest")
        paths = {"jax": _calibrate(jcal, frame_dir, "cj", *args),
                 "port": _calibrate(tcal, frame_dir, "cp", *args,
                                    "--device", "cpu")}
        return {k: str(setup["dir"] / v) for k, v in paths.items()}, seen
    finally:
        mp.undo()


def test_artifacts_match_jax(artifacts):
    paths, seen = artifacts
    arts = {}
    for k, p in paths.items():
        with open(p, "rb") as f:
            arts[k] = pickle.load(f)
    assert set(arts["port"]["state_dict"]) == set(arts["jax"]["state_dict"])
    assert not any(is_block_norm(k) for k in arts["port"]["state_dict"])
    assert arts["port"]["cfg"]["dec_norm"] == "batch"
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


@pytest.mark.parametrize("which", ["jax", "port"])
def test_streams_and_eval_both_ways(artifacts, frame_dir, which, tmp_path,
                                    capsys):
    """Both packages' compress give the same report and stream bytes; each
    package's eval_quantized reads the artifact (no block norm: the norm
    at its init, in both) and its stream to the other's metrics."""
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
    assert {k: v for k, v in got.items() if k != "bitstream"} == \
        {k: v for k, v in want.items() if k != "bitstream"}
    with open(jout, "rb") as f, open(tout, "rb") as g:
        assert f.read() == g.read()
    argv = ["--artifact", art, "--data_path", frame_dir, "--data_split",
            "6_6_8"]
    _same_metrics(teval.main(argv + ["--device", "cpu"]), jeval.main(argv))
    _same_metrics(teval.main(argv + ["--from_bitstream", tout, "--device",
                                     "cpu"]),
                  jeval.main(argv + ["--from_bitstream", tout]))
