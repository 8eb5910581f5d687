"""Stage 2's search and the Hessian tool on PNeRV1 in the port against the
JAX package, on the 80x160 fixture with the tiny PNeRV1, from a
JAX-written checkpoint: ``bit_assign --search lagrangian`` with and
without ``--remat`` (the port's HVP on the fused tail's forward-mode
kernels, checkpointed layer by layer with ``--remat``; the JAX package on
its plain execution, ``jax.checkpoint`` with ``--remat``) and
``hessian_eigen`` on both of the port's routes. The port runs on the CPU
(its kernels' plain versions) and is given the JAX package's batches
(PNeRV's BatchNorm ties a frame's decode to its batch).

Tolerances: the uniform-bit curves 1e-3 of each curve's largest layer
score (stage 2's, ``test_torch_pnerv_cli.py``); the proposals and the
winner exactly; the extremal eigenvalues 1e-3 relative
(``test_torch_bit_assign.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu_torch.quantization import sensitivity as tsens

SEED = 903


@pytest.fixture(scope="module")
def setup(tiny_pnerv_cfg, frame_dir, tmp_path_factory):
    """The JAX init's PNeRV1 weights as a JAX-written .pth, the config as
    yaml and a run directory."""
    from neuroquant_tpu.utils.torch_compat import save_pth

    cfg = dict(tiny_pnerv_cfg)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    d = tmp_path_factory.mktemp("pnerv_stage2")
    jm = jax_build_model("pnerv", cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(frames[:1]))
    save_pth(str(d / "ck.pth"), "pnerv", params)
    with open(d / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return dict(dir=d)


def _curves(monkeypatch, module):
    """The per-layer scores of every criterion call of a bit_assign run."""
    seen = []
    orig = module.sensitivity_criterion

    def criterion(*a, **k):
        total, per_layer = orig(*a, **k)
        seen.append(per_layer)
        return total, per_layer

    monkeypatch.setattr(module, "sensitivity_criterion", criterion)
    return seen


@pytest.mark.parametrize("remat", [False, True])
def test_lagrangian_search_matches_jax(setup, frame_dir, monkeypatch, remat):
    from neuroquant_tpu.methods import bit_assign as jba
    from neuroquant_tpu_torch.methods import bit_assign

    monkeypatch.chdir(setup["dir"])
    perm = np.array(jax.random.permutation(jax.random.PRNGKey(SEED), 8))
    monkeypatch.setattr(tsens, "draw_batches", lambda n, bs, seed:
                        torch.from_numpy(perm[:n // bs * bs].reshape(-1, bs)))
    argv = ["--config", "tiny.yaml", "--arch", "pnerv", "--data_path",
            frame_dir, "--vid", "tiny", "--ckpt", "ck.pth", "--batch_size",
            "2", "--channel_wise", "--init", "max", "--mode", "omega",
            "--search", "lagrangian", "--target_avg_bits", "4.5",
            "--bit_range", "3", "5"] + (["--remat"] if remat else [])
    jseen = _curves(monkeypatch, jba)
    want = jba.main(argv + ["--outf", f"sj{int(remat)}"])
    tseen = _curves(monkeypatch, bit_assign)
    got = bit_assign.main(argv + ["--outf", f"st{int(remat)}", "--hvp_impl",
                                  "pallas", "--device", "cpu"])
    assert len(tseen) == len(jseen) >= 4
    for g, w in zip(tseen, jseen):
        scale = max(abs(v) for v in w)
        assert scale > 0
        np.testing.assert_allclose(g, w, atol=1e-3 * scale, rtol=0)
    assert got[:2] == want[:2]
    assert all(3 <= b <= 5 for b in got[1]) and np.isfinite(got[2])


@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_hessian_eigen_matches_jax(setup, frame_dir, route):
    """The extremal eigenvalues on a batch of two, the JAX tool on its CPU
    execution (the plain decode), the port on the kernels' forward-mode
    tail and on its plain decode."""
    from neuroquant_tpu.analysis import hessian_eigen as jax_tool
    from neuroquant_tpu_torch.analysis import hessian_eigen

    d = setup["dir"]
    args = ["--config", str(d / "tiny.yaml"), "--arch", "pnerv", "--ckpt",
            str(d / "ck.pth"), "--data_path", frame_dir, "--batch", "2",
            "--tol", "1e-2"]
    want = jax_tool.main(args + ["--out", str(d / "jax_hess")])
    got = hessian_eigen.main(args + ["--out", str(d / f"hess_{route}"),
                                     "--hvp_impl", route, "--device", "cpu"])
    assert np.isfinite(want).all() and want[0] > 0
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-3)
