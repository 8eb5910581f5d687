"""Stage 2's command lines in the port against the JAX package's, on the
80x160 fixture with the tiny HNeRV, from a JAX-written checkpoint:
``bit_assign.main`` on both modes and both --hvp_impl, ``--search
lagrangian``, the unported archs, ``lagrangian_candidates`` and
``hessian_eigen``. The port runs on the CPU (its kernels' plain versions);
the JAX package as its tests run it on the CPU. The criterion's numbers are
held against the JAX package in test_torch_sensitivity.py; here the
choices: the same best candidate, the same proposals bit for bit, the
extremal eigenvalues within 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model


@pytest.fixture(scope="module")
def ckpt(tiny_hnerv_cfg, frame_dir, tmp_path_factory):
    """A JAX-written .pth of the JAX init's weights, the config as yaml,
    and a run directory."""
    import yaml

    from neuroquant_tpu.utils.torch_compat import save_pth

    cfg = dict(tiny_hnerv_cfg)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    jm = jax_build_model("hnerv", cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(frames[:1]))
    d = tmp_path_factory.mktemp("stage2")
    pth, cfg_path = str(d / "ck.pth"), str(d / "tiny.yaml")
    save_pth(pth, "hnerv", params)
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return pth, cfg_path, d


def _assign_args(ckpt, frame_dir, mode, outf):
    pth, cfg_path, _ = ckpt
    return ["--config", cfg_path, "--arch", "hnerv", "--data_path",
            frame_dir, "--vid", "tiny", "--outf", outf, "--ckpt", pth,
            "--batch_size", "2", "--channel_wise", "--init", "max",
            "--mode", mode, "--candidates", "2,2,2,2,2;6,6,6,6,6"]


@pytest.fixture(scope="module")
def assign_jax(ckpt, frame_dir):
    """The JAX bit_assign's choice per mode on its default --hvp_impl xla
    (its pallas_hvp scores are held against the port's in
    test_torch_sensitivity.py; its fisher_diag takes the same execution on
    the CPU either way)."""
    from neuroquant_tpu.methods import bit_assign as jba

    mp = pytest.MonkeyPatch()
    mp.chdir(ckpt[2])
    try:
        return {mode: jba.main(_assign_args(ckpt, frame_dir, mode,
                                            f"j_{mode}"))
                for mode in ("omega", "fisher_diag")}
    finally:
        mp.undo()


@pytest.mark.parametrize("hvp_impl", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["omega", "fisher_diag"])
def test_bit_assign_main_matches_jax(ckpt, frame_dir, assign_jax, mode,
                                     hvp_impl, monkeypatch):
    import glob

    from neuroquant_tpu_torch.methods import bit_assign

    monkeypatch.chdir(ckpt[2])
    outf = f"t_{mode}_{hvp_impl}"
    cand, bits, score = bit_assign.main(
        _assign_args(ckpt, frame_dir, mode, outf)
        + ["--hvp_impl", hvp_impl, "--device", "cpu"])
    jcand, jbits, _ = assign_jax[mode]
    assert (cand, bits) == (jcand, jbits) == ("candidate2", [6] * 5)
    assert np.isfinite(score) and score > 0
    (log,) = glob.glob(str(ckpt[2] / "results" / outf / "**" / "*.log"),
                       recursive=True)
    with open(log) as f:
        text = f.read()
    assert "Best Candidate: candidate2" in text
    assert f"The {mode} sensitivity score =" in text
    assert "[4-th layer]" in text


def test_lagrangian_candidates_match_jax():
    """The same proposals from the same curves, bit for bit."""
    from neuroquant_tpu.methods.bit_assign import (
        lagrangian_candidates as jax_lc)
    from neuroquant_tpu_torch.methods.bit_assign import lagrangian_candidates

    rng = np.random.RandomState(4)
    bits = list(range(2, 9))
    cases = [({b: [1e-6 * (8 - b), 1e-1 * (8 - b) ** 2] for b in bits},
              [1000, 1000], 5.0),
             ({b: list(rng.rand(7) * (9 - b) ** 2) for b in bits},
              [192, 6800, 25000, 85000, 17000, 12000, 1000], 4.5),
             ({b: list(rng.rand(5)) for b in bits}, [10, 20, 30, 40, 50],
              1.0)]
    for curves, p_l, target in cases:
        assert (lagrangian_candidates(curves, p_l, bits, target)
                == jax_lc(curves, p_l, bits, target))


def test_bit_assign_search_runs(ckpt, frame_dir, monkeypatch):
    """--search lagrangian: uniform-bit curves, proposals under the budget,
    each re-scored; the winner within the bit range."""
    from neuroquant_tpu_torch.methods import bit_assign

    monkeypatch.chdir(ckpt[2])
    _, bits, score = bit_assign.main(
        _assign_args(ckpt, frame_dir, "omega", "t_search")[:-2]
        + ["--search", "lagrangian", "--target_avg_bits", "4.5",
           "--bit_range", "3", "5", "--device", "cpu"])
    assert len(bits) == 5 and all(3 <= b <= 5 for b in bits)
    assert np.isfinite(score)


@pytest.mark.parametrize("arch,n", [("pnerv2", 9), ("pnerv1", 11)])
def test_bit_assign_runs_the_pnerv_archs(arch, n, tiny_pnerv_cfg, frame_dir,
                                        tmp_path, monkeypatch):
    """bit_assign --arch pnerv1 and pnerv2 on a port-written checkpoint:
    fisher_diag over two uniform allocations, the finer one winning; no
    default candidates for PNeRV (the JAX package's ValueError)."""
    import yaml

    from neuroquant_tpu_torch.methods import bit_assign
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.utils.convert import save_pth

    monkeypatch.chdir(tmp_path)
    with open("tiny.yaml", "w") as f:
        yaml.safe_dump(tiny_pnerv_cfg, f)
    save_pth("ck.pth", build_model(arch, tiny_pnerv_cfg, device="cpu"))
    argv = ["--config", "tiny.yaml", "--arch", arch, "--data_path",
            frame_dir, "--vid", "tiny", "--outf", "b", "--ckpt", "ck.pth",
            "--batch_size", "2", "--channel_wise", "--mode", "fisher_diag",
            "--device", "cpu"]
    lo, hi = ",".join(["2"] * n), ",".join(["6"] * n)
    best, bits, score = bit_assign.main(argv + ["--candidates",
                                                f"{lo};{hi}"])
    assert (best, bits) == ("candidate2", [6] * n) and np.isfinite(score)
    with pytest.raises(ValueError, match="no default candidates"):
        bit_assign.main(argv)


def test_hessian_eigen_matches_jax(ckpt, frame_dir):
    """The extremal eigenvalues on one frame, both tools on their 'auto'
    execution, the plain one on the CPU; 1e-3 relative (eigsh's tolerance
    1e-2 bounds the Ritz vectors, the Ritz values converge
    quadratically)."""
    from neuroquant_tpu.analysis import hessian_eigen as jax_tool
    from neuroquant_tpu_torch.analysis import hessian_eigen

    pth, cfg_path, d = ckpt
    args = ["--config", cfg_path, "--arch", "hnerv", "--ckpt", pth,
            "--data_path", frame_dir, "--batch", "1", "--tol", "1e-2"]
    want = jax_tool.main(args + ["--out", str(d / "jax_hess")])
    got = hessian_eigen.main(args + ["--out", str(d / "hess"), "--device",
                                     "cpu"])
    assert want[0] > 0 > want[1]
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-3)
