"""``calibrate_network --scope block|layer`` in the port, the counterpart of
``tests/test_pipeline.py::TestUnitScopeCLI``, on the 80x160 fixture: HNeRV
at block scope (stream cache) and at layer scope (shared cache, the
fisher_diag objective, QDrop), NeRV at block scope; each artifact read by
both packages' ``eval_quantized``; PNeRV refused as the JAX package
refuses it. Weights come from the JAX init, written by its ``save_pth``;
the port runs on the CPU.

Tolerances: the two packages' evaluations of one artifact, PSNR 1e-3 dB
and MS-SSIM 1e-5 (``test_torch_calibrate.py``'s)."""

import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.models import example_input as jax_example_input
from neuroquant_tpu_torch.methods import calibrate_network

BITS = ["4", "4", "4", "4", "4"]


@pytest.fixture(scope="module")
def ckpts(tiny_hnerv_cfg, tiny_nerv_cfg, tiny_pnerv_cfg, tmp_path_factory):
    """Per arch: (the JAX init's .pth, the config's yaml)."""
    from neuroquant_tpu.utils.torch_compat import save_pth

    d = tmp_path_factory.mktemp("unit_cli")
    out = {}
    for arch, cfg in (("hnerv", tiny_hnerv_cfg), ("nerv", tiny_nerv_cfg),
                      ("pnerv", tiny_pnerv_cfg)):
        jm = jax_build_model(arch, cfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(jax_example_input(arch, cfg,
                                                                2)))
        save_pth(str(d / f"{arch}.pth"), arch, params)
        with open(d / f"{arch}.yaml", "w") as f:
            yaml.safe_dump(dict(cfg), f)
        out[arch] = (str(d / f"{arch}.pth"), str(d / f"{arch}.yaml"))
    return out


def _run(arch, ckpts, frame_dir, outf, extra):
    ckpt, cfg_path = ckpts[arch]
    return calibrate_network.main([
        "--config", cfg_path, "--arch", arch, "--data_path", frame_dir,
        "--vid", "tiny", "--outf", outf, "--ckpt", ckpt, "--precision",
        *BITS, "--channel_wise", "--hadamard", "--batch_size", "2",
        "--iters_w", "40", "--b_start", "20", "--b_end", "2", "--warmup",
        "0.2", "--lr", "0.003", "--device", "cpu"] + extra)


def _both_evals_agree(out_path, frame_dir):
    from neuroquant_tpu.methods import eval_quantized as jax_eval
    from neuroquant_tpu_torch.methods import eval_quantized as port_eval

    argv = ["--artifact", out_path, "--data_path", frame_dir]
    want = jax_eval.main(argv)
    got = port_eval.main(argv + ["--device", "cpu"])
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-3 if i % 2 == 0 else 1e-5      # PSNR dB | MS-SSIM
        np.testing.assert_allclose(float(np.mean(g)), float(np.mean(w)),
                                   atol=tol, rtol=0)


def _check_run(out_path, state, spec, scope, prob, n_harvests):
    assert f"{scope}-wise_calib" in out_path
    assert os.path.basename(out_path) == (
        f"hnerv_W4.0_prob{prob}_max-init_CW.pth")
    with open(out_path, "rb") as f:
        art = pickle.load(f)
    assert art["mode"] == "adaround"
    assert len(art["int_codes"]) == len(spec.layer_names)
    # every unit got an AdaRound state, alpha present and finite
    for name in spec.layer_names:
        assert "w_alpha" in state[name], name
        assert bool(torch.isfinite(state[name]["w_alpha"]).all()), name
        assert art["int_codes"][name]["w"].dtype == np.int32
    logs = glob.glob(os.path.join(os.path.dirname(out_path), "*.log"))
    text = open(sorted(logs)[-1]).read()
    for u, name in enumerate(spec.layer_names):
        assert f"Reconstruction for {scope} {u} ({name})" in text
        assert f"[unit {u} {name}] iter 40/40 loss " in text
    assert text.count("Cached init time") == n_harvests
    for block in ("Full-precision model", "Close quantization model",
                  "Weight quantization model w/o opt",
                  "Weight quantization model w/ opt"):
        assert block in text, block
    return text


@pytest.mark.parametrize("scope,extra,prob", [
    ("block", [], "1.0"),
    ("layer", ["--opt_mode", "fisher_diag", "--input_prob", "0.5",
               "--unit_cache", "shared", "--fq_impl", "pallas"], "0.5"),
])
def test_unit_scope_runs(ckpts, frame_dir, tmp_path, monkeypatch, scope,
                         extra, prob):
    """The stream cache harvests once per unit, the shared one once; the
    artifact reads the same in both packages."""
    monkeypatch.chdir(tmp_path)
    out_path, state, spec = _run("hnerv", ckpts, frame_dir, f"t3{scope}",
                                 ["--scope", scope] + extra)
    out_path = str(tmp_path / out_path)
    text = _check_run(out_path, state, spec, scope, prob,
                      1 if "shared" in extra else len(spec.layer_names))
    if "fisher_diag" in extra:
        assert text.count("Cached grad time") == len(spec.layer_names)
    _both_evals_agree(out_path, frame_dir)


def test_nerv_block_scope_runs(ckpts, frame_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out_path, state, spec = _run("nerv", ckpts, frame_dir, "t3nerv",
                                 ["--scope", "block"])
    out_path = str(tmp_path / out_path)
    with open(out_path, "rb") as f:
        art = pickle.load(f)
    assert art["arch"] == "nerv" and art["embeddings"] is None
    assert "block-wise_calib" in out_path
    for name in spec.layer_names:
        assert bool(torch.isfinite(state[name]["w_alpha"]).all()), name
    _both_evals_agree(out_path, frame_dir)


def test_pnerv_is_refused(ckpts, frame_dir, tmp_path, monkeypatch):
    """The JAX package's message, after the evaluations, as there."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="NeRV/HNeRV decoder layout only"):
        _run("pnerv", ckpts, frame_dir, "t3pnerv",
             ["--scope", "layer", "--precision"] + ["4"] * 11)


@pytest.mark.parametrize("flags", [
    ["--scope", "block", "--mesh_devices", "2"],
    ["--scope", "layer", "--rounding", "nearest"],
    ["--scope", "network", "--input_prob", "0.5"],
    ["--scope", "network", "--opt_mode", "fisher_full"]])
def test_parse_args_refuses_what_jax_refuses(flags):
    with pytest.raises(SystemExit):
        calibrate_network.parse_args(["--config", "c.yaml", "--arch",
                                      "hnerv"] + flags)
