"""The serving slice as a whole: one quantized artifact written the way the
JAX ``calibrate_network`` writes it, evaluated by the JAX
``eval_quantized.main`` and by the port's on the CPU, on the fixture frames.
PSNR must agree to 1e-3 dB and MS-SSIM to 1e-5 (the 80x160 fixture frames
are below MS-SSIM's minimum size, so both score 0 there). The same from an
``NQTB`` stream of the artifact's codes."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.methods import eval_quantized as jax_eval
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.quantization import qmodel as jqm
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu.utils.torch_compat import params_to_state_dict
from neuroquant_tpu_torch.methods import eval_quantized as port_eval


def _artifact(cfg, mode, path):
    model = jax_build_model("hnerv", cfg)
    params = model.init(jax.random.PRNGKey(7), jnp.zeros((1, 80, 160, 3)))
    spec = jax_make_spec("hnerv", cfg, hadamard=True).with_bits(
        (6, 5, 4, 5, 6))
    state = jqm.init_quant_state(params, spec)
    if mode == "mixed":
        state = jqm.adaround_upgrade(params, spec, state,
                                     only=spec.layer_names[1:3])
    artifact = {
        "arch": "hnerv", "mode": "adaround" if mode == "mixed" else "uaq",
        "cfg": cfg, "state_dict": params_to_state_dict("hnerv", params),
        "quant_spec": {
            "layer_names": spec.layer_names, "layer_paths": spec.layer_paths,
            "n_bits": spec.n_bits, "channel_wise": spec.channel_wise,
            "scale_method": spec.scale_method, "hadamard": spec.hadamard,
            "sym": spec.sym},
        "quant_state": jax.tree_util.tree_map(np.asarray, state),
    }
    with open(path, "wb") as f:
        pickle.dump(artifact, f)


@pytest.mark.parametrize("mode", ["uaq", "mixed"])
def test_port_matches_jax(tiny_hnerv_cfg, frame_dir, tmp_path, mode):
    path = str(tmp_path / "artifact.pth")
    _artifact(dict(tiny_hnerv_cfg), mode, path)
    argv = ["--artifact", path, "--data_path", frame_dir,
            "--data_split", "6_6_8"]
    want = jax_eval.main(argv)
    got = port_eval.main(argv + ["--device", "cpu"])
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-3 if i % 2 == 0 else 1e-5      # PSNR dB | MS-SSIM
        np.testing.assert_allclose(float(np.mean(g)), float(np.mean(w)),
                                   atol=tol, rtol=0)
    assert 10.0 < float(got[0]) < 60.0 and np.isfinite(float(got[2]))


def test_from_bitstream_is_not_ported(tiny_hnerv_cfg, frame_dir, tmp_path):
    """--from_bitstream (ROADMAP queue A item 7) is ported: a mixed-rounding
    artifact's stream, written by the JAX codec, evaluates as in JAX."""
    from neuroquant_tpu.coding import compress_artifact

    path, stream = str(tmp_path / "artifact.pth"), str(tmp_path / "a.nqtb")
    cfg = dict(tiny_hnerv_cfg)
    _artifact(cfg, "mixed", path)
    with open(path, "rb") as f:
        artifact = pickle.load(f)
    model = jax_build_model("hnerv", cfg)
    params = model.init(jax.random.PRNGKey(7), jnp.zeros((1, 80, 160, 3)))
    spec = jax_eval.spec_from_artifact(artifact)
    artifact["int_codes"] = jax.tree_util.tree_map(
        np.asarray, jqm.collect_int_codes(
            params, spec, jax.tree_util.tree_map(
                jnp.asarray, artifact["quant_state"]), mode="adaround"))
    with open(path, "wb") as f:
        pickle.dump(artifact, f)
    with open(stream, "wb") as f:
        f.write(compress_artifact(artifact["int_codes"]))
    argv = ["--artifact", path, "--data_path", frame_dir, "--data_split",
            "6_6_8", "--from_bitstream", stream]
    want = jax_eval.main(argv)
    got = port_eval.main(argv + ["--device", "cpu"])
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-3 if i % 2 == 0 else 1e-5      # PSNR dB | MS-SSIM
        np.testing.assert_allclose(float(np.mean(g)), float(np.mean(w)),
                                   atol=tol, rtol=0)
