"""The port stands alone: nothing under neuroquant_tpu_torch/ and nothing in
chip_smoke.py imports JAX or the JAX package; the package imports with JAX
unavailable; entry points refuse to run without a GPU unless the caller
asks for the CPU; chip_smoke.py fails without a card and alone."""

import ast
import os
import subprocess
import sys

import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "neuroquant_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "neuroquant_tpu"}


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    # exact top-level match: 'neuroquant_tpu_torch' is not 'neuroquant_tpu'
    return module.split(".")[0] in FORBIDDEN


def test_no_forbidden_imports():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_modules(p) if _forbidden(m)]
    assert bad == []


def test_forbidden_matcher():
    assert _forbidden("neuroquant_tpu") and _forbidden("neuroquant_tpu.ops")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("neuroquant_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_imports_with_jax_unavailable():
    mods = []
    for p in _port_files():
        m = os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        mods.append(m[:-len(".__init__")] if m.endswith(".__init__") else m)
    code = ("import importlib, sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'neuroquant_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_entry_points_need_a_gpu_unless_asked(monkeypatch, tiny_hnerv_cfg,
                                              frame_dir, tmp_path):
    from neuroquant_tpu_torch.analysis import hessian_eigen
    from neuroquant_tpu_torch.data import VideoDataSet
    from neuroquant_tpu_torch.methods import (
        bit_assign, eval_quantized, regress)
    from neuroquant_tpu_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("hnerv", tiny_hnerv_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoDataSet(tiny_hnerv_cfg, frame_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_quantized.main(["--artifact", "missing.pth",
                             "--data_path", frame_dir])
    cfg_path = str(tmp_path / "tiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(tiny_hnerv_cfg, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bit_assign.main(["--config", cfg_path, "--arch", "hnerv",
                         "--data_path", frame_dir, "--ckpt", "missing.pth",
                         "--outf", str(tmp_path / "t2")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hessian_eigen.main(["--config", cfg_path, "--arch", "hnerv",
                            "--ckpt", "missing.pth", "--data_path",
                            frame_dir])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        regress.main(["--config", cfg_path, "--arch", "hnerv",
                      "--data_path", frame_dir, "--outf",
                      str(tmp_path / "t1")])
    model = build_model("hnerv", tiny_hnerv_cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    """In the repository and without a card it stops at its card check;
    copied alone it stops at importing the port, before that check, so it
    fails there with a card too."""
    src = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if alone:
        with open(src) as f, open(tmp_path / "chip_smoke.py", "w") as g:
            g.write(f.read())
        cwd = str(tmp_path)
        path = [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                if p and os.path.abspath(p) != ROOT]
        env["PYTHONPATH"] = os.pathsep.join(path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    if alone:
        assert "No module named 'neuroquant_tpu_torch'" in r.stderr, r.stderr
        assert "no CUDA device" not in r.stderr
    else:
        assert r.returncode == 2 and "no CUDA device" in r.stderr, r.stderr
