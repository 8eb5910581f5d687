"""What the harness runs imports neither JAX nor the JAX package nor the
JAX-side benchmarks; the reference imports nothing of the program; module
names are compared by their whole top-level name; the command refuses to
start without a card, and without the program beside it."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from nqbench import core

NQ = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(NQ)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "neuroquant_tpu", "bench"}


def _files(top):
    for d, _, names in os.walk(top):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(module):
    return module.split(".")[0]


def test_top_level_names_compared_whole():
    assert _top("neuroquant_tpu_torch.ops") not in FORBIDDEN
    assert _top("neuroquant_tpu.ops") in FORBIDDEN
    assert _top("jax.numpy") in FORBIDDEN and _top("jaxtyping") not in FORBIDDEN
    assert "neuroquant_tpu_torch" not in core.FORBIDDEN


def test_harness_imports_no_jax_side():
    files = list(_files(NQ))
    assert len(files) > 15
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imports(p) if _top(m) in FORBIDDEN
           or m == "neuroquant_tpu_torch.bench"]
    assert bad == []


def test_reference_imports_no_program():
    files = list(_files(os.path.join(NQ, "reference")))
    assert files
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imports(p) if _top(m) == "neuroquant_tpu_torch"]
    assert bad == []


def test_run_loads_no_jax_side():
    """Importing every module the harness runs, the program's entry points
    with them, loads no JAX and no JAX package."""
    code = ("import sys, nqbench.run, nqbench.control, nqbench.program\n"
            "from nqbench import core\n"
            "for kind in ('drivers', 'work', 'reference', 'metrics'):\n"
            "    import os\n"
            "    for f in os.listdir(os.path.join(core.HERE, kind)):\n"
            "        if f.endswith('.py') and f != '__init__.py':\n"
            "            core.module(kind, f[:-3])\n"
            "import neuroquant_tpu_torch.quantization.calibrate\n"
            "import neuroquant_tpu_torch.methods.regress\n"
            "print(core.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _command(cwd, env=None):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cmd = json.load(f)["command"]
    return subprocess.run(
        [sys.executable] + cmd[1:] + [
            "--workload", "hnerv-bunny3m.decode-b1", "--seed", "2147483659",
            "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def test_refuses_without_card():
    out = _command(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_refuses_without_program(tmp_path):
    shutil.copytree(NQ, tmp_path / "nqbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = _command(str(tmp_path), {"PYTHONPATH": "",
                                   "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
def test_refuses_without_program_on_card(card, tmp_path):
    shutil.copytree(NQ, tmp_path / "nqbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = _command(str(tmp_path), {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
