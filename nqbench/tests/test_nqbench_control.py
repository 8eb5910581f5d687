"""The control, the plain reference in TF32 (the nearest precision below
the configurations' float32) in the program's place, reads worse than the
program on at least one number of every cell, at a tiny size on the CPU.
At the cells' own size on the card the readings come from
``python3 -m nqbench.control``; the test marked ``card`` runs it there."""

import json
import os
import subprocess
import sys

import pytest

from nqbench.tests import cells, tiny


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.tree(str(tmp_path_factory.mktemp("nq")), cells.cells())


@pytest.mark.parametrize("workload", sorted(cells.cells()))
def test_control_reads_worse(tree, workload):
    r = tiny.rehearse(tree, workload, seed=7, seconds=1.0, control=True)
    prog, ctrl = r["program"], r["control"]
    assert any(ctrl[k] > 3 * max(prog[k], 1e-12) for k in prog), r


@pytest.mark.card
@pytest.mark.parametrize("workload", ["hnerv-bunny3m.decode-b1",
                                      "nerv-bunny3m.decode-b1",
                                      "hnerv-bunny3m.calib-b2",
                                      "hnerv-bunny3m.train-b1"])
def test_control_fails_on_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "nqbench.control", "--workload", workload,
         "--seeds", "101", "102", "103", "--seconds", "1"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(os.path.join(tiny.NQ, "limits", workload + ".json")) as f:
        limits = json.load(f)
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert any(v > limits[k] for k, v in r["control"].items()), r
