"""Each fault a cell can have, planted in the program under a whole run
on the CPU (the harness's look for a card skipped), turns ``correct``
false; the sound run of the same cell reads true."""

import pytest

from nqbench.tests import cells, tiny

FAULTS = [("tiny-hnerv.decode-b1", "answer"),
          ("tiny-nerv.decode-b1", "answer"),
          ("tiny-hnerv.calib-b2", "frozen"),
          ("tiny-hnerv.calib-b2", "half_batch"),
          ("tiny-hnerv.train-b1", "frozen")]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.tree(str(tmp_path_factory.mktemp("nq")), cells.cells())


@pytest.mark.parametrize("workload", sorted(cells.cells()))
def test_sound_run_is_correct(tree, workload):
    r = tiny.rehearse(tree, workload, seed=2147483659, seconds=1.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    names = [m for m in r["metrics"]]
    assert "setup_s" in names and len(names) >= 2
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f}" for w, f in FAULTS])
def test_fault_is_caught(tree, workload, fault):
    r = tiny.rehearse(tree, workload, seed=11, seconds=1.0, fault=fault)
    assert not r["correct"], r["checks"]
