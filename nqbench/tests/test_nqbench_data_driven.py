"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files and new ``BENCHMARK.json`` entries only, no file of the harness
edited: the harness finds them and runs the cell on the CPU rehearsal
path, and reports the new metric."""

import json
import os

from nqbench.tests import tiny


def test_new_files_only(tmp_path):
    tmp = str(tmp_path)
    before = {}
    tiny.tree(tmp, {})
    for d, _, names in os.walk(os.path.join(tmp, "nqbench")):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                before[os.path.join(d, n)] = f.read()
    # the additions: a configuration, a traffic mix, limits, a reader
    tiny.write(os.path.join(tmp, "nqbench", "configs", "tiny-nerv.json"),
               tiny.CONFIGS["tiny-nerv"])
    tiny.write(os.path.join(tmp, "nqbench", "traffic", "tiny-mix.json"),
               {"driver": "decode", "n_frames": 6, "batch": 3})
    tiny.write(os.path.join(tmp, "nqbench", "limits", "tiny-nerv.mix.json"),
               {"decode_gap": 1e-4})
    with open(os.path.join(tmp, "nqbench", "metrics", "calls.py"),
              "w") as f:
        f.write('"""Decode calls in the traced window."""\n\n\n'
                'def read(name, ctx):\n    return float(ctx["steps"])\n')
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-nerv", "source": "tests",
                             "file": "nqbench/configs/tiny-nerv.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny-nerv.mix", "config": "tiny-nerv",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "tiny"})
    bench["per_layer"].append({"name": "calls", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter", "layer": "model",
                               "moves": "decode_fps",
                               "workloads": ["tiny-nerv.mix"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("decode_fps", "decode_call_p95_ms"):
            m["workloads"].append("tiny-nerv.mix")
    with open(path, "w") as f:
        json.dump(bench, f)
    r = tiny.rehearse(tmp, "tiny-nerv.mix", seconds=0.5)
    assert r["correct"] and r["attempted"] % 3 == 0
    assert set(r["metrics"]) == {"setup_s", "decode_fps"}
    r = tiny.rehearse(tmp, "tiny-nerv.mix", seconds=0.5, trace=1)
    assert r["metrics"] == {"calls": {"value": r["window"]["traced_steps"],
                                      "unit": "calls"}}
    assert r["attempted"] == 3 * (r["window"]["steps"]
                                  + r["window"]["traced_steps"])
    for p, data in before.items():
        with open(p, "rb") as f:
            assert f.read() == data, p
