"""A tiny copy of the benchmark for CPU tests: the harness copied beside
its own ``BENCHMARK.json`` into a directory, tiny configurations, traffic
mixes and limits added there as new files, and a run of one of its cells
on the CPU (the rehearsal path: the real command refuses to start without
a card), in a process of its own, optionally with a fault planted in the
program first."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

NQ = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(NQ)

TINY_HNERV = dict(
    crop_h=80, crop_w=160, diff_enc=False, stage_block=1,
    enc_strides=[5, 4, 4], enc_channel=[16, 16, 8], channel_reduce=1.2,
    channel_lbound=4, dec_in_channel=24, dec_kernels=[1, 3, 3],
    dec_strides=[5, 4, 4], dec_norm="none", dec_acts="gelu",
    out_bias="tanh", loss="l2", epoch=4, workers=0, eval_freq=2,
    batch_size=1, learning_rate=0.002)
TINY_NERV = dict(
    crop_h=80, crop_w=160, diff_enc=False, base=1.25, level=16,
    channel_reduce=2, channel_lbound=6, dec_in_channel=32,
    dec_kernels=[3, 3, 3], dec_strides=[5, 4, 4], dec_norm="none",
    dec_acts="gelu", out_bias="tanh", loss="l2", epoch=4, workers=0,
    eval_freq=2, batch_size=1, learning_rate=0.002)
# PNeRV at the same geometry: the (1, 2) embedding, x10 in the excitation
# block to the KFc grid (10, 20), kfc_strides [2, 2, 2] up to 80x160
TINY_PNERV = dict(
    crop_h=80, crop_w=160, diff_enc=False, enc_channel=12, emd_channel=8,
    enc_strides=[5, 4, 4], kfc_h_w_c=[10, 20, 10], kfc_strides=[2, 2, 2],
    dec_norm="none", dec_acts="gelu", loss="l2", epoch=2, workers=0,
    eval_freq=2, batch_size=2, learning_rate=0.002)
CONFIGS = {
    "tiny-hnerv": dict(TINY_HNERV, arch="hnerv",
                       classes=["HNeRV", "HNeRVConfig"], reduced=[],
                       source="tests"),
    "tiny-nerv": dict(TINY_NERV, arch="nerv", classes=["NeRV", "NeRVConfig"],
                      reduced=[], source="tests"),
    "tiny-pnerv1": dict(TINY_PNERV, arch="pnerv1",
                        classes=["PNeRV1", "PNeRVConfig"], reduced=[],
                        source="tests"),
    "tiny-pnerv2": dict(TINY_PNERV, arch="pnerv2",
                        classes=["PNeRV2", "PNeRVConfig"], reduced=[],
                        source="tests"),
}


def write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def tree(tmp, cells):
    """A copy of the harness in `tmp`, with `cells` added as new files and
    entries: {workload: (config, traffic name, traffic dict, limits)}."""
    shutil.copytree(NQ, os.path.join(tmp, "nqbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, (conf, tname, traffic, limits) in cells.items():
        cfile = f"nqbench/configs/{conf}.json"
        if not os.path.exists(os.path.join(tmp, cfile)):
            write(os.path.join(tmp, cfile), CONFIGS[conf])
            bench["configs"].append({"name": conf, "source": "tests",
                                     "file": cfile, "reduced": [],
                                     "why": "tiny"})
        tfile = os.path.join(tmp, "nqbench", "traffic", tname + ".json")
        if not os.path.exists(tfile):
            write(tfile, traffic)
        write(os.path.join(tmp, "nqbench", "limits", name + ".json"), limits)
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": tname, "chips": 1,
                                   "why": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(name)
    write(os.path.join(tmp, "BENCHMARK.json"), bench)
    return tmp


def rehearse(tmp, workload, seed=5, seconds=1.0, trace=0, fault=None,
             control=False, timeout=600):
    """Run `workload` of the tree in `tmp` on the CPU in a new process:
    the result dict, or with `control` the readings of
    ``nqbench.control``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([tmp, REPO]),
               OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-m", "nqbench.tests.rehearse", workload, str(seed),
         str(seconds), str(trace), fault or "none",
         "control" if control else "run"],
        cwd=tmp, env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])
