"""Tiny counterparts of the benchmark's cells for the CPU tests: each
workload's traffic at 8 frames, on the tiny configurations, with the
full-size cell's own limits."""

import json
import os

from nqbench.tests import tiny

N = 8
LIMITS = os.path.join(tiny.NQ, "limits")


def _limits(workload):
    with open(os.path.join(LIMITS, workload + ".json")) as f:
        return json.load(f)


def _traffic(name, **over):
    with open(os.path.join(tiny.NQ, "traffic", name + ".json")) as f:
        t = json.load(f)
    return dict(t, n_frames=N, **over)


def cells():
    """{tiny workload: (config, traffic name, traffic, limits)}."""
    return {
        "tiny-hnerv.decode-b1": ("tiny-hnerv", "tiny-decode-b1",
                                 _traffic("decode-b1"),
                                 _limits("hnerv-bunny3m.decode-b1")),
        "tiny-nerv.decode-b1": ("tiny-nerv", "tiny-decode-b1",
                                _traffic("decode-b1"),
                                _limits("nerv-bunny3m.decode-b1")),
        "tiny-hnerv.calib-b2": ("tiny-hnerv", "tiny-calib-b2",
                                _traffic("calib-b2", iters=400,
                                         precision=[6, 5, 4, 5, 6]),
                                _limits("hnerv-bunny3m.calib-b2")),
        "tiny-hnerv.train-b1": ("tiny-hnerv", "tiny-train-b1",
                                _traffic("train-b1"),
                                _limits("hnerv-bunny3m.train-b1")),
    }
