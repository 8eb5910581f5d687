"""The readers of the program's spans (``metrics/span_idle_pct.py``,
``metrics/span_launches_per_step.py``, ``span_split.py``) on hand-built
card intervals, runtime calls and spans with known gaps and launches:
each instant to the child of the root open then, a grandchild's to its
child, a gap outside every child to none; None where there is nothing to
read."""

import pytest

from neuroquant_tpu_torch.utils import profiling
from neuroquant_tpu_torch.utils.profiling import Span
from nqbench import core, span_split

US = 1000       # the example's times are in µs, the trace's in ns
MAIN, AUTOGRAD = 11, 12
RECORDED = span_split._recorded


def _span(name, start, end, sid, parent, step, thread=MAIN):
    return Span(name, start * US, end * US, sid, parent, step, thread)


# two training steps; in the first a tail inside forward, and one on
# autograd's thread inside backward; the second a step of two children
STEPS = [
    _span("step", 0, 100, 1, None, 1),
    _span("fakequant", 0, 20, 2, 1, 1),
    _span("forward", 20, 60, 3, 1, 1),
    _span("tail", 30, 50, 4, 3, 1),
    _span("loss", 60, 70, 5, 1, 1),
    _span("backward", 70, 95, 6, 1, 1),
    _span("tail", 75, 90, 7, 6, 1, AUTOGRAD),
    _span("optim", 95, 100, 8, 1, 1),
    _span("step", 150, 200, 9, None, 9),
    _span("forward", 150, 180, 10, 9, 9),
    _span("optim", 180, 200, 11, 9, 9),
]
# busy: [0,5] [10,25] [35,40] [45,65] [80,85] [98,120] [130,140] [160,190]
DEVICE = [(0, 5), (10, 25), (35, 40), (45, 65), (80, 85), (98, 120),
          (130, 140), (160, 190)]
# gaps: [5,10] fakequant; [25,35] forward (30-35 in its tail); [40,45]
# forward; [65,80] loss 5, backward 10; [85,98] backward 10, optim 3;
# [120,130] between the steps: none; [140,160] none 10, the second step's
# forward 10; [190,200] the window's edge, no gap
IDLE_US = {"fakequant": 5, "forward": 25, "loss": 5, "backward": 20,
           "optim": 3}
# kernel launch calls by their start; a copy and a sync are no launch
HOST = [("cudaLaunchKernel", 1), ("cudaLaunchKernel", 21),
        ("cudaLaunchKernel", 31), ("cudaMemcpyAsync", 22),
        ("cuLaunchKernel", 61), ("cudaLaunchKernelExC", 71),
        ("cudaLaunchKernel", 76), ("cudaLaunchKernel", 96),
        ("cudaLaunchKernel", 110), ("cudaDeviceSynchronize", 140),
        ("cudaLaunchKernel", 155), ("cudaLaunchKernel", 181)]
LAUNCHES = {"fakequant": 1, "forward": 3, "loss": 1, "backward": 2,
            "optim": 2}
WINDOW_US = 200


def _ctx(kind="train", device=DEVICE, host=HOST):
    trace = core.Trace(False)
    trace.device_events = [("k", s * US, e * US, True) for s, e in device]
    trace.host_events = [(n, s * US, s * US + US // 2) for n, s in host]
    return {"kind": kind, "steps": 2, "window_s": WINDOW_US * 1e-6,
            "trace": trace}


def _read(metric, name, ctx):
    return core.module("metrics", metric).read(name, ctx)


@pytest.fixture
def recorded(monkeypatch):
    def use(rows):
        monkeypatch.setattr(span_split, "_recorded", lambda: list(rows))
    use(STEPS)
    return use


@pytest.mark.parametrize("layer", sorted(IDLE_US))
def test_each_instant_to_the_child_of_its_root(recorded, layer):
    ctx = _ctx()
    idle = _read("span_idle_pct", f"span_idle_pct.train.{layer}", ctx)
    assert idle == pytest.approx(100.0 * IDLE_US[layer] / WINDOW_US)
    n = _read("span_launches_per_step",
              f"span_launches_per_step.train.{layer}", ctx)
    assert n == LAUNCHES[layer] / 2


def test_gaps_outside_every_child_left_out(recorded):
    ctx = _ctx()
    total = sum(_read("span_idle_pct", f"span_idle_pct.train.{k}", ctx)
                for k in IDLE_US)
    device = _read("device_idle_pct", "device_idle_pct.train", ctx)
    # [120,130] and [140,150] between the steps, [190,200] at the edge
    assert device - total == pytest.approx(100.0 * (10 + 10 + 10)
                                           / WINDOW_US)
    launched = sum(_read("span_launches_per_step",
                         f"span_launches_per_step.train.{k}", ctx)
                   for k in LAUNCHES)
    assert launched == (sum(n.startswith(span_split.LAUNCH)
                            for n, _ in HOST) - 1) / 2


def test_decode_roots_and_their_regime(recorded):
    recorded([_span("decode", 0, 60, 1, None, 1),
              _span("prefix", 0, 20, 2, 1, 1),
              _span("tail", 20, 60, 3, 1, 1)])
    ctx = _ctx(kind="decode")
    assert _read("span_idle_pct", "span_idle_pct.decode.host_paced.tail",
                 ctx) == pytest.approx(100.0 * 15 / WINDOW_US)
    assert _read("span_launches_per_step",
                 "span_launches_per_step.decode.host_paced.prefix",
                 ctx) == 1 / 2
    # a training step's spans are no decode call's
    assert _read("span_idle_pct", "span_idle_pct.train.forward", ctx) is None


@pytest.mark.parametrize("case", ["no spans", "no device events",
                                  "no recorder", "no such layer",
                                  "another kind"])
def test_nothing_to_read(recorded, monkeypatch, case):
    ctx = _ctx()
    name = "span_idle_pct.train.forward"
    if case == "no spans":
        recorded([])
    elif case == "no device events":
        ctx = _ctx(device=[])
    elif case == "no recorder":      # a program from before the spans
        monkeypatch.delattr(profiling, "spans")
        monkeypatch.setattr(span_split, "_recorded", RECORDED)
    elif case == "no such layer":
        name = "span_idle_pct.train.prefix"
    else:
        ctx = _ctx(kind="calib")
    assert _read("span_idle_pct", name, ctx) is None
    assert _read("span_launches_per_step",
                 name.replace("span_idle_pct", "span_launches_per_step"),
                 ctx) is None
