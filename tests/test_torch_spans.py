"""The span recorder of ``neuroquant_tpu_torch/utils/profiling.py`` on the
CPU: nothing recorded outside a profiler window; nesting, parents, step
ids and threads inside one; a span opened on another thread (autograd's,
in a backward on the card) under the caller's open span; the spans on the
clock of the profiler's own events and in the Chrome trace that
``profile_trace`` writes; and the layers one step of calibration's
``_run_phase`` and of stage 1's ``run_epoch`` emit, in order, on the tiny
HNeRV."""

import json
import os
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.utils import profiling
from neuroquant_tpu_torch.utils.profiling import span, spans


def _window():
    return profile(activities=[ProfilerActivity.CPU])


def _recorded(run):
    """The spans `run()` records inside one profiler window."""
    before = len(spans())
    with _window():
        run()
    return spans()[before:]


def test_nothing_recorded_outside_a_window():
    before = len(spans())
    with span("step"), span("forward"):
        torch.ones(2).sum()
    assert len(spans()) == before
    assert span("a") is span("b")       # one shared do-nothing object


def _nested():
    with span("step"):
        with span("forward"):
            with span("tail"):
                pass
        with span("optim"):
            pass
    with span("step"):
        pass


def _backward_on_caller():
    class Double(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            with span("tail"):
                return 2 * g

    x = torch.ones(3, requires_grad=True)
    with span("step"), span("backward"):
        Double.apply(x).sum().backward()


def _other_thread():
    def work():
        with span("tail"):
            pass

    with span("step"), span("backward"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.parametrize("case", ["nested", "backward", "thread"])
def test_parents_steps_and_threads(case, monkeypatch):
    """On the card autograd runs a backward on a thread of its own, which
    inherits the caller's profiler state; on the CPU it runs on the
    caller's. The "thread" case opens a span on a plain thread, which
    inherits no profiler state, so there the check is turned on."""
    run = {"nested": _nested, "backward": _backward_on_caller,
           "thread": _other_thread}[case]
    if case == "thread":
        monkeypatch.setattr(profiling, "_profiling", lambda: True)
    rows = _recorded(run)
    by_id = {r.id: r for r in rows}
    assert len(by_id) == len(rows)
    for r in rows:
        assert r.start_ns <= r.end_ns
        root = by_id[r.step]
        assert root.parent is None and root.name == "step"
        if r.parent is not None:
            parent = by_id[r.parent]
            assert parent.step == r.step
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    main = threading.get_native_id()
    tail = [r for r in rows if r.name == "tail"]
    if case == "nested":
        steps = [r for r in rows if r.name == "step"]
        assert len(steps) == 2 and steps[0].id != steps[1].id
        assert by_id[tail[0].parent].name == "forward"
        assert [r.name for r in rows] == ["tail", "forward", "optim", "step",
                                          "step"]
    else:
        assert len(tail) == 1 and by_id[tail[0].parent].name == "backward"
        assert (tail[0].thread == main) == (case == "backward")
    assert all(r.thread == main for r in rows if r.name != "tail")


def test_spans_on_the_profilers_clock_and_in_its_trace(tmp_path):
    """Each span brackets the operator the profiler recorded inside it, and
    ``profile_trace`` writes each span as a complete event that brackets
    the same operator's event in the trace."""
    x = torch.randn(32, 32)
    n = 20
    before = len(spans())
    with profiling.profile_trace(str(tmp_path)):
        for _ in range(n):
            with span("probe"):
                torch.mm(x, x)
    rows = [r for r in spans()[before:] if r.name == "probe"]
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mm = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("name") == "aten::mm" and e.get("ph") == "X")
    written = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "span" and e["name"] == "probe")
    assert len(rows) == len(mm) == len(written) == n
    for (s, e), (ws, we) in zip(mm, written):
        assert ws <= s and e <= we
    for ev in events:
        if ev.get("cat") == "span":
            assert ev["ph"] == "X" and ev["pid"] == os.getpid()


def _calibration(tiny_hnerv_cfg):
    from neuroquant_tpu_torch.quantization import calibrate as cal
    from neuroquant_tpu_torch.quantization import qmodel
    from neuroquant_tpu_torch.quantization.spec import make_spec

    torch.manual_seed(0)
    model = build_model("hnerv", tiny_hnerv_cfg, device="cpu").eval()
    params = {k: v.detach() for k, v in model.state_dict().items()}
    spec = make_spec("hnerv", tiny_hnerv_cfg, hadamard=True).with_bits(
        (6, 5, 4, 5, 6))
    state = qmodel.adaround_upgrade(params, spec,
                                    qmodel.init_quant_state(params, spec))
    frames = torch.rand(4, tiny_hnerv_cfg["crop_h"], tiny_hnerv_cfg["crop_w"],
                        3)
    with torch.no_grad():
        emb = model.encode(frames)

    def extra(st, count):
        return qmodel.round_loss(st, spec, 10.0, 0.01), 10.0

    loss = cal.make_loss(model, params, spec, "adaround", 2.0, None, extra)
    return lambda: cal._run_phase(
        loss=loss, state=state, cali_data=emb, gt=frames,
        trainable_keys=("w_alpha", "b_alpha"), lr=1e-3, epochs=1,
        steps_per_epoch=2, batch_size=2, order=lambda e: list(range(4)))


def _stage1(tiny_hnerv_cfg):
    from neuroquant_tpu_torch.methods.regress import make_train_epoch

    torch.manual_seed(0)
    model = build_model("hnerv", tiny_hnerv_cfg, device="cpu")
    frames = torch.rand(2, tiny_hnerv_cfg["crop_h"], tiny_hnerv_cfg["crop_w"],
                        3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    run = make_train_epoch(model, "l2", opt, lambda s: 1e-3, frames,
                           torch.arange(2, dtype=torch.float32) / 2, 2, 1)
    return lambda: run([0, 1], 0)


CHILDREN = {
    "calibration": ["optim", "fakequant", "forward", "loss", "backward",
                    "optim"],
    "stage1": ["optim", "forward", "loss", "backward", "loss", "optim"],
}


@pytest.mark.parametrize("loop", ["calibration", "stage1"])
def test_training_loops_emit_their_layers(loop, tiny_hnerv_cfg):
    """Each step of the loop is a root ``step`` whose children are the
    layers in the order the step runs them; the decoder's own spans sit
    inside ``forward``, the tail's backward inside ``backward``."""
    make = {"calibration": _calibration, "stage1": _stage1}[loop]
    rows = _recorded(make(tiny_hnerv_cfg))
    by_id = {r.id: r for r in rows}
    roots = sorted((r for r in rows if r.parent is None),
                   key=lambda r: r.start_ns)
    assert [r.name for r in roots] == ["step", "step"]
    for root in roots:
        children = sorted((r for r in rows if r.parent == root.id),
                          key=lambda r: r.start_ns)
        assert [r.name for r in children] == CHILDREN[loop]
        for a, b in zip(children, children[1:]):
            assert a.end_ns <= b.start_ns
        inner = [(r.name, by_id[r.parent].name) for r in rows
                 if r.step == root.id and r.parent not in (None, root.id)]
        assert ("decode", "forward") in inner
        assert ("prefix", "decode") in inner
        assert {p for n, p in inner if n == "tail"} == {"decode", "backward"}
