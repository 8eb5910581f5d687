"""The reader of the card's time by span (``metrics/span_card_ms.py``,
``span_split.py``) on a hand-built trace: each operation joined to the
call that launched it by their correlation id and put down to the child of
the root open when that call started, on whatever thread; an operation
launched outside every child, or joined to no call, in no layer and in the
window's rest; the share joined; None where no spans were recorded."""

import pytest

from neuroquant_tpu_torch.utils.profiling import Span
from nqbench import core, span_split

US = 1000       # the example's times are in µs, the trace's in ns
MAIN, AUTOGRAD = 11, 12
STEPS = [
    Span("step", 0, 100 * US, 1, None, 1, MAIN),
    Span("fakequant", 0, 20 * US, 2, 1, 1, MAIN),
    Span("forward", 20 * US, 60 * US, 3, 1, 1, MAIN),
    Span("tail", 30 * US, 50 * US, 4, 3, 1, MAIN),
    Span("loss", 60 * US, 70 * US, 5, 1, 1, MAIN),
    Span("backward", 70 * US, 95 * US, 6, 1, 1, MAIN),
    Span("tail", 75 * US, 90 * US, 7, 6, 1, AUTOGRAD),
    Span("optim", 95 * US, 100 * US, 8, 1, 1, MAIN),
    Span("step", 150 * US, 200 * US, 9, None, 9, MAIN),
    Span("forward", 150 * US, 180 * US, 10, 9, 9, MAIN),
    Span("optim", 180 * US, 200 * US, 11, 9, 9, MAIN),
]
# (runtime call, its start, correlation id)
HOST = [("cudaLaunchKernel", 1, 1),
        ("cudaLaunchKernel", 21, 2),
        ("cudaMemcpyAsync", 31, 3),        # inside forward's tail
        ("cuLaunchKernel", 61, 4),
        ("cudaLaunchKernel", 76, 5),       # autograd's thread, in backward
        ("cudaLaunchKernel", 94, 9),       # runs after backward has closed
        ("cudaLaunchKernel", 110, 6),      # between the steps: no child
        ("cudaLaunchKernel", 155, 7),
        ("cudaStreamSynchronize", 170, 0),
        ("cudaLaunchKernel", 181, 8)]
# (operation, start, end, correlation id)
DEVICE = [("k1", 2, 5, 1), ("k2", 22, 30, 2), ("Memcpy DtoD", 31, 33, 3),
          ("k4", 62, 64, 4), ("k5", 77, 90, 5), ("k9", 96, 99, 9),
          ("k6", 111, 120, 6), ("k7", 160, 170, 7), ("k8", 182, 185, 8),
          ("k99", 186, 190, 99),          # its call is not in the trace
          ("Memset", 191, 192, 0)]        # no correlation id
CARD_US = {"fakequant": 3, "forward": 8 + 2 + 10, "loss": 2,
           "backward": 13 + 3, "optim": 3}
REST_US = 9 + 4 + 1
TOTAL_US = 58
MATCHED_US = TOTAL_US - 4 - 1


def _ctx(kind="calib"):
    trace = core.Trace(False)
    trace.device_events = [(n, s * US, e * US,
                            not n.startswith(("Memcpy", "Memset")))
                           for n, s, e, _ in DEVICE]
    trace.device_corr = [c for *_, c in DEVICE]
    trace.host_events = [(n, s * US, s * US + US // 2) for n, s, _ in HOST]
    trace.host_corr = [c for *_, c in HOST]
    return {"kind": kind, "steps": 2, "window_s": 200e-6, "trace": trace}


def _read(name, ctx):
    return core.module("metrics", "span_card_ms").read(name, ctx)


@pytest.fixture
def recorded(monkeypatch):
    def use(rows):
        monkeypatch.setattr(span_split, "_recorded", lambda: list(rows))
    use(STEPS)
    return use


@pytest.mark.parametrize("layer", sorted(CARD_US))
def test_each_operation_to_the_child_open_at_its_launch(recorded, layer):
    got = _read(f"span_card_ms.calib.{layer}", _ctx())
    assert got == pytest.approx(CARD_US[layer] / 1e3 / 2)


def test_rest_and_share_joined(recorded):
    ctx = _ctx()
    window = span_split.card_window(ctx)
    assert window["card_ms"] == pytest.approx(TOTAL_US / 1e3 / 2)
    assert window["card_matched_pct"] == pytest.approx(
        100.0 * MATCHED_US / TOTAL_US)
    assert window["card_rest_ms"] == pytest.approx(REST_US / 1e3 / 2)
    layers = sum(_read(f"span_card_ms.calib.{k}", ctx) for k in CARD_US)
    assert layers + window["card_rest_ms"] == pytest.approx(
        window["card_ms"], rel=1e-12)


def test_decode_roots_and_their_regime(recorded):
    recorded([Span("decode", 0, 100 * US, 1, None, 1, MAIN),
              Span("prefix", 0, 25 * US, 2, 1, 1, MAIN),
              Span("tail", 25 * US, 100 * US, 3, 1, 1, MAIN)])
    ctx = _ctx(kind="decode")
    assert _read("span_card_ms.decode.prefix", ctx) == pytest.approx(
        (3 + 8) / 1e3 / 2)
    assert _read("span_card_ms.decode.host_paced.tail", ctx) == \
        pytest.approx((2 + 2 + 13 + 3) / 1e3 / 2)


@pytest.mark.parametrize("case", ["no spans", "another kind",
                                  "no such layer"])
def test_nothing_to_read(recorded, case):
    ctx, name = _ctx(), "span_card_ms.calib.forward"
    if case == "no spans":          # the CPU rehearsal records none
        recorded([])
    elif case == "another kind":
        name = "span_card_ms.train.forward"
    else:
        name = "span_card_ms.calib.prefix"
    assert _read(name, ctx) is None
    if case == "no spans":
        assert "card_rest_ms" not in span_split.card_window(ctx)
