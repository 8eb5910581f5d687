"""How far the program's spans (``utils.profiling.span``) stand from the
profiler's events on the card's machine, and which launches the trace sees.

  python scripts/torch_span_clock.py [--calls 3000]

Under one ``torch.profiler`` window recording the card only (as the
benchmark's trace does):

- each of `--calls` iterations opens a span round one kernel launch; the
  launch's CUDA runtime call (``cudaLaunchKernel``) must lie inside it;
- each of `--calls` iterations stamps ``time.time_ns`` round one
  ``cudaMemsetAsync`` called straight through ``ctypes``, the least host
  code between a stamp and a runtime call, so the margins bound the
  offset between the two clocks tightly: the trace's clock minus
  ``time.time_ns`` lies between minus the least start margin and the
  least end margin.

Margins (the call's start less the window's start, the window's end less
the call's end) in ns, over all calls and the first and last tenth (a
drift between the clocks shows as a change between the two). Then a small
training step (a cuDNN conv, a linear, an autograd Function whose backward
opens a span, Adam) counts the trace's launch calls by name against the
card's kernels, and prints the spans' threads and parents. Last, the host
ns of one span outside a profiler window and inside one, and of the calls
a span makes. With ``--cell`` (a decode cell of ``BENCHMARK.json``), the
cell's decode calls inside one profiler window in blocks of ``--block``
calls, the spans turned on and off by turns, each block timed to a
synchronise: the spans' cost in a traced decode, apart from the machine's
drift. One JSON line on stdout.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import statistics
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from neuroquant_tpu_torch.utils import profiling  # noqa: E402
from nqbench import core  # noqa: E402

LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")


def _stats(values):
    q = statistics.quantiles(values, n=4) if len(values) > 1 else values * 3
    return {"min": min(values), "q1": q[0], "median": q[1], "q3": q[2],
            "max": max(values)}


def _margins(launches, windows):
    """Per call: (call start - window start, window end - call end)."""
    lead = [c[0] - w[0] for c, w in zip(launches, windows)]
    lag = [w[1] - c[1] for c, w in zip(launches, windows)]
    tenth = max(1, len(lead) // 10)
    return {"start": _stats(lead), "end": _stats(lag),
            "start_first_tenth": _stats(lead[:tenth]),
            "start_last_tenth": _stats(lead[-tenth:]),
            "end_first_tenth": _stats(lag[:tenth]),
            "end_last_tenth": _stats(lag[-tenth:]),
            "outside": sum(1 for a, b in zip(lead, lag) if a < 0 or b < 0)}


class _Probe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        with profiling.span("tail"):
            return g * 2.0


def _cudart():
    """The CUDA runtime library this process has loaded (PyTorch's)."""
    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if "libcudart" in line}
    lib = ctypes.CDLL(sorted(paths)[0])
    lib.cudaMemsetAsync.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_size_t, ctypes.c_void_p]
    lib.cudaMemsetAsync.restype = ctypes.c_int
    return lib


def clock(calls: int) -> dict:
    x = torch.ones(1024, device="cuda")
    y = torch.empty_like(x)
    torch.add(x, 1.0, out=y)
    memset = _cudart().cudaMemsetAsync
    ptr = y.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    trace = core.Trace(True)
    trace.start()
    enabled = torch.autograd._profiler_enabled()
    for _ in range(calls):
        with profiling.span("probe"):
            torch.add(x, 1.0, out=y)
    wall = []
    for _ in range(calls):
        t0 = time.time_ns()
        memset(ptr, 0, 4, stream)
        t1 = time.time_ns()
        wall.append((t0, t1))
    torch.cuda.synchronize()
    trace.stop()
    spans = [(s.start_ns, s.end_ns) for s in profiling.spans()
             if s.name == "probe"][-calls:]
    launches = sorted((s, e) for n, s, e in trace.host_events
                      if n.startswith(LAUNCH))
    memsets = sorted((s, e) for n, s, e in trace.host_events
                     if n == "cudaMemsetAsync")
    out = {"profiler_enabled_in_window": enabled,
           "launch_calls": len(launches), "spans": len(spans),
           "memset_calls": len(memsets)}
    if len(launches) == calls == len(spans):
        out["spans_round_launches"] = _margins(launches, spans)
    if len(memsets) == calls:
        m = _margins(memsets, wall)
        out["time_ns_round_memset"] = m
        out["trace_minus_time_ns_ns"] = [-m["start"]["min"], m["end"]["min"]]
    return out


def step() -> dict:
    conv = torch.nn.Conv2d(16, 16, 3, padding=1, device="cuda")
    lin = torch.nn.Linear(64, 64, device="cuda")
    opt = torch.optim.Adam([*conv.parameters(), *lin.parameters()])
    x = torch.randn(2, 16, 64, 64, device="cuda")

    def once():
        with profiling.span("step"):
            with profiling.span("forward"):
                h = _Probe.apply(lin(conv(x)))
            with profiling.span("backward"):
                h.square().mean().backward()
            with profiling.span("optim"):
                opt.step()
                opt.zero_grad(set_to_none=True)

    for _ in range(3):
        once()
    torch.cuda.synchronize()
    before = len(profiling.spans())
    trace = core.Trace(True)
    trace.start()
    for _ in range(5):
        once()
    torch.cuda.synchronize()
    trace.stop()
    rows = profiling.spans()[before:]
    names = collections.Counter(n for n, _, _ in trace.host_events)
    main = threading.get_native_id()
    by_id = {r.id: r for r in rows}
    return {"kernels": trace.kernel_count(),
            "launch_calls": sum(v for k, v in names.items()
                                if k.startswith(LAUNCH)),
            "runtime_calls": dict(names.most_common(20)),
            "tail_spans": [{"thread_is_main": r.thread == main,
                            "parent": by_id[r.parent].name
                            if r.parent in by_id else None,
                            "root": by_id[r.step].name
                            if r.step in by_id else None}
                           for r in rows if r.name == "tail"][:2]}


def costs(n: int = 20000) -> dict:
    """Host ns a call: a span outside and inside a profiler window, and the
    calls it is made of."""
    def timed(fn):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t0) / n

    def one():
        with profiling.span("cost"):
            pass

    out = {"span_off": timed(one),
           "profiler_enabled": timed(torch.autograd._profiler_enabled),
           "time_ns": timed(time.time_ns),
           "get_native_id": timed(threading.get_native_id)}
    trace = core.Trace(True)
    trace.start()
    out["span_on"] = timed(one)
    trace.stop()
    return out


def decode_ab(name: str, block: int, rounds: int = 10) -> dict:
    """ms a decode call of cell `name` in a traced window, the spans on and
    off by turns: {"on": [...], "off": [...]}, one entry a block."""
    from nqbench import program

    cell = core.Cell(core.benchmark(), name, 2147483700, 1, True)
    dev = program.device(cell)
    model, _, _ = program.build(cell, dev)
    model.eval()
    n = int(cell.traffic["n_frames"])
    norm_idx = torch.arange(n, dtype=torch.float32, device=dev) / n
    frames = program.frames(cell, dev) if cell.arch != "nerv" else None
    with torch.no_grad():
        emb = model.encode(model.model_input(frames, norm_idx)[:1])

    def run():
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(block):
                model.decode(emb)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / block

    run()
    on, off = profiling._profiling, (lambda: False)
    out = {"on": [], "off": []}
    trace = core.Trace(True)
    trace.start()
    try:
        for r in range(rounds):
            for mode in (("on", "off") if r % 2 else ("off", "on")):
                profiling._profiling = on if mode == "on" else off
                out[mode].append(run())
    finally:
        profiling._profiling = on
        trace.stop()
    out["median_on_ms"] = statistics.median(out["on"])
    out["median_off_ms"] = statistics.median(out["off"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=3000)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--block", type=int, default=1000)
    args = ap.parse_args()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "card": core.card_line()}
    out["clock"] = clock(args.calls)
    out["step"] = step()
    out["host_ns"] = costs()
    if args.cell:
        out["decode_ab"] = decode_ab(args.cell, args.block)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
