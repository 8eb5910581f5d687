"""Profiling helpers (the counterpart of ``neuroquant_tpu/utils/profiling.py``).

``profile_trace`` wraps a region in a ``torch.profiler`` trace (the host's
operators, and the card's kernels where there is one) and writes it as a
Chrome trace under a directory, the program's spans beside them;
``summarize_trace`` groups the newest trace's device time by kernel name;
``device_rows`` does the same for a profile's ``key_averages()``.
``queued_ms`` and ``hot_cold`` time calls on the card by CUDA events
without the host setting the pace (the event method of
``scripts/torch_layout_bench.py`` and ``chip_smoke.py``).

``span(name)`` marks a layer of the program (a decode call or a training
step, and within it the fake-quant, the forward, the loss, the backward,
the optimizer, the decoder's prefix and tail) on the clock of the
profiler's events; ``spans()`` returns what was recorded. Spans record
only while a ``torch.profiler`` window is open: outside one a span costs
one check of the profiler's state.

Device time counts the card's kernels and copies only: a user-annotated
range (``Optimizer.step#Adam.step``, a ``record_function`` region) also
has a span on the card's timeline, over kernels that are counted already.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import logging
import math
import os
import threading
import time
from typing import NamedTuple

import torch

# trace event categories of work on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# a cold rotation's inputs and outputs, at least: 2.5x the H100's 50 MB L2
COLD_BYTES = 128e6


# --------------------------------------------------------------------------
# Spans: the program's layers on the clock of the profiler's events, which
# kineto gives in Unix-epoch ns, the base of ``time.time_ns``: on an H100
# every CUDA runtime launch call of a span lies inside it on that clock
# (``scripts/torch_span_clock.py``). The profiler's state is per thread;
# autograd's threads take the calling thread's.
# --------------------------------------------------------------------------
_profiling = torch.autograd._profiler_enabled

_RECORDED = []      # Span fields, in the order the spans closed
_OPEN = {}          # native thread id -> [(id, step, start), ...] open there
_IDS = itertools.count(1)
_THREAD = threading.local()     # this thread's native id and open stack


class Span(NamedTuple):
    """A recorded span. Times in Unix-epoch ns, the base of the profiler's
    events; `id`, `parent` (None for a root) and `step` (the root's id,
    shared by every span of one decode call or training step) are span
    ids; `thread` is the native id of the thread it ran on."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    step: int
    thread: int


class _Off:
    """What :func:`span` returns outside a profiler window."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _caller(tid: int):
    """(parent, step) of a span opened on thread `tid` with no span open
    there: the innermost open span of the thread that opened its span
    last, which is the thread that called ``backward()`` for a span on
    autograd's thread; (None, None) where no other thread has one open."""
    top = None
    for t, stack in list(_OPEN.items()):
        if t != tid and stack and (top is None or stack[-1][2] > top[2]):
            top = stack[-1]
    return (None, None) if top is None else top[:2]


class _On:
    __slots__ = ("name", "tid", "parent", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        mine = _THREAD.__dict__
        if not mine:        # a thread's first span: its id, once
            mine["tid"] = threading.get_native_id()
            mine["stack"] = _OPEN.setdefault(mine["tid"], [])
        tid = self.tid = mine["tid"]
        stack = self.stack = mine["stack"]
        parent, step = stack[-1][:2] if stack else _caller(tid)
        sid = next(_IDS)
        self.parent = parent
        stack.append((sid, sid if step is None else step, time.time_ns()))

    def __exit__(self, *exc):
        end = time.time_ns()
        sid, step, start = self.stack.pop()
        _RECORDED.append((self.name, start, end, sid, self.parent, step,
                          self.tid))
        return False


def span(name: str):
    """A context manager that records `name` over the enclosed code while a
    ``torch.profiler`` window is open, nested under the span open on this
    thread (or, on a thread with none, under the one the calling thread
    has open); outside a window it records nothing and allocates
    nothing."""
    if not _profiling():
        return _OFF
    return _On(name)


def spans() -> list:
    """Every span recorded so far, in the order they closed."""
    return [Span(*r) for r in list(_RECORDED)]


def _write_spans(path: str, rows) -> None:
    """Add `rows` to the Chrome trace at `path` as complete events on the
    host's pid and each span's thread, beside the profiler's own."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "span", "name": r.name, "pid": pid,
         "tid": r.thread, "ts": (r.start_ns - base) / 1e3,
         "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": {"id": r.id, "parent": r.parent, "step": r.step}}
        for r in rows)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` trace of the enclosed region, written to
    ``log_dir/trace_<time>.json`` (Chrome trace format) with the spans
    recorded in it. The caller synchronizes the card inside the region, so
    that its kernels end in it."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = len(_RECORDED)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, time.strftime("trace_%Y%m%d_%H%M%S.json"))
    prof.export_chrome_trace(path)
    _write_spans(path, spans()[before:])
    logging.info("profiler trace written to %s", path)


def summarize_trace(log_dir: str, top_k: int = 20) -> list:
    """The newest trace in `log_dir` as [(ms_total, kernel name), ...]:
    the card's time summed by kernel (and copy) name, largest first. A
    trace without device events (a run on the CPU) gives []."""
    files = sorted(glob.glob(os.path.join(log_dir, "trace_*.json")),
                   key=os.path.getmtime)
    if not files:
        return []
    with open(files[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    groups = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS:
            groups[e["name"]] += float(e.get("dur", 0))
    return [(us / 1000.0, name) for name, us in groups.most_common(top_k)]


def device_rows(events) -> list:
    """[(device µs, launches, name), ...] of a profile's ``key_averages()``:
    each CUDA kernel's or copy's own device time, user-annotated ranges
    left out; rows without device time dropped."""
    from torch.autograd import DeviceType

    rows = []
    for e in events:
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.count > 0:
            rows.append((us, e.count, e.key))
    return rows


def queued_ms(calls, n: int = 50, tries: int = 3):
    """The card's own ms per call: `n` calls, rotating over `calls`, queued
    behind ``torch.cuda._sleep`` long enough for the host to enqueue them
    all before the card starts, CUDA events around them divided by `n`.
    A window in which the card reached the first timed call before the host
    had enqueued the last is paced by the host: it is taken again behind a
    sleep four times as long, up to `tries` windows; None when none was
    queued whole."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        calls[i % len(calls)]()
    sleep_s = max(2e-3, 3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * 2e9))           # ~2 GHz cycles
        start.record()
        for i in range(n):
            calls[i % len(calls)]()
        end.record()
        queued = not start.query()    # the card had not reached them yet
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n
        sleep_s *= 4
    return None


def hot_cold(make, run, nbytes: float, n: int = 50):
    """(hot, cold) ms per call of `run` by :func:`queued_ms`: hot on one
    input from `make(0)` every call (in L2, as the main path finds the
    tensor the kernel before has just written); cold over inputs make(0),
    make(1), ... with each output kept until its input comes round again,
    more than COLD_BYTES in all with `nbytes` a call, so that every call
    reads device memory. Either is None where the host set the pace."""
    x = make(0)
    hot = queued_ms([lambda: run(x)], n=n)
    k = max(2, math.ceil(COLD_BYTES / nbytes))
    xs = [make(i) for i in range(k)]
    outs = [None] * k

    def call(j):
        def fn():
            outs[j] = run(xs[j])
        return fn
    cold = queued_ms([call(j) for j in range(k)], n=k * math.ceil(n / k))
    return hot, cold
