"""Profiling helpers (the counterpart of ``neuroquant_tpu/utils/profiling.py``).

``profile_trace`` wraps a region in a ``torch.profiler`` trace (the host's
operators, and the card's kernels where there is one) and writes it as a
Chrome trace under a directory; ``summarize_trace`` groups the newest
trace's device time by kernel name; ``device_rows`` does the same for a
profile's ``key_averages()``. ``Timer`` logs a wall-clock counter as the
reference's timers do.

Device time counts the card's kernels and copies only: a user-annotated
range (``Optimizer.step#Adam.step``, a ``record_function`` region) also
has a span on the card's timeline, over kernels that are counted already.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import logging
import os
import time

# trace event categories of work on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Timer:
    """Wall-clock timer logging like the reference's counters."""

    def __init__(self, label: str, log_fn=logging.info):
        self.label = label
        self.log_fn = log_fn

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
        self.log_fn("{}: {}".format(self.label, self.elapsed))
        return False


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` trace of the enclosed region, written to
    ``log_dir/trace_<time>.json`` (Chrome trace format). The caller
    synchronizes the card inside the region, so that its kernels end in
    it."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, time.strftime("trace_%Y%m%d_%H%M%S.json"))
    prof.export_chrome_trace(path)
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
