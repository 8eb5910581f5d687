"""The traced window split by the program's spans
(``neuroquant_tpu_torch.utils.profiling.spans``, recorded while the trace
is open). Each instant is put down to the child of the root span open at
that instant: a grandchild's time counts to its child (a ``tail`` inside
``forward`` to ``forward``, a span on autograd's thread to ``backward``),
an instant outside every child to none. The card's idle gaps between
consecutive intervals of its union, the host's kernel launch calls by
their start, and the card's operations by the start of the call that
launched them, are split so. Read by ``metrics/span_idle_pct.py``,
``metrics/span_launches_per_step.py`` and ``metrics/span_card_ms.py``."""

from __future__ import annotations

import bisect
import collections

# the root span of each driver's kind: one decode call, one training step
ROOTS = {"decode": "decode", "calib": "step", "train": "step"}
# the CUDA runtime's and driver's kernel launch calls, as the trace names them
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")


def split(ctx):
    """{"layers", "idle_ns", "launches", "card_ns", "rest_ns"} of the traced
    window, by the name of the roots' children (``rest_ns``: the card time
    of the operations launched outside every child or joined to no call);
    worked out once a run and kept in `ctx`. None where the program
    recorded no such span (a build without spans) or the card ran
    nothing."""
    if "span_split" not in ctx:
        ctx["span_split"] = _split(ctx)
    return ctx["span_split"]


def _recorded() -> list:
    try:
        from neuroquant_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def layer_intervals(rows, root: str) -> list:
    """[(start_ns, end_ns, name)] of the children of every root span named
    `root`, in time order, each begun no earlier than the one before it
    ended, so that no instant counts twice."""
    roots = {r.id for r in rows if r.parent is None and r.name == root}
    out, last = [], None
    for s, e, n in sorted((r.start_ns, r.end_ns, r.name) for r in rows
                          if r.parent in roots):
        if last is not None:
            s = max(s, last)
        if e > s:
            out.append((s, e, n))
            last = e
    return out


def idle_gaps(device_events) -> list:
    """[(start_ns, end_ns)] of the card's idle gaps between consecutive
    intervals of the union of its kernels, copies and memsets."""
    out, end = [], None
    for _, s, e, _ in sorted(device_events, key=lambda t: t[1]):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def _split(ctx):
    trace, root = ctx["trace"], ROOTS.get(ctx["kind"])
    if root is None or not trace.device_events:
        return None
    ivs = layer_intervals(_recorded(), root)
    if not ivs:
        return None
    starts = [s for s, _, _ in ivs]
    ends = [e for _, e, _ in ivs]

    def layer_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return ivs[i][2] if i >= 0 and t < ends[i] else None

    idle, launches = collections.Counter(), collections.Counter()
    card, rest = collections.Counter(), 0
    for g0, g1 in idle_gaps(trace.device_events):
        i = bisect.bisect_right(ends, g0)
        while i < len(ivs) and starts[i] < g1:
            idle[ivs[i][2]] += min(g1, ends[i]) - max(g0, starts[i])
            i += 1
    for name, s, _ in trace.host_events:
        if name.startswith(LAUNCH):
            layer = layer_at(s)
            if layer is not None:
                launches[layer] += 1
    for (_, s, e, _), t in zip(trace.device_events, trace.launch_starts()):
        layer = None if t is None else layer_at(t)
        if layer is None:
            rest += e - s
        else:
            card[layer] += e - s
    return {"layers": {n for _, _, n in ivs}, "idle_ns": idle,
            "launches": launches, "card_ns": card, "rest_ns": rest}


def card_window(ctx) -> dict:
    """What the result line's window says of the traced card time: the
    operations' summed time a step or call (``card_ms``), the share of it
    joined to a launch (``card_matched_pct``), and where spans were
    recorded the part in no layer (``card_rest_ms``). Empty where the card
    ran nothing."""
    trace, steps = ctx["trace"], ctx["steps"]
    dur = [e - s for _, s, e, _ in trace.device_events]
    total = sum(dur)
    if not total:
        return {}
    matched = sum(d for d, t in zip(dur, trace.launch_starts())
                  if t is not None)
    out = {"card_ms": total / 1e6 / steps,
           "card_matched_pct": 100.0 * matched / total}
    got = split(ctx)
    if got is not None:
        out["card_rest_ms"] = got["rest_ns"] / 1e6 / steps
    return out
