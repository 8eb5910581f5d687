"""Run one cell of the benchmark once and print its result line.

  python3 -m nqbench.run --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, driver, work counts, reference and per-layer
readers are files found by their names (``nqbench/configs``, ``traffic``,
``drivers``, ``work``, ``reference``, ``metrics``, ``limits``). The run
loads the program, makes its weights and inputs from the seed, warms up
the cell's shapes (all of it ``setup_s``), measures for ``--seconds``,
reads the peak memory, checks what the window produced against the plain
reference, and prints one JSON line last on stdout, the numbers compared
with their limits last on stderr. ``--trace 1`` splits ``--seconds`` into a
timed window and, after it, a traced one (one profiler window), and
reports the per-layer metrics instead of the end-to-end ones. Without a
CUDA card, or with fewer than the cell asks for, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# caches of the program's toolchain at fixed places inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, "_cache",
                                                       "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(HERE, "_cache",
                                                           "torch_ext"))
os.environ.setdefault("USE_FLAX", "0")

import torch  # noqa: E402

from nqbench import core, span_split  # noqa: E402


def run_cell(cell, t_start: float) -> dict:
    """Set-up, window, reading and judgement of one run: the result dict.
    The set-up runs until the driver opens its window (``t_open``), which
    for a training cell is inside the program's call. With the trace on,
    the driver's timed window is followed by a traced one, the two of half
    the length each; the per-layer metrics read the traced one and
    ``mfu_pct`` the timed one, since the profiler slows a host-bound
    step."""
    driver = core.module("drivers", cell.traffic["driver"])
    st = driver.setup(cell)
    trace = core.Trace(cell.trace)
    out = driver.window(st, cell, trace)
    setup_s = out["t_open"] - t_start
    cuda = cell.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = core.forbidden_modules()
    if bad:
        raise core.Refused(f"loaded by the window: {', '.join(bad)}")
    checks = driver.judge_run(st, cell)
    for k, v in getattr(st, "diag", {}).items():
        print(f"nqbench: {k} {v}", file=sys.stderr)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)

    metrics = {}
    window = {"steps": out["steps"], "seconds": out["wall_s"]}
    if "epoch_step_ms" in out:
        window["epoch_step_ms"] = out["epoch_step_ms"]
    if not cell.trace:
        # ``decode_fps.host_paced`` is ``decode_fps`` under a bound of its own
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.metrics("end_to_end"):
            base = m["name"].split(".")[0]
            if base in values:
                metrics[m["name"]] = {"value": values[base],
                                      "unit": m["unit"]}
    else:
        ctx = {"kind": out["work"]["kind"], "steps": out["traced_steps"],
               "window_s": trace.wall_s, "trace": trace, "work": out["work"],
               "timed_steps": out["steps"], "timed_s": out["wall_s"]}
        for m in cell.metrics("per_layer"):
            v = core.module("metrics", m["name"]).read(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        window.update(traced_steps=out["traced_steps"],
                      traced_seconds=trace.wall_s,
                      traced_over_timed=(trace.wall_s / out["traced_steps"])
                      / (out["wall_s"] / out["steps"]),
                      **span_split.card_window(ctx))
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cell.device) if cuda
              else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if cell.trace:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.wall_s
        result["breakdown"] = trace.breakdown()
        result["trace_check"] = {
            "busy_le_window": device["busy_s"] <= trace.wall_s,
            "kernel_sum_s": sum(e - s for _, s, e, k in trace.device_events
                                if k) / 1e9,
            "event_window_s": out.get("event_s")}
    result["card"] = core.card_line() if cuda else "cpu"
    result["window"] = window
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = core.process_start()
    try:
        cell = core.Cell(core.benchmark(), args.workload, args.seed,
                         args.seconds, args.trace)
        if not torch.cuda.is_available():
            raise core.Refused("no CUDA device: the benchmark runs only on "
                               "the card")
        if torch.cuda.device_count() < cell.chips:
            raise core.Refused(f"{args.workload} needs {cell.chips} cards, "
                               f"{torch.cuda.device_count()} present")
        result = run_cell(cell, t_start)
    except (core.Refused, OSError, KeyError, ImportError) as e:
        print(f"nqbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
