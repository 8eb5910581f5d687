"""What every cell of the benchmark shares: finding a cell's files by the
names in ``BENCHMARK.json``, the seeded weights and frames, the profiler
window and its reading, and the checks that a run is sound.

Nothing here imports the program (``neuroquant_tpu_torch``) at module
level; the drivers under ``nqbench/drivers/`` do, when a cell runs.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# published peaks of one H100 SXM (dense): the fp32 work of the port runs
# 3xTF32 on the tensor cores, so its peak is the TF32 one
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12

# top-level module names no run may have loaded once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "neuroquant_tpu")


# keys of a configuration file that are the benchmark's, not the model's
OWN_KEYS = ("arch", "classes", "source", "reduced", "assumed")


class Refused(RuntimeError):
    """A run that cannot start or cannot be trusted: exit non-zero, print
    no result."""


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


class Cell:
    """One entry of ``workloads`` with the files its names point to: the
    configuration's file, ``traffic/<traffic>.json`` and
    ``limits/<workload>.json`` (the limits of the numbers that decide
    ``correct``)."""

    def __init__(self, bench: dict, name: str, seed: int, seconds: float,
                 trace: bool, device="cuda", root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.bench, self.entry = bench, cells[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = read_json(os.path.join(root, conf["file"]))
        self.traffic = read_json(os.path.join(
            HERE, "traffic", self.entry["traffic"] + ".json"))
        self.limits = read_json(os.path.join(HERE, "limits", name + ".json"))
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device = torch.device(device)
        self.chips = int(self.entry.get("chips", 1))

    @property
    def arch(self) -> str:
        return self.config["arch"]

    @property
    def cfg(self) -> dict:
        """The model's keys, as the program's config loader gives them: the
        configuration file without the benchmark's own keys."""
        return {k: v for k, v in self.config.items() if k not in OWN_KEYS}

    def metrics(self, section: str):
        """The entries of `section` ('end_to_end' or 'per_layer') this cell
        reports: those that list it, and those that list no cell."""
        return [m for m in self.bench[section]
                if self.name in m.get("workloads", [self.name])]


def module(kind: str, name: str):
    """``nqbench/<kind>/<name>.py`` as a module: a driver, a work count, a
    reference or a metric's reader. A metric named ``base.suffix`` without
    a file of its own is read by ``<base>.py``."""
    cands = [name] + ([name.split(".")[0]] if kind == "metrics" else [])
    for cand in cands:
        path = os.path.join(HERE, kind, cand + ".py")
        if os.path.exists(path):
            key = f"nqbench.{kind}.{cand}".replace("-", "_")
            if key in sys.modules:
                return sys.modules[key]
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
            return mod
    raise Refused(f"no nqbench/{kind}/{name}.py")


# ---------------------------------------------------------------------------
# inputs from the seed
# ---------------------------------------------------------------------------
def seeded_state_dict(model, seed: int, device):
    """Weights for `model` drawn on `device` from `seed`, the weights both
    the program and the reference get: (a state dict in the model's names,
    the sorted names kept at the constructor's values).

    One generator on `device`, seeded with `seed`, draws in three calls,
    in this order:

    1. each module's weight that is 4-D (a conv) or a linear's, and that
       module's bias, in module order: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
       torch's default init, fan_in the weight's elements an output row;
    2. every other parameter of two or more dimensions, more than one of
       them over 1, a factor (PNeRV1's KFc ``w_L``, ``w_R``): N(0, 2 /
       fan_out), kaiming normal, fan-out, as the published KFc init states,
       fan_out of the shape without its leading 1s, the first dimension
       times the third and later ones;
    3. every other parameter of two or more dimensions, a vector (KFc's
       rank-1 bias factors ``b_h``, ``b_w``, ``b_c``, zero in the
       published init): U(-1/sqrt(n), 1/sqrt(n)), n its length, so that
       the bias term they make is not zero.

    Step 1 is the whole draw of a model without such parameters (HNeRV,
    NeRV). What is left, one-dimensional (norms' affine parameters, layer
    scales), keeps the constructor's values. Refused where any value is not
    finite."""
    sd = {k: v.detach().to(device, copy=True)
          for k, v in model.state_dict().items()}
    drawn = []
    for mname, m in model.named_modules():
        w = getattr(m, "weight", None)
        if not isinstance(w, torch.nn.Parameter):
            continue
        if not (w.dim() == 4 or isinstance(m, torch.nn.Linear)):
            continue
        bound = 1.0 / math.sqrt(w[0].numel())
        pre = mname + "." if mname else ""
        drawn.append((pre + "weight", bound))
        if isinstance(getattr(m, "bias", None), torch.nn.Parameter):
            drawn.append((pre + "bias", bound))
    done = {k for k, _ in drawn}
    rest = [(k, p.shape) for k, p in model.named_parameters()
            if k not in done and p.dim() >= 2]
    factors = [(k, math.sqrt(2.0 / _fan_out(s))) for k, s in rest
               if sum(n > 1 for n in s) > 1]
    vectors = [(k, 1.0 / math.sqrt(math.prod(s))) for k, s in rest
               if sum(n > 1 for n in s) <= 1]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for group, draw in ((drawn, _uniform), (factors, torch.randn),
                        (vectors, _uniform)):
        if not group:
            continue
        total = sum(sd[k].numel() for k, _ in group)
        u = draw(total, generator=gen, device=device)
        at = 0
        for k, scale in group:
            n = sd[k].numel()
            sd[k] = (u[at:at + n] * scale).reshape(sd[k].shape).contiguous()
            at += n
    bad = [k for k, v in sd.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    if bad:
        raise Refused(f"weights not finite after the seeded draw: {bad}")
    done |= {k for k, _ in factors + vectors}
    return sd, sorted(k for k in sd if k not in done)


def _uniform(n: int, generator, device):
    """n draws of U(-1, 1)."""
    return torch.rand(n, generator=generator, device=device) * 2.0 - 1.0


def _fan_out(shape) -> int:
    """Kaiming's fan-out of `shape` without its leading 1s: the first
    dimension times the third and later ones."""
    s = list(shape)
    while len(s) > 2 and s[0] == 1:
        s.pop(0)
    return s[0] * math.prod(s[2:])


def synthetic_frames(n: int, seed: int, device, size=(720, 1280),
                     crop=(640, 1280)):
    """`n` seeded frames of `size` (a gradient, a per-frame tint and noise,
    rounded to 8 bits), center-cropped to `crop` as the program's loader
    crops a decoded clip: (n, *crop, 3) float32 in [0, 1] on `device`. A
    copy of the program's ``bench.synthetic_frames``, its noise drawn in
    one call."""
    h, w = size
    ch, cw = crop
    top, left = int(round((h - ch) / 2.0)), int(round((w - cw) / 2.0))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None] / h
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :] / w
    tint = 0.5 + 0.4 * torch.sin(torch.arange(n, dtype=torch.float64,
                                              device=device)).float()
    img = torch.stack([xx.expand(h, w), yy.expand(h, w)], -1)
    img = torch.cat([img.expand(n, h, w, 2),
                     tint[:, None, None, None].expand(n, h, w, 1)], -1)
    img = img + 0.05 * torch.randn((n, h, w, 3), generator=gen,
                                   device=device)
    u8 = (img.clamp(0, 1) * 255).to(torch.uint8)
    return u8[:, top:top + ch, left:left + cw].to(torch.float32) / 255.0


def epoch_order(n: int, seed: int, tag: int, epoch: int):
    """The benchmark's shuffle of `n` frames for (tag, epoch), on the host."""
    g = torch.Generator().manual_seed((int(seed) % (1 << 40)) * 64 + tag
                                      + (epoch << 46))
    return torch.randperm(n, generator=g)


# ---------------------------------------------------------------------------
# the device, the clock and the trace
# ---------------------------------------------------------------------------
def process_start() -> float:
    """The wall time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


_T0 = []


def note(what: str) -> None:
    """A line on stderr: `what` and the seconds since the process began
    (where set-up goes)."""
    if not _T0:
        _T0.append(process_start())
    print(f"nqbench: {what} at {time.time() - _T0[0]:.2f} s",
          file=sys.stderr, flush=True)


class Events:
    """CUDA events at a window's open and close: the card's time of the
    window, to hold the trace's kernel sums against (None on the CPU)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.start = self.end = None

    def open(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    def close(self):
        if self.cuda:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()

    def seconds(self):
        """After a synchronise."""
        return self.start.elapsed_time(self.end) / 1e3 if self.cuda else None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Trace:
    """One ``torch.profiler`` window over the whole timed window (one per
    process), started and stopped by the driver, recording the card's
    activity only: the host's operators are left out, since recording them
    doubles a host-bound step. After ``stop`` it holds the card's intervals
    (kernels, copies and memsets) and the host's CUDA runtime calls, which
    label the card's idle gaps, each with its correlation id, which joins
    an operation to the call that launched it (0: none)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.wall_s = None
        self.device_events = []     # (name, start_ns, end_ns, is_kernel)
        self.host_events = []       # (name, start_ns, end_ns)
        self.device_corr = []       # the correlation id of each device event
        self.host_corr = []         # the correlation id of each host event
        self._starts = None         # launch_starts(), once worked out

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [
            ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        """Call after the window's final synchronise."""
        if self.prof is None:
            return
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                is_kernel = not name.startswith(("Memcpy", "Memset"))
                self.device_events.append((name, start, start + dur,
                                           is_kernel))
                self.device_corr.append(e.correlation_id())
            else:
                self.host_events.append((name, start, start + dur))
                self.host_corr.append(e.correlation_id())
        self.prof = None

    def launch_starts(self) -> list:
        """For each device event, the start of the host's runtime or driver
        call that launched it, joined by their correlation id (the earliest
        call with the id); None where no traced call has its id."""
        if self._starts is None:
            first = {}
            for (_, s, _), c in zip(self.host_events, self.host_corr):
                if c and (c not in first or s < first[c]):
                    first[c] = s
            self._starts = [first.get(c) if c else None
                            for c in self.device_corr]
        return self._starts

    def busy_s(self) -> float:
        """The union of the card's intervals, in seconds."""
        busy, end = 0, None
        for _, s, e, _ in sorted(self.device_events, key=lambda t: t[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def kernel_count(self) -> int:
        return sum(1 for ev in self.device_events if ev[3])

    def time_of(self, names) -> float:
        """Summed card seconds of the kernels whose name holds one of
        `names` as a whole identifier (``tail_conv_cf_kernel`` matches
        ``void (anonymous namespace)::tail_conv_cf_kernel<4, false>(...)``
        and not ``tail_conv_cf_finish_kernel``)."""
        import re

        pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
            re.escape(n) for n in names) + r")(?![A-Za-z0-9_])")
        return sum(e - s for n, s, e, k in self.device_events
                   if k and pat.search(n)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the card's idle
        gaps summed by what the host was doing: the CUDA runtime call that
        overlapped the gap most, and the operation the gap ended in."""
        ops = collections.Counter()
        for n, s, e, _ in self.device_events:
            ops[n[:120]] += (e - s) / 1e9
        gaps = collections.Counter()
        evs = sorted(self.device_events, key=lambda t: t[1])
        host = sorted(self.host_events, key=lambda t: t[1])
        end, lo = None, 0
        for name, s, e, _ in evs:
            if end is not None and s > end:
                while lo < len(host) and host[lo][2] < end:
                    lo += 1
                best, best_ov, j = "no runtime call", 0, lo
                while j < len(host) and host[j][1] < s:
                    ov = min(s, host[j][2]) - max(end, host[j][1])
                    if ov > best_ov:
                        best, best_ov = host[j][0], ov
                    j += 1
                gaps[f"{best} > {_short(name)}"[:120]] += (s - end) / 1e9
            end = e if end is None else max(end, e)
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


def _short(kernel: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    if kernel.startswith(("Memcpy", "Memset")):
        return kernel
    base = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return base.split("<")[0].split()[-1].split("::")[-1] if base else kernel


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"
