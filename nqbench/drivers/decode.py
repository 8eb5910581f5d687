"""The viewer's decode: ``model.decode`` of the clip's embeddings in order,
cycled, `batch` frames a call, one closed-loop client that dispatches ahead
with no per-call synchronise (as ``methods/common.evaluate`` and
``eval_quantized`` call it, under ``no_grad``).

End-to-end: ``decode_fps``, the frames decoded over the whole window, which
ends in a synchronise; ``decode_call_p95_ms``, the 95th percentile over
every call of the window of the time from the previous call's completion
on the card to this one's (a CUDA event after each call, read after the
window): what a player sees between deliveries, stalls included.

Correct: the outputs of calls drawn from the seed, and of the last call,
kept as the window produced them, against the plain reference's decode of
the same frames, its embedding worked out again from the frames (HNeRV)
or the indices (NeRV)."""

from __future__ import annotations

import time

import numpy as np
import torch

from nqbench import core, judge, program, work

SAMPLE_RANGE = 2048     # calls the checked ones are drawn from
N_SAMPLES = 12


class State:
    pass


def setup(cell):
    st = State()
    dev = st.dev = program.device(cell)
    st.model, st.cfg, st.sd = program.build(cell, dev)
    st.model.eval()
    core.note("model built")
    n, b = int(cell.traffic["n_frames"]), int(cell.traffic["batch"])
    st.n, st.b = n, b
    st.norm_idx = torch.arange(n, dtype=torch.float32, device=dev) / n
    st.frames = program.frames(cell, dev) if cell.arch != "nerv" else None
    inputs = st.model.model_input(st.frames, st.norm_idx)
    with torch.no_grad():
        st.embeds = torch.cat([st.model.encode(inputs[i:i + 8])
                               for i in range(0, n, 8)])
    core.note("embedded")
    # batch k holds frames kb .. kb + b - 1 of the cycled clip
    n_batches = n // int(np.gcd(n, b))
    st.index = [torch.arange(k * b, k * b + b, device=dev) % n
                for k in range(n_batches)]
    st.batches = [st.embeds[i] for i in st.index]
    with torch.no_grad():
        for e in st.batches[:3]:
            st.model.decode(e)
    core.sync(dev)
    core.note("warmed up")
    rng = np.random.default_rng(cell.seed)
    st.sample = set(int(i) for i in rng.choice(SAMPLE_RANGE, N_SAMPLES,
                                               replace=False))
    return st


def _decode_for(st, seconds, i, kept, events):
    """Decode calls from call `i` on until `seconds` have passed, then a
    synchronise: (the next call's index, seconds, the last output)."""
    nb = len(st.batches)
    t0 = time.perf_counter()
    with torch.no_grad():
        while True:
            y = st.model.decode(st.batches[i % nb])
            if st.dev.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            if i in st.sample:
                kept[i] = y
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
    core.sync(st.dev)
    return i, time.perf_counter() - t0, y


def window(st, cell, trace):
    """The timed window; with the trace on, it and a traced window after it
    share ``--seconds`` half and half (the per-layer metrics read the
    traced one, ``mfu_pct`` the timed one)."""
    cuda = st.dev.type == "cuda"
    span = cell.seconds / 2 if trace.enabled else cell.seconds
    kept, events = {}, []
    before = program.launches()
    core.sync(st.dev)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t_open = time.time()
    i, wall, y = _decode_for(st, span, 0, kept, events)
    out = {"steps": i, "wall_s": wall, "t_open": t_open, "failed": 0,
           "e2e": {"decode_fps": i * st.b / wall}}
    if cuda:
        gaps = [start.elapsed_time(events[0])] + [
            events[k - 1].elapsed_time(events[k]) for k in range(1, i)]
        out["e2e"]["decode_call_p95_ms"] = float(np.percentile(gaps, 95))
    calls = i
    if trace.enabled:
        trace.start()
        events = core.Events(st.dev)
        events.open()
        calls, _, y = _decode_for(st, span, i, kept, [])
        events.close()
        core.sync(st.dev)
        trace.stop()
        out["traced_steps"], out["event_s"] = calls - i, events.seconds()
    kept[calls - 1] = y
    st.kept = kept
    out["attempted"] = calls * st.b
    tail = program.launched(before, "tail_conv_cf") / calls
    w = work.module(cell)
    out["work"] = {
        "kind": "decode",
        "flops": w.decode_flops(st.cfg, st.b),
        "tail_least_s": w.tail_least_s(st.cfg, st.b, round(tail),
                                       ("fwd",)) if tail else None}
    return out


def judge_run(st, cell, control=False):
    """Frees the program, then runs the reference over the kept calls:
    [(name, value, limit)]. With `control` the reference in TF32 takes the
    program's place."""
    from nqbench.reference import common

    ref = core.module("reference", cell.arch)
    kept = sorted(st.kept.items())
    for k in ("model", "batches", "embeds"):
        st.__dict__.pop(k, None)
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    worst = 0.0
    with torch.no_grad(), common.fp32_exact():
        for i, y in kept:
            idx = st.index[i % len(st.index)]
            frames = None if st.frames is None else st.frames[idx]
            emb = ref.embed(st.sd, st.cfg, frames, idx, st.n)
            want = ref.decode(st.sd, st.cfg, emb)
            if control:
                y = ref.decode(st.sd, st.cfg,
                               ref.embed(st.sd, st.cfg, frames, idx, st.n,
                                         tf32=True), tf32=True)
            worst = max(worst, float((y.float() - want).abs().max()))
    return [judge.check("decode_gap", worst, cell.limits)]
