"""The compressor's stage 1 (``methods.regress``): ``make_train_epoch``'s
``run_epoch`` over whole epochs of the clip at the traffic's batch, as the
CLI's ``_fit`` builds it: Adam (eps 1e-8) on every parameter, the lr the
CLI's schedule gives each step (``lr_type`` over ``epochs`` epochs), the
loss by name, the encoder's and decoder's forward and backward; each epoch
ends in its one fetch of the step PSNRs. No eval.

Set-up: epoch 0, which warms every shape up and during which the first
three steps are read (``capture.Steps``; their losses are the epoch's
own). The window holds the following epochs, whole, until one ends past
``--seconds`` (with the trace on, half of it, and a traced window of the
other half follows). End-to-end: ``train_step_ms``, the window's time over its
steps.

Correct: the plain reference follows the first three steps from the same
weights and frames: each step's loss, the first gradient as Adam got it
(the worst leaf), and the median leaf's change after the three (the worst
leaf's is a bias of a few elements whose change the card's run-to-run
rounding moves 20-fold on one seed)."""

from __future__ import annotations

import time

import torch

from nqbench import capture, core, judge, program, work


class State:
    pass


def setup(cell):
    from neuroquant_tpu_torch.methods.regress import make_train_epoch
    from neuroquant_tpu_torch.schedules import make_lr_schedule

    t = cell.traffic
    st = State()
    dev = st.dev = program.device(cell)
    st.model, st.cfg, st.sd = program.build(cell, dev)
    st.model.train()
    n = st.n = int(t["n_frames"])
    st.b = int(t["batch"])
    core.note("model built")
    st.frames = program.frames(cell, dev)
    st.norm_idx = torch.arange(n, dtype=torch.float32, device=dev) / n
    st.spe = n // st.b
    st.total = int(t["epochs"]) * st.spe
    schedule = make_lr_schedule(t["lr_type"], float(t["lr"]), st.total)
    st.names = [k for k, _ in st.model.named_parameters()]
    st.opt = torch.optim.Adam(st.model.parameters(), lr=schedule(0),
                              eps=1e-8)
    st.run_epoch = make_train_epoch(st.model, t["loss"], st.opt, schedule,
                                    st.frames, st.norm_idx, st.spe, st.b)
    core.note("frames made")
    st.order0 = core.epoch_order(n, cell.seed, 0, 0)
    st.steps = capture.Steps()
    try:
        losses, psnrs = st.run_epoch(st.order0, 0)
        psnrs.cpu()
    finally:
        st.steps.remove()
    core.note("epoch 0 done")
    st.losses0 = losses[:3].tolist()
    return st


def _epochs_for(st, cell, e, seconds):
    """Whole epochs after epoch `e` until one ends past `seconds`: (the
    last epoch, seconds, epoch ms a step)."""
    t0 = last = time.perf_counter()
    per_step = []
    while True:
        e += 1
        _, psnrs = st.run_epoch(core.epoch_order(st.n, cell.seed, 0, e),
                                e * st.spe)
        psnrs.cpu()                         # the epoch's one fetch
        now = time.perf_counter()
        per_step.append(1e3 * (now - last) / st.spe)
        last = now
        if now - t0 >= seconds:
            break
    core.sync(st.dev)
    return e, time.perf_counter() - t0, per_step


def window(st, cell, trace):
    """The timed window; with the trace on, it and a traced window after it
    share ``--seconds`` half and half (the per-layer metrics read the
    traced one, ``mfu_pct`` the timed one)."""
    span = cell.seconds / 2 if trace.enabled else cell.seconds
    core.sync(st.dev)
    before = program.launches()
    t_open = time.time()
    e, wall, per_step = _epochs_for(st, cell, 0, span)
    n_steps = last = e * st.spe
    out = {"steps": n_steps, "wall_s": wall, "failed": 0, "t_open": t_open,
           "e2e": {"train_step_ms": 1e3 * wall / n_steps},
           "epoch_step_ms": per_step}
    if trace.enabled:
        trace.start()
        events = core.Events(st.dev)
        events.open()
        e2, _, _ = _epochs_for(st, cell, e, span)
        events.close()
        core.sync(st.dev)
        trace.stop()
        last = e2 * st.spe
        out["traced_steps"], out["event_s"] = last - n_steps, \
            events.seconds()
    out["attempted"] = last
    w = work.module(cell)
    dw = program.launched(before, "tail_conv_dw_cf") / last
    out["work"] = {"kind": "train",
                   "flops": w.step_flops(st.cfg, st.b, "train"),
                   "tail_least_s": w.tail_least_s(
                       st.cfg, st.b, round(dw), ("fwd", "dx", "dw"))
                   if dw else None}
    return out


def _reference_steps(st, cell, tf32, frozen=False):
    """The reference's first three steps: {"loss", "grad", "change"} by
    leaf name; `frozen`, the fault that leaves the state unchanged."""
    from nqbench.reference import common

    ref = core.module("reference", cell.arch)
    t = cell.traffic
    leaves = {k: st.sd[k].clone().requires_grad_(True) for k in st.names}
    sd = dict(st.sd, **leaves)
    adam = common.Adam(list(leaves.values()), lr=float(t["lr"]))
    out = {"loss": [], "grad": None}
    for s in range(3):
        rows = st.order0[s * st.b:(s + 1) * st.b].to(st.dev)
        emb = ref.embed(sd, st.cfg, st.frames[rows], rows, st.n, tf32=tf32)
        y = ref.decode(sd, st.cfg, emb, tf32=tf32)
        if t["loss"] != "l2":
            raise ValueError("the reference's stage-1 loss is l2")
        loss = ((y - st.frames[rows]) ** 2).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves.values(), grads)]
        out["loss"].append(float(loss.detach()))
        if s == 0:
            out["grad"] = {k: g.detach().clone()
                           for k, g in zip(leaves, grads)}
        if not frozen:
            adam.step(grads, lr=common.lr_cosine(
                t["lr_type"], float(t["lr"]), s, st.total))
    out["change"] = {k: v.detach() - st.sd[k] for k, v in leaves.items()}
    return out


def judge_run(st, cell, control=False):
    """Frees the program, then the reference: [(name, value, limit)]. With
    `control` ('tf32' or True; 'frozen') the reference in TF32, or the
    reference whose steps leave the state unchanged, takes the program's
    place."""
    from nqbench.reference import common

    prog = st.steps.readings(0, st.names, st.losses0)
    for k in ("model", "opt", "run_epoch"):
        st.__dict__.pop(k, None)
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    with common.fp32_exact():
        ref = _reference_steps(st, cell, tf32=False)
        if control:
            prog = _reference_steps(st, cell, tf32=control != "frozen",
                                    frozen=control == "frozen")
    return judge.steps_checks("", prog, ref, cell.limits,
                              st.__dict__.setdefault("diag", {}),
                              step="median")
