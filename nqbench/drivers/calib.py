"""The compressor's network-wise calibration (NeuroQuant's stage 3):
``quantization.calibrate.model_reconstruction`` at the traffic's batch
over the clip's embeddings, with the traffic's precision, Hadamard,
channel-wise max scales, lr and fake-quant implementation, the loss in the
packed domain as the CLI's ``--cf_loss auto`` gives it, no checkpoints.

The schedule is shortened as the program's ``bench.py`` shortens it:
``iters`` sets phase 1 to int(0.05 * iters / steps an epoch) epochs and
phase 2 to the rest; the rounding regulariser starts at ``warmup * iters``
(0: on in every phase-2 step). A phase-2 step's work is a full run's.

Set-up: phase 1 and the first phase-2 epoch, during which the first three
steps of each phase are read (``capture.Steps``, and the reconstruction
loss each of them returns, the part of the loss the decode sets; a wrapper
round the program's ``make_loss`` reads it, one Python call a step, which
stays in the window). The window opens at the end of that epoch and
closes at the first epoch end past ``--seconds`` (with the trace on, past
half of it, and a traced window of the other half follows), from the
call's ``epoch_hook``.
End-to-end: ``calib_step_ms``, the window's time over its phase-2 steps.

Correct: the plain reference runs the whole of phase 1 from its own
initial scales (held exactly against the program's) over the program's
batches, and follows phase 2's first three steps. Phase 1: its first
three steps, and the change of the leaves over the whole phase
(``p1_end_median_gap``: the median moving leaf's gap of norms; the worst
leaf is a bias's scale, one number, whose Adam steps follow the sign of
a gradient that the roundings flipping between the two sides move).
Phase 2 starts from the program's scales after phase 1, the float16
hand-off held exactly against the program's last phase-1 step, the
alphas' initial values exactly against the reference's."""

from __future__ import annotations

import statistics
import time

import torch

from nqbench import capture, core, judge, program, work


class State:
    pass


class _WindowEnd(Exception):
    pass


def _names(spec, keys):
    return [f"{ln}/{k}" for ln in spec.layer_names for k in keys]


def quant_prefixes(arch: str, cfg) -> list:
    """The quantized convs' state-dict prefixes in calibration order: the
    architecture's reference module's ``quant_prefixes`` where it defines
    one, else HNeRV's and NeRV's (``reference/common.py``)."""
    from nqbench.reference import common

    ref = core.module("reference", arch)
    return getattr(ref, "quant_prefixes", common.quant_prefixes)(cfg)


def setup(cell):
    from neuroquant_tpu_torch.quantization import init_quant_state, make_spec

    t = cell.traffic
    st = State()
    dev = st.dev = program.device(cell)
    st.model, st.cfg, st.sd = program.build(cell, dev)
    st.model.eval()
    core.note("model built")
    n = st.n = int(t["n_frames"])
    st.b = int(t["batch"])
    st.frames = program.frames(cell, dev)
    norm_idx = torch.arange(n, dtype=torch.float32, device=dev) / n
    inputs = st.model.model_input(st.frames, norm_idx)
    with torch.no_grad():
        st.cali = torch.cat([st.model.encode(inputs[i:i + 8])
                             for i in range(0, n, 8)])
    core.note("embedded")
    st.params = {k: v.detach().clone()
                 for k, v in st.model.state_dict().items()}
    st.spec = make_spec(cell.arch, st.cfg, channel_wise=t["channel_wise"],
                        scale_method=t["scale_method"],
                        hadamard=t["hadamard"],
                        fq_impl=t["fq_impl"]).with_bits(t["precision"])
    st.state = init_quant_state(st.params, st.spec)
    st.steps_per_epoch = n // st.b
    st.epochs1 = int(0.05 * int(t["iters"]) / st.steps_per_epoch)
    if st.epochs1 < 1:
        raise ValueError("the traffic's iters leave phase 1 no epoch")
    st.orders = {(p, e): core.epoch_order(n, cell.seed, p, e).numpy()
                 for p in (1, 2) for e in (0,)}
    return st


def window(st, cell, trace):
    from neuroquant_tpu_torch.quantization import calibrate

    t = cell.traffic
    seed = cell.seed

    def orders(phase, epoch):
        if (phase, epoch) not in st.orders:
            st.orders[(phase, epoch)] = core.epoch_order(
                st.n, seed, phase, epoch).numpy()
        return st.orders[(phase, epoch)]

    steps = capture.Steps(last={0: st.epochs1 * st.steps_per_epoch})
    losses = []
    make_loss = calibrate.make_loss

    def recording(*a, **k):
        fn = make_loss(*a, **k)
        mine = []
        losses.append(mine)

        def loss(*la, **lk):
            out = fn(*la, **lk)
            if len(mine) < 3:       # the reconstruction loss
                mine.append(out[1][0].detach().clone())
            return out
        return loss

    mark = {"epoch_step_ms": []}
    events = core.Events(st.dev)
    # with the trace on, the timed and the traced window share --seconds
    span = cell.seconds / 2 if trace.enabled else cell.seconds

    def hook(e, count, state):
        now = time.perf_counter()
        if e == 0:
            core.note("phase 1 and a phase-2 epoch done")
            steps.remove()
            st.p2_state = {ln: {k: v.detach().clone() for k, v in s.items()}
                           for ln, s in state.items()}
            core.sync(st.dev)
            mark["t_open"] = time.time()
            mark["before"] = program.launches()
            mark["t0"] = mark["last"] = time.perf_counter()
            mark["count0"] = mark["last_count"] = count
            return
        if "count1" not in mark:
            mark["epoch_step_ms"].append(
                1e3 * (now - mark["last"]) / (count - mark["last_count"]))
            mark["last"], mark["last_count"] = now, count
            if now - mark["t0"] < span:
                return
            core.sync(st.dev)
            mark["wall"] = time.perf_counter() - mark["t0"]
            mark["count1"] = mark["count3"] = count
            if not trace.enabled:
                raise _WindowEnd
            trace.start()
            events.open()
            mark["t1"], mark["count2"] = time.perf_counter(), count
            return
        if now - mark["t1"] >= span:
            events.close()
            mark["count3"] = count
            raise _WindowEnd

    calibrate.make_loss = recording
    try:
        calibrate.model_reconstruction(
            st.model, st.params, st.spec, st.state, st.cali, st.frames,
            list(range(st.n)), arch=cell.arch, batch_size=st.b,
            iters=int(t["iters"]), weight=float(t["weight"]),
            b_range=tuple(t["b_range"]), warmup=float(t["warmup"]),
            p=float(t["p"]), lr=float(t["lr"]), seed=seed,
            log_fn=lambda *a: None, checkpoint_path=None, cf_pack="auto",
            epoch_orders=orders, epoch_hook=hook)
        raise RuntimeError("phase 2 ended before the window closed: raise "
                           "the traffic's iters")
    except _WindowEnd:
        pass
    finally:
        calibrate.make_loss = make_loss
        steps.remove()
    core.sync(st.dev)
    trace.stop()
    n_steps = mark["count1"] - mark["count0"]
    total = mark["count3"] - mark["count0"]
    st.steps, st.losses = steps, losses
    w = work.module(cell)
    dw = program.launched(mark["before"], "tail_conv_dw_cf") / total
    out = {"steps": n_steps, "wall_s": mark["wall"], "attempted": total,
           "failed": 0, "t_open": mark["t_open"],
           "e2e": {"calib_step_ms": 1e3 * mark["wall"] / n_steps},
           "epoch_step_ms": mark["epoch_step_ms"],
           "work": {"kind": "calib",
                    "flops": w.step_flops(st.cfg, st.b, "calib"),
                    "tail_least_s": w.tail_least_s(
                        st.cfg, st.b, round(dw), ("fwd", "dx", "dw"))
                    if dw else None}}
    if trace.enabled:
        out["traced_steps"] = total - n_steps
        out["event_s"] = events.seconds()
    return out


def _reference_steps(st, cell, phase, start, tf32, rows_used=None,
                     frozen=False, n_steps=3):
    """The reference's first `n_steps` steps of `phase` from the layer
    states `start` (reference shapes), over the same batches as the
    program's: {"loss", "grad", "change"} of the first three steps by leaf
    name, and "end", the leaves' change after all of them. `rows_used`:
    the rows of each batch it takes (all where None; the half-batch fault
    takes half), the loss the mean over them; `frozen`, the fault that
    leaves the state unchanged."""
    from nqbench.reference import common

    ref = core.module("reference", cell.arch)
    t = cell.traffic
    prefixes = quant_prefixes(cell.arch, st.cfg)
    bits = [int(x) for x in t["precision"]]
    keys = ("w_delta", "b_delta") if phase == 1 else ("w_alpha", "b_alpha")
    mode = "uaq" if phase == 1 else "adaround"
    names = _names(st.spec, keys)
    leaves = [start[ln][k].clone().requires_grad_(True)
              for ln in st.spec.layer_names for k in keys]
    live = dict(zip(names, leaves))
    adam = common.Adam(leaves, lr=0.001 if phase == 1 else float(t["lr"]))
    h, w = int(st.cfg["crop_h"]), int(st.cfg["crop_w"])
    out = {"loss": [], "grad": None}

    def changes():
        return {name: v.detach() - start[ln][k] for (name, v), (ln, k) in
                zip(live.items(), [n.rsplit("/", 1) for n in live])}

    for s in range(3 if frozen else n_steps):
        at = (s % st.steps_per_epoch) * st.b
        rows = torch.as_tensor(
            st.orders[(phase, s // st.steps_per_epoch)][at:at + st.b],
            device=st.dev)[:rows_used]
        with torch.no_grad():
            emb = ref.embed(st.sd, st.cfg, st.frames[rows], rows, st.n,
                            tf32=tf32)
        sd = dict(st.sd)
        for ln, pre, nb in zip(st.spec.layer_names, prefixes, bits):
            lay = {k: v for k, v in start[ln].items()}
            lay.update({k: live[f"{ln}/{k}"] for k in keys})
            sd[pre + ".weight"], sd[pre + ".bias"] = common.fake_quant(
                st.sd[pre + ".weight"], st.sd[pre + ".bias"], lay, nb, mode)
        y = ref.decode(sd, st.cfg, emb, tf32=tf32)
        loss = ((y - st.frames[rows]) ** 2).sum() / (len(rows) * h * w)
        if s < 3:
            out["loss"].append(float(loss.detach()))
        if phase == 2:
            b = common.temp_b(s + 1, int(t["iters"]), float(t["warmup"]),
                              *t["b_range"])
            loss = loss + common.round_reg(
                [live[f"{ln}/w_alpha"] for ln in st.spec.layer_names], b,
                float(t["weight"]))
        grads = torch.autograd.grad(loss, leaves)
        if s == 0:
            out["grad"] = {k: g.detach().clone()
                           for k, g in zip(names, grads)}
        if not frozen:
            adam.step(grads)
        if s == 2:
            out["change"] = changes()
    out["end"] = changes()
    return out


def judge_run(st, cell, control=False):
    """Frees the program, then the reference: [(name, value, limit)]. With
    `control` ('tf32' or True; 'half_batch'; 'frozen') the reference in
    TF32, or the reference that leaves out half of each batch, or whose
    steps leave the state unchanged, takes the program's place. The
    reference's own readings are kept for a second call."""
    from nqbench.reference import common

    for k in ("model", "cali", "params", "state"):
        st.__dict__.pop(k, None)
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    lim = cell.limits
    prefixes = quant_prefixes(cell.arch, st.cfg)
    bits = [int(x) for x in cell.traffic["precision"]]
    n1 = st.epochs1 * st.steps_per_epoch
    with common.fp32_exact():
        init = {ln: common.init_scales(st.sd[p + ".weight"],
                                       st.sd[p + ".bias"], nb)
                for ln, p, nb in zip(st.spec.layer_names, prefixes, bits)}
        p1_names = _names(st.spec, ("w_delta", "b_delta"))
        p2_names = _names(st.spec, ("w_alpha", "b_alpha"))
        prog1 = st.steps.readings(0, p1_names, st.losses[0])
        prog2 = st.steps.readings(1, p2_names, st.losses[1])
        # phase 1's end: the change of the program's last phase-1 leaves
        prog1["end"] = {k: v - prog1["start"][k] for k, v in zip(
            p1_names, st.steps.at[0])}
        # the program's phase-2 start in the reference's shapes
        p2 = {}
        for ln, p in zip(st.spec.layer_names, prefixes):
            w = st.sd[p + ".weight"]
            s = st.p2_state[ln]
            p2[ln] = {"w_delta": s["w_delta"].reshape(-1, 1, 1, 1),
                      "w_zp": s["w_zp"].reshape(-1, 1, 1, 1),
                      "b_delta": s["b_delta"], "b_zp": s["b_zp"]}
            p2[ln]["w_alpha"] = common.init_alpha(common.to_domain(w),
                                                  p2[ln]["w_delta"])
            p2[ln]["b_alpha"] = common.init_alpha(st.sd[p + ".bias"],
                                                  s["b_delta"])
        init_gap = max(_exact(prog1["start"][f"{ln}/{k}"], init[ln][k])
                       for ln in st.spec.layer_names
                       for k in ("w_delta", "b_delta"))
        last1 = dict(zip(p1_names, st.steps.at[0]))
        handoff = max(_exact(common.f16_delta(last1[f"{ln}/{k}"]),
                             st.p2_state[ln][k])
                      for ln in st.spec.layer_names
                      for k in ("w_delta", "b_delta"))
        # the program's weight alphas are HWIO, the reference's OHWI
        alpha_gap = max(
            _exact(prog2["start"][f"{ln}/w_alpha"].permute(3, 0, 1, 2),
                   p2[ln]["w_alpha"]) for ln in st.spec.layer_names)
        alpha_gap = max([alpha_gap] + [
            _exact(prog2["start"][f"{ln}/b_alpha"], p2[ln]["b_alpha"])
            for ln in st.spec.layer_names])
        if "ref" not in st.__dict__:
            st.ref = (_reference_steps(st, cell, 1, init, False,
                                       n_steps=n1),
                      _reference_steps(st, cell, 2, p2, False))
        ref1, ref2 = st.ref
        if control:
            half = st.b // 2 if control == "half_batch" else None
            tf32 = control in (True, "tf32")
            frozen = control == "frozen"
            prog1 = _reference_steps(st, cell, 1, init, tf32, half, frozen,
                                     n_steps=n1)
            prog2 = _reference_steps(st, cell, 2, p2, tf32, half, frozen)
    diag = st.__dict__.setdefault("diag", {})
    end = judge.leaf_gaps(_flat(prog1)["end"], _flat(ref1)["end"],
                          judge.moving(ref1["grad"]))
    diag["p1_end"] = end
    return ([judge.check("p1_init_gap", init_gap, lim)]
            + judge.steps_checks("p1_", _flat(prog1), _flat(ref1), lim, diag)
            + [judge.check("p1_end_median_gap",
                           statistics.median(end.values()), lim),
               judge.check("handoff_gap", handoff, lim),
               judge.check("p2_init_gap", alpha_gap, lim)]
            + judge.steps_checks("p2_", _flat(prog2), _flat(ref2), lim,
                                 diag))


def _flat(r):
    out = {k: {n: v.reshape(-1) for n, v in r[k].items()}
           for k in ("grad", "change", "end") if k in r}
    out["loss"] = r["loss"]
    return out


def _exact(a, b) -> float:
    """The largest difference of two tensors of equal size, flattened."""
    a, b = a.reshape(-1), b.reshape(-1)
    if a.numel() != b.numel():
        raise RuntimeError(f"sizes differ: {a.numel()} and {b.numel()}")
    return float((a.float() - b.float()).abs().max())

