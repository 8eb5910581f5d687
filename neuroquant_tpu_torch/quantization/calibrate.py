"""Network-wise PTQ calibration, NeuroQuant's key algorithm (the counterpart
of ``neuroquant_tpu/quantization/calibrate.py``).

Two phases over ground-truth frames:

  Phase 1 - every quantizer's scale (delta) with Adam(lr=1e-3) for
            int(0.05 * iters / steps_per_epoch) epochs, reconstruction loss
            only.
  Phase 2 - every quantizer swapped for AdaRound (alphas from the current
            rounding residues, deltas f16-cast) and all alphas trained with
            Adam(lr) for int(iters / steps_per_epoch) - phase-1 epochs, with
            the rounding regularizer weight * sum(1 - |2h(a) - 1|^b) and
            LinearTempDecay b: b_start -> b_end after `warmup * iters` steps.

The phases train different leaves of one QuantState (``_split_state``). A
step fake-quantizes the decoder's weights from the state, decodes a batch of
calibration embeddings with them (``torch.func.functional_call``) and takes
the loss against the frames; by default in the packed channels-first domain
(the model's ``decode_cf`` against ``tail_fused.pack_targets``), where the
decoder tail runs forward and backward on the CUDA kernels. With a
`compute_dtype` (bf16: ``calibrate_network --compute_dtype bfloat16``) the
fake-quantized parameters and the inputs are cast to it after the fp32
quantization and the decode runs in it (the tail on the kernels' bf16
instantiations); the prediction comes back to fp32 for the loss, and the
gradients reach the fp32 state through the cast, as in the JAX package.

An epoch is a Python loop over its shuffled batches (the JAX package scans
one jitted epoch). Shuffles come from a ``torch.Generator`` seeded from the
seed, the phase and the epoch index, so a resumed run replays them; a
caller may pass its own (``epoch_orders``). With a data-parallel `mesh`
(``parallel.launch``) every rank draws the same shuffles, decodes its rows
of each step's batch, and the gradients are summed over the ranks before
Adam (``parallel.data_parallel_step``).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from neuroquant_tpu_torch.metrics import lp_loss
from neuroquant_tpu_torch.parallel.mesh import (
    all_reduce_sum, check_batch, data_parallel_step, is_main, replicate,
    shard_batch)
from neuroquant_tpu_torch.quantization.qmodel import (
    adaround_upgrade, quantize_params, round_loss,
)
from neuroquant_tpu_torch.quantization.spec import QuantSpec
from neuroquant_tpu_torch.utils.device import synchronize

LOG_EVERY = 500     # steps between the loss log lines


class LinearTempDecay:
    """b: start_b until rel_start_decay * t_max, then linear to end_b at
    t_max, in fp32 as the JAX schedule computes it. With rel_start_decay
    >= 1 the decay never starts and b stays start_b (the JAX guard against
    the 0/0 at t == t_max)."""

    def __init__(self, t_max: int, rel_start_decay: float = 0.2,
                 start_b: int = 10, end_b: int = 2):
        self.t_max = t_max
        self.start_decay = rel_start_decay * t_max
        self.start_b = start_b
        self.end_b = end_b

    def __call__(self, t) -> float:
        if self.start_decay >= self.t_max:
            return float(self.start_b)
        if t < self.start_decay:
            return float(self.start_b)
        f32 = np.float32
        rel_t = ((f32(t) - f32(self.start_decay))
                 / f32(self.t_max - self.start_decay))
        ramp = f32(self.end_b) + f32(self.start_b - self.end_b) * max(
            f32(0.0), f32(1) - rel_t)
        return float(f32(ramp))


def _split_state(state: Dict, keys: Tuple[str, ...]):
    """(trainable, frozen): the leaves named in `keys` and the rest, per
    layer."""
    train = {ln: {k: v for k, v in s.items() if k in keys}
             for ln, s in state.items()}
    frozen = {ln: {k: v for k, v in s.items() if k not in keys}
              for ln, s in state.items()}
    return train, frozen


def _merge_state(train: Dict, frozen: Dict):
    return {ln: {**frozen[ln], **train[ln]} for ln in frozen}


class _Decoder(nn.Module):
    """`model.<method>` as a module's forward, for functional_call."""

    def __init__(self, model, method: str):
        super().__init__()
        self.model, self.method = model, method

    def forward(self, x, **kw):
        return getattr(self.model, self.method)(x, **kw)


def make_loss(model, params, spec: QuantSpec, mode: str, p: float = 2.0,
              cf_pack=None, loss_extra=None, compute_dtype=None):
    """The calibration loss: ``loss(state, img, inputs, count, share=None,
    extra=True) -> (total, (rec, rnd, b))``. The decoder's quantized layers
    are replaced by ``quantize_params(params, spec, state, mode,
    soft=True)``; gradients reach every state leaf that requires one. With
    `cf_pack`, `img` is a batch of ``cf_pack["gt"]`` and the loss runs in
    the packed domain; otherwise on NHWC frames through ``decode``. A
    data-parallel rank passes `share`, its rows over the global batch, so
    that the ranks' rec sum to the global batch's; and `extra` on rank 0
    only, so that the rounding term counts once. With `compute_dtype`
    every parameter the decode reads (the whole state dict, the layers
    that are not quantized too) and the inputs are cast to it after the
    quantization, which stays fp32 (the JAX ``loss_at``)."""
    dec = _Decoder(model, "decode_cf" if cf_pack is not None else "decode")
    keys = [f"{pre}.{leaf}" for pre in spec.layer_keys
            for leaf in ("weight", "bias")]
    if cf_pack is not None:
        cf_mask, cf_denom = cf_pack["mask"], float(cf_pack["denom"])
    # the parameters no step changes, cast once
    fixed = {} if compute_dtype is None else {
        f"model.{k}": v.detach().to(compute_dtype)
        for k, v in params.items() if k not in keys}

    def loss(state, img, inputs, count, share=None, extra=True):
        qp = quantize_params(params, spec, state, mode=mode, soft=True)
        swap = {f"model.{k}": qp[k] for k in keys}
        if compute_dtype is not None:
            swap = {**fixed, **{k: v.to(compute_dtype)
                                for k, v in swap.items()}}
            inputs = inputs.to(compute_dtype)
        pred = functional_call(dec, swap, (inputs,)).float()
        if cf_pack is not None:
            diff = (pred - img) * cf_mask
            d = diff * diff if p == 2.0 else torch.abs(diff) ** p
            # == lp_loss on the unpacked NHWC image: sum over channels,
            # mean over B*H*W
            rec = d.sum() / (img.shape[0] * cf_denom)
        else:
            rec = lp_loss(pred, img, p=p)
        if share is not None:
            rec = rec * share
        rnd, b = (loss_extra(state, count) if loss_extra is not None
                  else (0.0, 0.0))
        if not extra:
            rnd = 0.0
        return rec + rnd, (rec, rnd, b)

    return loss


def _epoch_order(train_ind, seed: int, phase: int, epoch: int):
    """The epoch's shuffle of the training frames."""
    g = torch.Generator().manual_seed(((int(seed) * 4 + phase) << 32) + epoch)
    t = torch.as_tensor(np.asarray(train_ind, np.int64))
    return t[torch.randperm(len(t), generator=g)]


def _run_phase(*, loss, state, cali_data, gt, trainable_keys, lr, epochs,
               steps_per_epoch, batch_size, order, count_offset=0,
               log_fn=logging.info, start_epoch=0,
               epoch_cb=None, opt_state0=None, mesh=None):
    """Adam over the trainable leaves for `epochs` epochs of
    `steps_per_epoch` batches; order(e) gives epoch e's frame order. With
    a data-parallel `mesh` the leaves start from rank 0's, each rank
    decodes its rows of each batch (a rank with none skips its decode and
    contributes zero gradients) and the gradients are summed over the
    ranks before Adam; the logged losses are summed too."""
    if epochs <= 0:
        return state, count_offset
    tstate, frozen = _split_state(state, trainable_keys)
    tstate = {ln: {k: v.detach().clone().requires_grad_(True)
                   for k, v in s.items()} for ln, s in tstate.items()}
    leaves = replicate([v for s in tstate.values() for v in s.values()],
                       mesh)
    opt = torch.optim.Adam(leaves, lr=lr, eps=1e-8)
    if opt_state0 is not None:
        opt.load_state_dict(opt_state0)

    def local_step(rows, count):
        """This rank's loss on its rows and its backward: (total, rec, rnd,
        b), the first three as tensors."""
        st = _merge_state(tstate, frozen)
        if mesh is None:
            total, (rec, rnd, b) = loss(st, gt[rows], cali_data[rows], count)
        elif len(rows):
            total, (rec, rnd, b) = loss(
                st, gt[rows], cali_data[rows], count,
                share=len(rows) / batch_size, extra=mesh.is_main)
        else:
            zero = gt.new_zeros(())
            return zero, zero, zero, 0.0
        total.backward()
        return total, rec, rnd, b

    step = data_parallel_step(local_step, mesh, leaves)
    count = count_offset
    for e in range(start_epoch, epochs):
        idx = torch.as_tensor(order(e), device=gt.device)
        batches = idx[:steps_per_epoch * batch_size].reshape(
            steps_per_epoch, batch_size)                # drop_last=True
        for s in range(steps_per_epoch):
            count += 1
            opt.zero_grad(set_to_none=True)
            total, rec, rnd, b = step(shard_batch(batches[s], mesh), count)
            opt.step()
            if count % LOG_EVERY == 0:
                logged = all_reduce_sum(torch.stack([
                    torch.as_tensor(v, dtype=gt.dtype, device=gt.device)
                    for v in (total, rec, rnd)]).detach(), mesh)
                total, rec, rnd = logged.tolist()
                log_fn("Total loss:\t{:.4f} (rec:{:.4f}, round:{:.4f})\t"
                       "b={:.2f}\tcount={}".format(
                           float(total), float(rec), float(rnd), float(b),
                           count))
        if epoch_cb is not None:
            epoch_cb(e, _merge_state(tstate, frozen), count, opt)
    state = {ln: {k: v.detach() for k, v in s.items()}
             for ln, s in _merge_state(tstate, frozen).items()}
    return state, count


def _cf_pack_auto(arch, model, frames, log_fn):
    """The packed-domain loss's targets, mask and denominator, or None when
    the model has no fused GELU tail."""
    import dataclasses

    from neuroquant_tpu_torch.models import tail_plan_for
    from neuroquant_tpu_torch.ops.tail_fused import border_mask, pack_targets

    try:
        tp = tail_plan_for(arch, dataclasses.asdict(model.cfg))
    except NotImplementedError as e:
        log_fn(f"[calib] cf_loss auto unavailable ({e}); NHWC loss")
        return None
    if tp is None:
        return None
    plan, f, ch = tp
    log_fn(f"[calib] cf_loss auto: packed-domain loss (f={f}, Mp={plan.mp})")
    return {"gt": pack_targets(frames, plan, f),
            "mask": border_mask(plan, ch=ch, device=frames.device),
            "denom": frames.shape[1] * frames.shape[2]}


def _state_to_numpy(state):
    return {ln: {k: v.detach().cpu().numpy() for k, v in s.items()}
            for ln, s in state.items()}


def _opt_to_cpu(opt_state):
    return {"state": {i: {k: v.detach().cpu() if torch.is_tensor(v) else v
                          for k, v in s.items()}
                      for i, s in opt_state["state"].items()},
            "param_groups": opt_state["param_groups"]}


def model_reconstruction(model, params, spec: QuantSpec, state: Dict,
                         cali_data, frames, train_ind, arch: str = "hnerv",
                         batch_size: int = 8, iters: int = 20000,
                         weight: float = 0.01,
                         b_range: Tuple[int, int] = (20, 2),
                         warmup: float = 0.0, p: float = 2.0,
                         lr: float = 0.0015, seed: int = 903,
                         log_fn=logging.info,
                         checkpoint_path: str | None = None,
                         ckpt_every_epochs: int = 25, cf_pack="auto",
                         rounding: str = "adaround",
                         adaround_only: tuple | None = None,
                         epoch_orders=None, mesh=None, epoch_hook=None,
                         compute_dtype=None):
    """Returns (calibrated QuantState, mode); decode the result with
    ``quantize_params(..., mode=mode, soft=False)``.

    model: the HNeRV or NeRV module, whose decoder the state's layers
    replace;
    params: its fp32 state dict (what the fake-quant reads); cali_data:
    the calibration embeddings in frame order; frames: the NHWC clip.
    rounding="adaround" runs both phases (mode 'adaround'); "nearest" runs
    phase 1 only (mode 'uaq'). adaround_only: mixed rounding, alphas for
    these layer names only. cf_pack: "auto" (the packed loss when the model
    has a fused tail), None (NHWC loss) or a {"gt", "mask", "denom"} dict.
    checkpoint_path: phase-2 progress (state, Adam moments, count) every
    `ckpt_every_epochs` epochs; an existing file resumes the run exactly.
    epoch_orders(phase, epoch) -> frame indices, phase 1 or 2: the
    shuffles to use instead of the seeded generator's. mesh: a
    data-parallel ``parallel.Mesh``; every rank calls this with the same
    arguments, and only rank 0 writes the checkpoint. epoch_hook(epoch,
    count, state): called after every phase-2 epoch (a throughput probe
    synchronises there). compute_dtype: the decode's dtype in both phases
    (:func:`make_loss`; None: fp32); the state, its checkpoint and the
    Adam moments stay fp32."""
    assert rounding in ("adaround", "nearest"), rounding
    check_batch(model, batch_size, mesh)
    if rounding == "nearest":
        checkpoint_path = None
    if isinstance(cf_pack, str) and cf_pack == "auto":
        cf_pack = _cf_pack_auto(arch, model, frames, log_fn)
    gt = cf_pack["gt"] if cf_pack is not None else frames
    steps_per_epoch = len(train_ind) // batch_size
    assert steps_per_epoch > 0, "batch_size larger than the training split"

    def order_for(phase):
        if epoch_orders is not None:
            return lambda e: np.asarray(epoch_orders(phase, e), np.int64)
        return lambda e: _epoch_order(train_ind, seed, phase, e)

    resume = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path, "rb") as f:
            resume = pickle.load(f)
        log_fn(f"[calib] resuming from {checkpoint_path}: "
               f"phase2 epoch {resume['epoch'] + 1}, count {resume['count']}")

    def save_ckpt(epoch, st, count, opt):
        if checkpoint_path is None or not is_main(mesh):
            return
        with open(checkpoint_path + ".tmp", "wb") as f:
            pickle.dump({"epoch": epoch, "count": count,
                         "state": _state_to_numpy(st),
                         "opt_state": _opt_to_cpu(opt.state_dict())}, f)
        os.replace(checkpoint_path + ".tmp", checkpoint_path)

    device = gt.device
    # ---- Phase 1: scales ----
    epochs1 = int(0.05 * iters / steps_per_epoch)
    if resume is None:
        t0 = time.time()
        state, _ = _run_phase(
            loss=make_loss(model, params, spec, "uaq", p, cf_pack,
                           compute_dtype=compute_dtype),
            state=state, cali_data=cali_data, gt=gt,
            trainable_keys=("w_delta", "b_delta"), lr=0.001, epochs=epochs1,
            steps_per_epoch=steps_per_epoch, batch_size=batch_size,
            order=order_for(1), log_fn=log_fn, mesh=mesh)
        synchronize(device)
        log_fn(f"[calib] phase 1 (delta): {epochs1} epochs x "
               f"{steps_per_epoch} steps in {time.time() - t0:.1f}s")

    if rounding == "nearest":
        log_fn("[calib] rounding=nearest: phase 2 skipped; state stays UAQ "
               "(round-to-nearest with the phase-1-calibrated scales)")
        return state, "uaq"

    # ---- Phase 2: AdaRound alphas ----
    opt_state0 = None
    if resume is None:
        state = adaround_upgrade(params, spec, state, only=adaround_only)
        if adaround_only is not None:
            log_fn(f"[calib] mixed rounding: adaround on "
                   f"{sorted(adaround_only)}; nearest elsewhere")
        start_epoch, count0 = 0, 0
    else:
        state = {ln: {k: torch.as_tensor(v, device=device)
                      for k, v in s.items()}
                 for ln, s in resume["state"].items()}
        start_epoch, count0 = resume["epoch"] + 1, resume["count"]
        opt_state0 = resume["opt_state"]
    temp = LinearTempDecay(iters, rel_start_decay=warmup,
                           start_b=b_range[0], end_b=b_range[1])
    loss_start = iters * warmup

    def loss_extra(st, count):
        if count < loss_start:
            return 0.0, 0.0
        b = temp(count)
        return round_loss(st, spec, b, weight), b

    def epoch_cb(e, st, count, opt):
        if epoch_hook is not None:
            epoch_hook(e, count, st)
        if ckpt_every_epochs > 0 and (e + 1) % ckpt_every_epochs == 0:
            save_ckpt(e, st, count, opt)

    epochs2 = int(iters / steps_per_epoch) - epochs1
    t0 = time.time()
    state, count = _run_phase(
        loss=make_loss(model, params, spec, "adaround", p, cf_pack,
                       loss_extra, compute_dtype=compute_dtype),
        state=state, cali_data=cali_data, gt=gt,
        trainable_keys=("w_alpha", "b_alpha"), lr=lr, epochs=epochs2,
        steps_per_epoch=steps_per_epoch, batch_size=batch_size,
        order=order_for(2), log_fn=log_fn, start_epoch=start_epoch,
        count_offset=count0, epoch_cb=epoch_cb, opt_state0=opt_state0,
        mesh=mesh)
    synchronize(device)
    dt = time.time() - t0
    n_steps = (epochs2 - start_epoch) * steps_per_epoch
    log_fn(f"[calib] phase 2 (alpha): {epochs2} epochs x {steps_per_epoch} "
           f"steps in {dt:.1f}s ({n_steps / max(dt, 1e-9):.1f} iters/s)")
    return state, "adaround"
