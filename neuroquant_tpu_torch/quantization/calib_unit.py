"""Block-wise and layer-wise calibration, the BRECQ/AdaRound baselines (the
counterpart of ``neuroquant_tpu/quantization/calib_unit.py``).

Each quantized conv (a "unit": decoder[0], each NeRVBlock's conv, the
head, in quant-traversal order) is reconstructed against its own cached
FP32 output, where NeuroQuant's network-wise calibration
(``quantization/calibrate.py``) reconstructs the frames. With
``include_act=True`` (block scope) a NeRVBlock unit's output is conv ->
pixel shuffle -> activation; with False (layer scope) the raw conv output.

The units' FP inputs and outputs come from the decode's plain unpacked
chain (``decode(..., return_embeds=True)``, cuDNN convs), in NHWC: the
``shared`` cache holds every unit's pair in fp32, the ``stream`` cache one
unit's pair (in bf16 in the CLI), freed when the unit ends. The objectives
are the reference's: ``mse`` (``metrics.lp_loss``, summed over the
channel axis, the last of the NHWC cache), ``fisher_diag`` and
``fisher_full`` (the squared error weighted by the cached |dMSE(fp,
quant) / d(unit output)| + 1, :func:`harvest_unit_grads`), and QDrop
(``input_prob < 1``: each input element drawn from the FP input or from
the input under the quantized prefix).

The loop is a Python loop of ``torch.optim.Adam`` steps over the unit's
AdaRound alphas (the JAX package scans 500 jitted steps); each step's
minibatch indices and QDrop draws come from ``torch.Generator``\\ s seeded
with ``seed`` (callers may pass their own, ``minibatch_indices`` and
``qdrop_masks``). A unit's conv runs on cuDNN, as the JAX package's on
XLA; its weight's soft AdaRound fake-quant is the plain chain under
``fq_impl='jnp'`` and the grouped fake-quant kernel with its backward
kernel (``ops/fused_fakequant.py``) under ``'pallas'``. The loss stays on
the device for a chunk of ``CHUNK`` steps: one host synchronisation, the
chunk's log line.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import torch
import torch.nn.functional as F
from torch.func import functional_call

from neuroquant_tpu_torch.metrics import lp_loss
from neuroquant_tpu_torch.models.layers import activation, norms_over_batch
from neuroquant_tpu_torch.ops import quant as Q
from neuroquant_tpu_torch.ops.fused_fakequant import (
    fake_quant_group, fake_quant_ref)
from neuroquant_tpu_torch.ops.pixelshuffle import pixel_shuffle
from neuroquant_tpu_torch.ops.tail_fused import out_img
from neuroquant_tpu_torch.quantization.calibrate import (
    LinearTempDecay, _Decoder)
from neuroquant_tpu_torch.quantization.qmodel import (
    _get, adaround_upgrade, quantize_params)
from neuroquant_tpu_torch.quantization.spec import QuantSpec
from neuroquant_tpu_torch.utils.device import synchronize

CHUNK = 500          # steps between the loss lines (the JAX scan's length)
HARVEST_BATCH = 10   # frames per harvest decode (the reference's caching)


def _decode(model, params, x, **kw):
    """``model.decode(x, **kw)`` with the state dict `params` in place of
    the model's own weights."""
    return functional_call(_Decoder(model, "decode"),
                           {f"model.{k}": v for k, v in params.items()},
                           (x,), kw)


def _unit_meta(model, unit_idx: int):
    """(stride, activation) of the unit at quant-traversal position
    `unit_idx` in the NeRV/HNeRV decoder: [decoder0, blocks..., head]."""
    cfg = model.cfg
    n_blocks = len(cfg.dec_strides)
    if unit_idx == 0 or unit_idx == n_blocks + 1:
        return 1, None
    return cfg.dec_strides[unit_idx - 1], activation(cfg.dec_acts)


def _conv(x, kernel, bias, pad: int):
    """NHWC 'same' conv with an HWIO kernel (cuDNN, channels-last)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias,
                 padding=pad)
    return y.permute(0, 2, 3, 1)


def _apply_unit(x, kernel, bias, stride: int, kernel_size: int, act):
    """One unit: conv, then its pixel shuffle and activation."""
    y = _conv(x, kernel, bias, (kernel_size - 1) // 2)
    if stride != 1:
        y = pixel_shuffle(y, stride)
    if act is not None:
        y = act(y)
    return y


def _head_conv(x, kernel, bias):
    return _conv(x, kernel, bias, 1)


def _decode_from(model, params, spec: QuantSpec, y, unit_idx: int,
                 from_conv_out: bool = False):
    """The FP decode from unit `unit_idx`'s output on to the frames (after
    out_img), on the plain chain. `from_conv_out`: y is the raw conv output
    of a NeRVBlock unit (a layer-scope tap), so its shuffle and activation
    run first."""
    cfg = model.cfg
    n_blocks = len(cfg.dec_strides)
    x = y
    if from_conv_out and 1 <= unit_idx <= n_blocks:
        stride, act = _unit_meta(model, unit_idx)
        if stride != 1:
            x = pixel_shuffle(x, stride)
        if act is not None:
            x = act(x)
    if unit_idx == 0:
        x = pixel_shuffle(x, (cfg.fc_h, cfg.fc_w))
    for k in range(max(unit_idx + 1, 1), n_blocks + 1):
        w, b = _get(params, spec.layer_keys[k])
        stride, act = _unit_meta(model, k)
        x = _apply_unit(x, w, b, stride, w.shape[0], act)
    if unit_idx <= n_blocks:
        x = _head_conv(x, *_get(params, spec.layer_keys[-1]))
    return out_img(x, cfg.out_bias)


@torch.no_grad()
def harvest_unit_io(model, params, arch: str, spec: QuantSpec, cali_data,
                    batch_size: int = HARVEST_BATCH, only: int | None = None,
                    cache_dtype=None):
    """{unit: (FP input, FP output)} over `cali_data`, NHWC, from
    ``decode(..., return_embeds=True)`` with the state dict `params`:
    embeds = [embed, decoder0 out, block0 out, ..., blockN out]. decoder0's
    unit output is its raw conv output (NeRV's embeds[1] is after the fc
    shuffle, so it is recomputed from the kernel, as the head's logits
    are). `only`: that unit's pair alone (the stream cache). `cache_dtype`:
    the pairs' dtype (bf16 halves the cache; the loss upcasts per
    minibatch). The taps are the same for both scopes; `arch` is unused,
    as in the JAX signature."""
    cfg = model.cfg
    n_blocks = len(cfg.dec_strides)
    w0, b0 = _get(params, spec.layer_keys[0])
    wh, bh = _get(params, spec.layer_keys[-1])
    outs: Dict[int, tuple] = {}
    for s in range(0, cali_data.shape[0], batch_size):
        _, embeds = _decode(model, params, cali_data[s:s + batch_size],
                            return_embeds=True)
        y0 = _apply_unit(embeds[0], w0, b0, 1, w0.shape[0], None)
        taps = {0: (embeds[0], y0)}
        blk_in = pixel_shuffle(y0, (cfg.fc_h, cfg.fc_w))
        for k in range(n_blocks):
            taps[k + 1] = (blk_in, embeds[2 + k])
            blk_in = embeds[2 + k]
        taps[n_blocks + 1] = (blk_in, _head_conv(blk_in, wh, bh))
        if only is not None:
            taps = {only: taps[only]}
        for k, (i, o) in taps.items():
            if cache_dtype is not None:
                i, o = i.to(cache_dtype), o.to(cache_dtype)
            outs.setdefault(k, ([], []))
            outs[k][0].append(i)
            outs[k][1].append(o)
    return {k: (torch.cat(i), torch.cat(o)) for k, (i, o) in outs.items()}


def _unit_grads(model, params, spec: QuantSpec, state: Dict, unit_idx: int,
                cali_data, include_act: bool, batch_size: int):
    """d MSE(fp, pred) / d(unit output) per calibration sample, one batch
    at a time (see :func:`harvest_unit_grads`)."""
    with torch.no_grad():
        qparams = quantize_params(params, spec, state, mode="uaq",
                                  upto=unit_idx)
    cfg = model.cfg
    n_blocks = len(cfg.dec_strides)
    layer_mode = unit_idx == 0 or not include_act
    for s in range(0, cali_data.shape[0], batch_size):
        x = cali_data[s:s + batch_size]
        with torch.no_grad():
            fp = _decode(model, params, x)
            _, embeds = _decode(model, qparams, x, return_embeds=True)
            if layer_mode:
                # the raw conv output of the (quantized) unit
                if unit_idx == 0:
                    xin = embeds[0]
                elif unit_idx == 1:
                    w0, b0 = _get(qparams, spec.layer_keys[0])
                    xin = pixel_shuffle(
                        _apply_unit(embeds[0], w0, b0, 1, w0.shape[0], None),
                        (cfg.fc_h, cfg.fc_w))
                else:
                    xin = embeds[unit_idx]      # the previous block's output
                w, b = _get(qparams, spec.layer_keys[unit_idx])
                y_q = _apply_unit(xin, w, b, 1, w.shape[0], None)
                from_conv = unit_idx != 0 and unit_idx <= n_blocks
            else:
                y_q = (embeds[1 + unit_idx] if unit_idx <= n_blocks
                       else _head_conv(embeds[1 + n_blocks],
                                       *_get(qparams, spec.layer_keys[-1])))
                from_conv = False
        y_q = y_q.detach().requires_grad_(True)
        pred = _decode_from(model, params, spec, y_q, unit_idx,
                            from_conv_out=from_conv)
        loss = ((fp - pred) ** 2).mean(dim=(1, 2, 3)).sum()
        yield torch.autograd.grad(loss, y_q)[0]


def harvest_unit_grads(model, params, spec: QuantSpec, state: Dict,
                       unit_idx: int, cali_data, include_act: bool = True,
                       batch_size: int = HARVEST_BATCH, cache_dtype=None):
    """|d MSE(fp, pred) / d(unit output)| + 1 per calibration sample (the
    reference's fisher gradient cache): the prefix through `unit_idx` runs
    UAQ-quantized (``quantize_params(..., upto=unit_idx)``), the suffix FP
    on the plain chain (:func:`_decode_from`), against the FP decode `fp`
    on the model's kernel path; the loss is each sample's mean MSE. The
    JAX package vmaps a batch-1 gradient. Where a decoder's samples do not
    interact, one backward of the batch's summed per-sample means gives
    every sample's gradient; a decoder with a batch norm (``dec_norm:
    batch``) takes its statistics over the batch, so it decodes each
    sample alone, as JAX's batch of one does."""
    if norms_over_batch(model):
        batch_size = 1
    grads = []
    for g in _unit_grads(model, params, spec, state, unit_idx, cali_data,
                         include_act, batch_size):
        g = g.abs() + 1.0
        grads.append(g if cache_dtype is None else g.to(cache_dtype))
    return torch.cat(grads)


class UnitProblem:
    """One unit's reconstruction problem: its cached FP input and target
    (and fisher gradients, QDrop inputs), its weight, its starting
    AdaRound state and the loss. ``loss(tr, idx, count, draws)`` is the
    step's objective for the trainable alphas `tr` on the cached samples
    `idx` at step `count` (from 1); `draws`: QDrop's uniform draws, of the
    minibatch input's shape."""

    def __init__(self, model, params, spec: QuantSpec, state: Dict,
                 unit_idx: int, cali_data, include_act: bool = True,
                 iters: int = 20000, weight: float = 0.01, b_range=(20, 2),
                 warmup: float = 0.0, p: float = 2.0,
                 opt_mode: str = "mse", input_prob: float = 1.0,
                 log_fn=logging.info, io=None, cache_dtype=None):
        if opt_mode not in ("mse", "fisher_diag", "fisher_full"):
            raise ValueError(f"Unsupported reconstruction loss: {opt_mode}")
        self.spec, self.unit_idx = spec, unit_idx
        self.name = spec.layer_names[unit_idx]
        self.bits = spec.n_bits[unit_idx]
        self.w, self.b = _get(params, spec.layer_keys[unit_idx])
        self.kernel_size = self.w.shape[0]
        self.stride, self.act = _unit_meta(model, unit_idx)
        if not include_act:
            self.stride, self.act = 1, None
        self.opt_mode, self.input_prob, self.p = opt_mode, input_prob, p
        self.weight = weight
        self.temp = LinearTempDecay(iters, rel_start_decay=warmup,
                                    start_b=b_range[0], end_b=b_range[1])
        self.loss_start = iters * warmup
        device = cali_data.device

        if io is None:
            t0 = time.time()
            io = harvest_unit_io(model, params, "", spec, cali_data,
                                 only=unit_idx, cache_dtype=cache_dtype)
            synchronize(device)
            log_fn("Cached init time: {}".format(time.time() - t0))
        self.x_fp, self.y_fp = io[unit_idx]
        if not include_act:
            # layer scope reconstructs the raw conv output: recomputed from
            # the cached input (an fp32 conv, stored in the cache's dtype)
            with torch.no_grad():
                self.y_fp = _apply_unit(
                    self.x_fp.float(), self.w, self.b, 1, self.kernel_size,
                    None).to(self.x_fp.dtype)
        # the fisher objectives' gradient cache and QDrop's quantized-
        # prefix inputs, both under quantize_model_till semantics
        self.grads = None
        if opt_mode != "mse":
            t0 = time.time()
            self.grads = harvest_unit_grads(
                model, params, spec, state, unit_idx, cali_data,
                include_act=include_act, cache_dtype=cache_dtype)
            synchronize(device)
            log_fn("Cached grad time: {}".format(time.time() - t0))
        self.x_sym = None
        if input_prob < 1.0:
            with torch.no_grad():
                qparams_till = quantize_params(params, spec, state,
                                               mode="uaq", upto=unit_idx)
            self.x_sym = harvest_unit_io(
                model, qparams_till, "", spec, cali_data, only=unit_idx,
                cache_dtype=cache_dtype)[unit_idx][0]
        self.cache_bytes = sum(
            t.numel() * t.element_size() for t in
            (self.x_fp, self.y_fp, self.grads, self.x_sym) if t is not None)

        # the unit's AdaRound state from its current scales (the reference
        # block recon inits from the raw weight; with spec.hadamard in the
        # Hadamard domain, as the network scope)
        ustate = adaround_upgrade(params, spec, state,
                                  only=(self.name,))[self.name]
        self.alpha0 = {k: ustate[k] for k in ("w_alpha", "b_alpha")}
        self.frozen = {k: v for k, v in ustate.items()
                       if k not in self.alpha0}

    def trainable(self):
        """Fresh copies of the starting alphas, requiring gradients."""
        return {k: v.detach().clone().requires_grad_(True)
                for k, v in self.alpha0.items()}

    def fake_quant(self, tr):
        """The unit's soft-AdaRound (weight, bias): the weight on the
        grouped kernel under ``fq_impl='pallas'``, else the plain chain;
        the bias on the plain chain."""
        st = {**self.frozen, **tr}
        if self.spec.fq_impl == "pallas":
            wq = fake_quant_group(
                [(self.w, st["w_delta"], st["w_zp"], st["w_alpha"],
                  self.bits, True)], self.spec.hadamard)[0]
        else:
            wq = fake_quant_ref(self.w, st["w_delta"], st["w_zp"],
                                st["w_alpha"], self.bits, self.spec.hadamard,
                                True)
        bq = Q.adaround_fake_quant(self.b, st["b_delta"], st["b_zp"],
                                   st["b_alpha"], self.bits, soft=True)
        return wq, bq

    def loss(self, tr, idx, count: int, draws=None,
             compute_dtype=torch.float32):
        """(total, reconstruction loss, rounding loss) of one step.
        `compute_dtype`: the dtype the unit's conv and the loss run in
        (float64 for a reference of the same step; the fake-quant stays
        fp32)."""
        wq, bq = self.fake_quant(tr)
        inp = self.x_fp[idx]
        if self.input_prob < 1.0:
            # QDrop: per element the FP or the quantized-prefix input
            inp = torch.where(draws < self.input_prob, inp, self.x_sym[idx])
        pred = _apply_unit(inp.to(compute_dtype), wq.to(compute_dtype),
                           bq.to(compute_dtype), self.stride,
                           self.kernel_size, self.act)
        tgt = self.y_fp[idx].to(compute_dtype)
        if self.opt_mode == "mse":
            rec = lp_loss(pred, tgt, p=self.p)
        elif self.opt_mode == "fisher_diag":
            g = self.grads[idx].to(compute_dtype)
            rec = (((pred - tgt) ** 2) * g ** 2).sum(-1).mean()
        else:
            a = torch.abs(pred - tgt)
            g = torch.abs(self.grads[idx].to(compute_dtype))
            dot = (a * g).sum(dim=(1, 2, 3)).reshape(-1, 1, 1, 1)
            rec = (dot * a * g).mean() / 100
        if count >= self.loss_start:
            reg = self.weight * Q.adaround_reg(tr["w_alpha"],
                                               self.temp(count))
        else:
            reg = torch.zeros((), dtype=rec.dtype, device=rec.device)
        return rec + reg, rec, reg

    def state(self, tr):
        """The unit's calibrated state: its frozen scales and `tr`."""
        return {**self.frozen, **{k: v.detach() for k, v in tr.items()}}


def run_steps(problem: UnitProblem, tr, opt, idxs, count: int,
              draw=None):
    """One Adam step per row of `idxs` (minibatch indices on the cache's
    device), counting from `count` + 1; `draw(count, shape)` gives QDrop's
    uniform draws. Returns (the last count, the last step's loss, on the
    device)."""
    last = None
    for idx in idxs:
        count += 1
        opt.zero_grad(set_to_none=True)
        draws = None
        if problem.input_prob < 1.0:
            draws = torch.as_tensor(draw(count, tuple(idx.shape)
                                         + problem.x_fp.shape[1:]),
                                    device=problem.x_fp.device)
        total, _, _ = problem.loss(tr, idx, count, draws)
        total.backward()
        opt.step()
        last = total.detach()
    return count, last


def unit_reconstruction(model, params, spec: QuantSpec, state: Dict,
                        unit_idx: int, cali_data, include_act: bool = True,
                        batch_size: int = 8, iters: int = 20000,
                        weight: float = 0.01, b_range=(20, 2),
                        warmup: float = 0.0, p: float = 2.0,
                        lr: float = 0.0015, seed: int = 903,
                        opt_mode: str = "mse", input_prob: float = 1.0,
                        log_fn=logging.info, io=None, cache_dtype=None,
                        minibatch_indices=None, qdrop_masks=None):
    """AdaRound one unit against its cached FP output; returns the state
    with that unit's entry calibrated (the others untouched).
    include_act=True is block reconstruction, False layer reconstruction.

    `io`: a :func:`harvest_unit_io` result shared by the units (the
    ``shared`` cache); None harvests this unit's pair alone in
    `cache_dtype` (the ``stream`` cache), freed when the unit ends.
    `minibatch_indices(chunk, todo, batch_size, n_cached)`: a chunk's
    (todo, batch_size) indices, and `qdrop_masks(count, shape)`: step
    `count`'s uniform draws in [0, 1) (an element keeps its FP input where
    the draw is below `input_prob`), in place of the seeded generators'."""
    prob = UnitProblem(model, params, spec, state, unit_idx, cali_data,
                       include_act=include_act, iters=iters, weight=weight,
                       b_range=b_range, warmup=warmup, p=p,
                       opt_mode=opt_mode, input_prob=input_prob,
                       log_fn=log_fn, io=io, cache_dtype=cache_dtype)
    device = prob.x_fp.device
    n_cached = prob.x_fp.shape[0]
    log_fn(f"[unit {unit_idx} {prob.name}] cache {prob.cache_bytes} bytes "
           f"({prob.x_fp.dtype}): input {tuple(prob.x_fp.shape)}, target "
           f"{tuple(prob.y_fp.shape)}")
    if minibatch_indices is None:
        gen = torch.Generator(device=device).manual_seed(2 * seed)

        def minibatch_indices(chunk, todo, batch_size, n):
            return torch.randint(0, n, (todo, batch_size), generator=gen,
                                 device=device)
    if qdrop_masks is None:
        drop_gen = torch.Generator(device=device).manual_seed(2 * seed + 1)

        def qdrop_masks(count, shape):
            return torch.rand(shape, generator=drop_gen, device=device)

    tr = prob.trainable()
    opt = torch.optim.Adam(list(tr.values()), lr=lr, eps=1e-8)
    count, done, chunk = 0, 0, 0
    while done < iters:
        todo = min(CHUNK, iters - done)
        idxs = torch.as_tensor(
            minibatch_indices(chunk, todo, batch_size, n_cached),
            dtype=torch.int64, device=device)
        count, last = run_steps(prob, tr, opt, idxs, count, qdrop_masks)
        done += todo
        chunk += 1
        log_fn(f"[unit {unit_idx} {prob.name}] iter {done}/{iters} "
               f"loss {float(last):.5f}")
    new_state = dict(state)
    new_state[prob.name] = prob.state(tr)
    return new_state


def block_reconstruction(model, params, spec, state, block_idx, cali_data,
                         **kw):
    """BRECQ-style block calibration: the unit's conv, shuffle and
    activation against the block's FP output."""
    return unit_reconstruction(model, params, spec, state, block_idx,
                               cali_data, include_act=True, **kw)


def layer_reconstruction(model, params, spec, state, layer_idx, cali_data,
                         **kw):
    """AdaRound per-layer calibration: the unit's conv against its FP raw
    conv output."""
    return unit_reconstruction(model, params, spec, state, layer_idx,
                               cali_data, include_act=False, **kw)
