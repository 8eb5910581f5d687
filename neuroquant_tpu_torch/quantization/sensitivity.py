"""Mixed-precision sensitivity criteria: Omega (v' H v) and diagonal Fisher
(the counterpart of ``neuroquant_tpu/quantization/sensitivity.py``).

Omega scores the quantization perturbation v = w - UAQ(w) against the loss
Hessian over <= 10 random batches: omega = sum over layers of
(sum_b H_b v) . v. The Hessian-vector product is reverse-over-forward,
Hv = grad(w -> jvp(loss, w, v)): the model's ``decode_jvp`` carries the
tangent beside the value, through the fused tail's kernels on ``fused_tail:
pallas_hvp`` (``tail_fused.tail_apply_fo``) or through the plain unpacked
decode's cuDNN convs on ``off``, and ``torch.autograd.grad`` of the
directional derivative differentiates that first-order graph once. With
``remat`` the decode runs checkpointed in segments (``decode_jvp(...,
remat=True)``: prefix blocks or fusion stages one by one, then the tail
layer by layer): the forward keeps only each segment's boundary values and
tangents, and the backward recomputes one segment at a time.

fisher_diag: sum over layers of v^2 * g^2, g the gradient accumulated over
the same batches, on whatever decode the config selects (the production
tail's autograd Function on the fused path).

The batches are a permutation from a ``torch.Generator`` seeded with
``seed``; the JAX package draws its own with ``jax.random.permutation``, so
a caller that wants its batches passes them in (``batches``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from neuroquant_tpu_torch.quantization.qmodel import get_perturbation
from neuroquant_tpu_torch.quantization.spec import QuantSpec

MAX_BATCHES = 10


def _kernels(model, spec: QuantSpec):
    """The spec layers' weight Parameters (OIHW): the model's own list
    (``jvp_keys``, the quantized layers in decode order), which must be
    the spec's."""
    keys = model.jvp_keys()
    if keys != [f"{pre}.weight" for pre in spec.layer_keys]:
        raise ValueError(f"the spec's layers {spec.layer_keys} are not the "
                         f"model's quantized layers {keys}")
    weights = dict(model.named_parameters())
    return [weights[k] for k in keys]


def draw_batches(n: int, batch_size: int, seed: int):
    """(n_batches, batch_size) frame indices: a seeded permutation cut into
    at most MAX_BATCHES batches."""
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    n_batches = min(MAX_BATCHES, n // batch_size)
    return perm[:n_batches * batch_size].reshape(n_batches, batch_size)


def _batch_of(model, frames, norm_idx, idx):
    """(frames[idx], the model's input for them)."""
    idx = torch.as_tensor(np.array(idx, dtype=np.int64),
                          device=frames.device)
    return frames[idx], model.model_input(frames, norm_idx)[idx]


def hessian_vector_product(model, spec: QuantSpec, vec, frames, norm_idx,
                           batches, remat: bool = False):
    """sum_b H_b v of the reconstruction MSE w.r.t. the spec layers'
    kernels, over the frame batches `batches`. vec and the result: one HWIO
    tensor per spec layer (the JAX layout). `norm_idx`: the frames'
    normalized indices, which NeRV encodes (HNeRV the frames)."""
    kernels = _kernels(model, spec)
    dws = [v.permute(3, 2, 0, 1) for v in vec]

    acc = [torch.zeros_like(v) for v in vec]
    for idx in batches:
        img, inp = _batch_of(model, frames, norm_idx, idx)
        # d/de mse(w + e v) at e = 0: forward mode through the decode
        with torch.no_grad():
            emb = model.encode(inp)
        pred, dpred = model.decode_jvp(emb, dws, remat=remat)
        dl = (2.0 * (pred - img) * dpred).mean()
        for a, h in zip(acc, torch.autograd.grad(dl, kernels)):
            a += h.permute(2, 3, 1, 0)
    return acc


def fisher_gradient(model, spec: QuantSpec, frames, norm_idx, batches):
    """sum_b of the reconstruction MSE's gradient w.r.t. the spec layers'
    kernels (HWIO), on the model's decode; `norm_idx` as in
    :func:`hessian_vector_product`."""
    kernels = _kernels(model, spec)
    acc = [torch.zeros_like(k.permute(2, 3, 1, 0)) for k in kernels]
    for idx in batches:
        img, inp = _batch_of(model, frames, norm_idx, idx)
        with torch.no_grad():
            emb = model.encode(inp)
        loss = ((model.decode(emb) - img) ** 2).mean()
        for a, g in zip(acc, torch.autograd.grad(loss, kernels)):
            a += g.permute(2, 3, 1, 0)
    return acc


def sensitivity_criterion(mode: str, arch: str, model, params,
                          spec: QuantSpec, state, frames, norm_idx,
                          batch_size: int, seed: int = 903,
                          log_fn=logging.info, remat: bool = False,
                          batches=None):
    """Sensitivity score of the (spec, state) bit allocation: (total,
    per-layer scores); lower is better. `params` (a state dict) is loaded
    into `model`. `norm_idx`: the frames' normalized indices, NeRV's input
    (HNeRV encodes the frames). `batches`: (n, batch_size) frame indices to
    use instead of drawing them from `seed`."""
    if arch.lower() not in ("hnerv", "nerv", "pnerv", "pnerv1", "pnerv2"):
        raise ValueError(f"model arch wrong: {arch!r}")
    model.load_state_dict(params)
    vec = get_perturbation(params, spec, state)
    if batches is None:
        batches = draw_batches(int(frames.shape[0]), batch_size, seed)
    if mode == "omega":
        hv = hessian_vector_product(model, spec, vec, frames, norm_idx,
                                    batches, remat)
        per_layer = [float((h * v).sum()) for h, v in zip(hv, vec)]
    elif mode == "fisher_diag":
        g = fisher_gradient(model, spec, frames, norm_idx, batches)
        per_layer = [float((v ** 2 * gg ** 2).sum())
                     for v, gg in zip(vec, g)]
    else:
        raise ValueError(f"Not implemented sensitivity criteria: {mode}")
    for count, v in enumerate(per_layer):
        log_fn(f"[{count:d}-th layer] {v:.3e}")
    return float(np.sum(per_layer)), per_layer
