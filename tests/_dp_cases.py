"""Rank functions for ``tests/test_torch_dp.py``: the data-parallel ranks
are spawned processes, which import what they run from here (torch and the
port only, so that a rank starts quickly)."""

import torch

from neuroquant_tpu_torch.methods.regress import make_train_epoch
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.quantization import (
    init_quant_state, make_spec, model_reconstruction)
from neuroquant_tpu_torch.utils.convert import state_dict_from_numpy

BITS = (6, 5, 4, 5, 6)


def _model(arch, cfg, sd, dtype):
    """The tiny `arch` on the CPU in `dtype`: `sd`'s weights, or (None) the
    port's init from seed 0."""
    model = build_model(arch, cfg, device="cpu", seed=0)
    if sd is not None:
        model.load_state_dict(state_dict_from_numpy(sd, "cpu"), strict=True)
    return model.to(dtype)


def calibrate_case(mesh, cfg, sd, frames, batch_size, iters,
                   dtype=torch.float32, arch="hnerv"):
    """Network-scope calibration of the tiny `arch` on the CPU in `dtype`
    over `frames` in batches of `batch_size` (one phase-1 epoch once iters
    reaches 20 epochs), on `mesh` or in one process: the calibrated state
    and the number of decodes this rank ran."""
    model = _model(arch, cfg, sd, dtype)
    model.eval()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    frames = torch.from_numpy(frames).to(dtype)
    with torch.no_grad():
        cali = model.encode(frames)
    spec = make_spec(arch, cfg, channel_wise=True, hadamard=True)
    spec = spec.with_bits([BITS[i % len(BITS)]
                           for i in range(len(spec.layer_names))])
    decodes = [0]
    decode_cf = model.decode_cf

    def counted(*a, **k):
        decodes[0] += 1
        return decode_cf(*a, **k)

    model.decode_cf = counted
    state, _ = model_reconstruction(
        model, params, spec, init_quant_state(params, spec), cali, frames,
        list(range(len(frames))), batch_size=batch_size, iters=iters,
        lr=0.003, log_fn=lambda m: None, mesh=mesh, arch=arch)
    return {"state": state, "decodes": decodes[0]}


def train_case(mesh, arch, cfg, frames, batch_size, epochs,
               dtype=torch.float64):
    """Stage-1 epochs of the tiny `arch` (the port's init from seed 0) on
    the CPU in `dtype` through ``regress.make_train_epoch``, frames in
    order, on `mesh` or in one process: the trained weights and each
    epoch's losses."""
    model = _model(arch, cfg, None, dtype)
    frames = torch.from_numpy(frames).to(dtype)
    n = len(frames)
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)
    steps = n // batch_size
    run_epoch = make_train_epoch(
        model, "l2", opt, lambda s: 2e-3, frames,
        torch.arange(n, dtype=dtype) / n, steps, batch_size, mesh=mesh)
    losses = [run_epoch(list(range(n)), e * steps)[0] for e in range(epochs)]
    return {"weights": {k: v.detach() for k, v in
                        model.state_dict().items()},
            "losses": torch.cat(losses)}
