"""The benchmark's one door into the program, ``neuroquant_tpu_torch``: its
model built from a configuration file with the benchmark's seeded weights,
its launch counter, and its device. Imported by the drivers only when a
cell runs."""

from __future__ import annotations

import torch

from nqbench import core


def device(cell):
    """The cell's device with TF32 off, as the program's entry points set
    it."""
    from neuroquant_tpu_torch.utils.device import resolve_device

    return resolve_device(cell.device)


def model_cfg(cell) -> dict:
    """The model's keys; NeRV's gains the clip's length, as the program's
    stage-1 set-up gives it (its position encoding's exact table)."""
    cfg = cell.cfg
    if cell.arch == "nerv":
        cfg["n_frames"] = int(cell.traffic["n_frames"])
    return cfg


def build(cell, dev):
    """(model, cfg, sd): the program's model for the cell's configuration
    with the benchmark's weights from the seed
    (``core.seeded_state_dict``), and those weights."""
    from neuroquant_tpu_torch import models
    from neuroquant_tpu_torch.config import validate_config

    cfg = validate_config(model_cfg(cell), cell.arch)
    cls, cfg_cls = cell.config["classes"]
    with torch.device(dev):
        model = getattr(models, cls)(getattr(models, cfg_cls).from_cfg(cfg))
    sd, _ = core.seeded_state_dict(model, cell.seed, dev)
    model.load_state_dict(sd)
    return model, cfg, sd


def launches() -> dict:
    """A copy of the program's kernel launch counter."""
    from neuroquant_tpu_torch.ops.tail_fused import KERNEL_LAUNCHES

    return dict(KERNEL_LAUNCHES)


def launched(before: dict, name: str) -> int:
    return launches()[name] - before[name]


def frames(cell, dev):
    """The clip: the traffic's number of seeded 16:9 frames at the
    configuration's width, center-cropped to its height."""
    h, w = int(cell.cfg["crop_h"]), int(cell.cfg["crop_w"])
    return core.synthetic_frames(int(cell.traffic["n_frames"]), cell.seed,
                                 dev, size=(w * 9 // 16, w), crop=(h, w))
