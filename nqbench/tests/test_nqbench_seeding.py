"""The seeded weights (``core.seeded_state_dict``) of each architecture at
the tests' tiny size on the CPU: one seed gives the same weights, two seeds
differ in every drawn parameter, only norms' affine parameters and layer
scales keep the constructor's values, PNeRV1's KFc factors and bias factors
come from the seed by their law, HNeRV's and NeRV's weights are the ones
the harness drew before the KFc draws were added, and a weight that is not
finite is refused."""

import hashlib
import math

import pytest
import torch

from neuroquant_tpu_torch.models.layers import (
    BatchNorm2d, ConvNeXtBlock, KFcBias, LayerNorm)
from nqbench import core, program
from nqbench.tests import tiny

SEEDS = (3, 2147483659)
# sha256 of the seeded state dicts (``_digest``) as the harness drew them
# before parameters outside the conv and linear rule were drawn
PINNED = {
    ("tiny-hnerv", 3):
        "6fe98caccc2fb7c639a2bb261ba1425f232fbd7cecb463e6b36d835b128f458b",
    ("tiny-hnerv", 2147483659):
        "bf0ff57f232292b875aa5e688b362e25e87963220966ce55acc5600c74030274",
    ("tiny-nerv", 3):
        "5541f1e60fd3c8fe2cdba99dcbf1844bce0f5cbdfda3f40405ce5c392537fcb9",
    ("tiny-nerv", 2147483659):
        "bdcc24ff28163d1b7af611f7ee61d38c607b4ff62bb17c3bd133b85625253177",
}
CONFIGS = ("tiny-hnerv", "tiny-nerv", "tiny-pnerv1", "tiny-pnerv2")


class _Cell:
    def __init__(self, name, seed):
        self.config = tiny.CONFIGS[name]
        self.arch, self.seed = self.config["arch"], seed
        self.device = torch.device("cpu")
        self.traffic = {"n_frames": 8}

    @property
    def cfg(self):
        return {k: v for k, v in self.config.items()
                if k not in core.OWN_KEYS}


def _model(name):
    """The program's model of `name`, as ``program.build`` makes it before
    it draws."""
    from neuroquant_tpu_torch import models

    cell = _Cell(name, 0)
    cls, cfg_cls = cell.config["classes"]
    cfg = program.model_cfg(cell)
    return getattr(models, cls)(getattr(models, cfg_cls).from_cfg(cfg))


def _seeded(name, seed):
    return core.seeded_state_dict(_model(name), seed, torch.device("cpu"))


def _digest(sd):
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu().contiguous()
        h.update(f"{k}:{v.dtype}:{tuple(v.shape)}:".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_one_seed_same_weights(name):
    (a, kept_a), (b, kept_b) = _seeded(name, SEEDS[1]), _seeded(name,
                                                                SEEDS[1])
    assert kept_a == kept_b and a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", CONFIGS)
def test_two_seeds_differ_in_every_drawn_parameter(name):
    (a, kept), (b, _) = _seeded(name, SEEDS[0]), _seeded(name, SEEDS[1])
    drawn = [k for k in a if k not in kept]
    assert drawn
    for k in drawn:
        assert (a[k] != b[k]).float().mean() > 0.9, k
        assert bool(torch.isfinite(a[k]).all()), k


@pytest.mark.parametrize("name", CONFIGS)
def test_kept_only_norms_and_layer_scales(name):
    model = _model(name)
    allowed = set()
    for mname, m in model.named_modules():
        if isinstance(m, (LayerNorm, BatchNorm2d)):
            allowed |= {f"{mname}.weight", f"{mname}.bias"}
        elif isinstance(m, ConvNeXtBlock):
            allowed.add(f"{mname}.gamma")
    sd, kept = core.seeded_state_dict(model, SEEDS[0], torch.device("cpu"))
    assert set(kept) <= allowed, sorted(set(kept) - allowed)
    constructed = model.state_dict()
    for k in kept:
        assert torch.equal(sd[k], constructed[k]), k


def test_kfc_factors_from_the_seed():
    """Each KFc parameter drawn: w_L, w_R kaiming normal with fan-out
    (C * n for the reference's (C, m, n)), b_h, b_w, b_c non-zero within
    1/sqrt(length)."""
    model = _model("tiny-pnerv1")
    kfc = [(n, m) for n, m in model.named_modules() if isinstance(m, KFcBias)]
    assert len(kfc) == 2
    (a, kept), (b, _) = [core.seeded_state_dict(model, s, torch.device("cpu"))
                         for s in SEEDS]
    unit = []
    for mname, m in kfc:
        for p in ("w_L", "w_R", "b_h", "b_w", "b_c"):
            k = f"{mname}.{p}"
            assert k not in kept and not torch.equal(a[k], b[k]), k
            assert bool(torch.isfinite(a[k]).all()), k
        for p in ("w_L", "w_R"):
            w = a[f"{mname}.{p}"]
            unit.append(w.reshape(-1) / math.sqrt(2.0 / (w.shape[1]
                                                         * w.shape[-1])))
        for p in ("b_h", "b_w", "b_c"):
            v = a[f"{mname}.{p}"]
            assert bool((v != 0).all()), p
            assert float(v.abs().max()) <= 1.0 / math.sqrt(v.numel()), p
    unit = torch.cat(unit)
    assert unit.numel() > 500
    assert 0.85 < float(unit.std()) < 1.15 and abs(float(unit.mean())) < 0.1


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_hnerv_nerv_weights_pinned(name, seed):
    sd, _ = _seeded(name, seed)
    assert _digest(sd) == PINNED[(name, seed)]


def test_not_finite_refused():
    model = _model("tiny-hnerv")
    with torch.no_grad():
        model.encoder.stages[0][0].gamma[0] = float("nan")
    with pytest.raises(core.Refused, match="gamma"):
        core.seeded_state_dict(model, SEEDS[0], torch.device("cpu"))
