"""Stage 2's Hessian-vector product with ``remat`` (``bit_assign --remat``)
in the port, on the 80x160 fixture with the tiny HNeRV, NeRV and PNeRV1:
the decode checkpointed in segments (prefix blocks or fusion stages one by
one, the tail layer by layer) gives the Hv of the unsegmented graph, on
both HVP routes (the kernels' forward-mode tail, here their plain
versions, and the plain unpacked decode); the tail's layers are recomputed
one at a time, each just before its own backward; and the per-layer omega
scores agree with the JAX package's criterion under ``remat=True``. Weights come from the JAX init,
batches from its ``jax.random.permutation``; the JAX package runs its
plain execution.

Tolerances: Hv with and without remat 1e-6 of each leaf's largest value
(the same operations, recomputed); per-layer omega scores against the JAX
package 1e-4 of the layer's sum of |Hv * v| (stage 2's tolerance,
``test_torch_sensitivity.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.models import layers as jlayers
from neuroquant_tpu.quantization import qmodel as jqm
from neuroquant_tpu.quantization import sensitivity as jsens
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.ops import tail_fused as ttf
from neuroquant_tpu_torch.quantization import (
    get_perturbation, hessian_vector_product, make_spec,
    sensitivity_criterion)
from neuroquant_tpu_torch.utils.convert import (
    quant_state_from_numpy, state_dict_from_jax)

SEED = 903
BATCH = 2
ARCHS = ("hnerv", "nerv", "pnerv")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tiny_hnerv_cfg, tiny_nerv_cfg, tiny_pnerv_cfg, frame_dir):
    """Per arch: the JAX plain model and init, the port's models on both
    HVP routes, the spec and the JAX init state (UAQ, Hadamard,
    channel-wise), the frames, NeRV's indices and the JAX batches."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlayers, "PREFIX_MIN_GRID", 1)
    out = {}
    for arch, cfg in (("hnerv", dict(tiny_hnerv_cfg)),
                      ("nerv", dict(tiny_nerv_cfg, n_frames=8)),
                      ("pnerv", dict(tiny_pnerv_cfg))):
        frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
        norm_idx = np.arange(8, dtype=np.float32) / 8
        jm = jax_build_model(arch, dict(cfg, fused_tail="off"))
        x = norm_idx if arch == "nerv" else frames
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(x[:BATCH]))
        sd = state_dict_from_jax(arch, _np(params))
        tm = {}
        for ft in ("off", "pallas_hvp"):
            tm[ft] = build_model(arch, dict(cfg, fused_tail=ft),
                                 device="cpu")
            tm[ft].load_state_dict(sd, strict=True)
        n_layers = len(tm["off"].jvp_keys())
        bits = [(2, 3, 4, 6, 4)[i % 5] for i in range(n_layers)]
        jspec = jax_make_spec(arch, cfg, hadamard=True).with_bits(bits)
        tspec = make_spec(arch, cfg, hadamard=True).with_bits(bits)
        jstate = jqm.init_quant_state(params, jspec)
        perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(SEED),
                                                 8))
        nb = min(jsens.MAX_BATCHES, 8 // BATCH)
        out[arch] = dict(cfg=cfg, jm=jm, params=params, sd=sd, tm=tm,
                         jspec=jspec, tspec=tspec, jstate=jstate,
                         tstate=quant_state_from_numpy(_np(jstate)),
                         frames=frames, norm_idx=norm_idx,
                         batches=perm[:nb * BATCH].reshape(nb, BATCH))
    yield out
    mp.undo()


def _inputs(s, arch):
    return (torch.from_numpy(s["frames"]),
            torch.from_numpy(s["norm_idx"]) if arch == "nerv" else None)


@pytest.mark.parametrize("route", ["pallas_hvp", "off"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_hv(setup, monkeypatch, arch, route):
    """Hv with and without the segmented remat, over two batches; the
    remat run recomputes its segments in the backward (more conv calls:
    cuDNN's, and the tail kernels' plain versions on the CPU)."""
    s = setup[arch]
    model = s["tm"][route]
    vec = get_perturbation(s["sd"], s["tspec"], s["tstate"])
    frames, norm_idx = _inputs(s, arch)
    calls, conv2d = [0], F.conv2d

    def counting(*a, **k):
        calls[0] += 1
        return conv2d(*a, **k)

    monkeypatch.setattr(F, "conv2d", counting)
    counts, hv = [], {}
    for remat in (False, True):
        calls[0] = 0
        hv[remat] = hessian_vector_product(model, s["tspec"], vec, frames,
                                           norm_idx, s["batches"][:2],
                                           remat=remat)
        counts.append(calls[0])
    assert counts[1] > counts[0] > 0, counts
    for a, b in zip(hv[False], hv[True]):
        assert float(a.abs().max()) > 0
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-6 * float(a.abs().max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_tail_layer_by_layer(setup, monkeypatch, arch):
    """On the kernel route with remat, every conv_p of each tail layer runs
    once in the forward and once more inside the backward (its segment's
    recompute), and a layer is recomputed only after the next layer's dW
    pass: one layer's inside is alive at a time. Without remat no conv_p
    runs inside the backward."""
    s = setup[arch]
    model = s["tm"]["pallas_hvp"]
    vec = get_perturbation(s["sd"], s["tspec"], s["tstate"])
    frames, norm_idx = _inputs(s, arch)
    conv_p, conv_dw = ttf.conv_p, ttf.conv_cf_dw
    events = []

    def in_backward():
        return torch._C._current_graph_task_id() != -1

    def rec_conv_p(plan, layer, *a, **k):
        events.append(("conv", plan, layer, in_backward()))
        return conv_p(plan, layer, *a, **k)

    def rec_dw(x, g, plan, layer, *a, **k):
        events.append(("dw", plan, layer, in_backward()))
        return conv_dw(x, g, plan, layer, *a, **k)

    monkeypatch.setattr(ttf, "conv_p", rec_conv_p)
    monkeypatch.setattr(ttf, "conv_cf_dw", rec_dw)
    for remat in (False, True):
        events.clear()
        hessian_vector_product(model, s["tspec"], vec, frames, norm_idx,
                               s["batches"][:1], remat=remat)
        plan = max({e[1] for e in events}, key=lambda p: len(p.layers))
        layers = plan.layers
        assert len(layers) >= 2, layers

        def where(kind, layer, backward):
            return [i for i, e in enumerate(events) if e[0] == kind
                    and e[1] is plan and e[2] is layer and e[3] == backward]

        for li, layer in enumerate(layers):
            fwd = where("conv", layer, False)
            rec = where("conv", layer, True)
            assert len(fwd) in (2, 3), (li, len(fwd))
            assert len(rec) == (len(fwd) if remat else 0), (li, rec, fwd)
            if remat and li + 1 < len(layers):
                later_dw = where("dw", layers[li + 1], True)
                assert later_dw and min(rec) > max(later_dw), (li, rec,
                                                               later_dw)
            if remat:
                assert max(rec) < min(where("dw", layer, True)), li


def test_gelu_tangent_by_pieces_matches_whole():
    """The tail's tangent GELU run piece by piece (as under remat; a last
    piece shorter than the rest) gives the values and the closed-form
    backward of the whole-tensor run, to fp32 rounding."""
    gen = torch.Generator().manual_seed(0)
    h, dh, gy, gd = (torch.randn(2, 24, 1000, generator=gen)
                     for _ in range(4))
    want = [ttf._gelu_tangent(h, dh), ttf._gelu_tangent_vjp(h, dh, gy, gd)]
    hr, dhr = (t.clone().requires_grad_(True) for t in (h, dh))
    got = ttf._GeluTangent.apply(hr, dhr, 777)
    torch.autograd.backward(got, (gy, gd))
    for g, w in zip([*got, hr.grad, dhr.grad], [*want[0], *want[1]]):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_omega_matches_jax_remat(setup, arch):
    """Per-layer omega scores with remat in both packages, the port on the
    kernel route and on the plain route, the JAX package on its plain
    execution, on the JAX batches."""
    s = setup[arch]
    frames, norm_idx = _inputs(s, arch)
    _, want = jsens.sensitivity_criterion(
        "omega", arch, s["jm"], s["params"], s["jspec"], s["jstate"],
        jnp.asarray(s["frames"]),
        jnp.asarray(s["norm_idx"]) if arch == "nerv" else None, BATCH,
        seed=SEED, log_fn=lambda m: None, remat=True)
    vec = get_perturbation(s["sd"], s["tspec"], s["tstate"])
    for route in ("pallas_hvp", "off"):
        model = s["tm"][route]
        hv = hessian_vector_product(model, s["tspec"], vec, frames,
                                    norm_idx, s["batches"], remat=True)
        mags = [float((h * v).abs().sum()) for h, v in zip(hv, vec)]
        _, got = sensitivity_criterion(
            "omega", arch, model, s["sd"], s["tspec"], s["tstate"], frames,
            norm_idx, BATCH, log_fn=lambda m: None, remat=True,
            batches=s["batches"])
        assert len(got) == len(want) == len(vec)
        for g, w, mag in zip(got, want, mags):
            assert mag > 0 and abs(g - w) <= 1e-4 * mag, (route, g, w, mag)
