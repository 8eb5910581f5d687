"""The plain reference against the program at a tiny size on the CPU, and
the work counts against the useful MACs of HNeRV's tail at Bunny-3M."""

import types

import pytest
import torch

from nqbench import core, program, work
from nqbench.reference import common
from nqbench.tests import tiny


class _Cell:
    def __init__(self, name, arch, n=8):
        self.config = tiny.CONFIGS[name]
        self.arch, self.seed, self.device = arch, 3, torch.device("cpu")
        self.traffic = {"n_frames": n}

    @property
    def cfg(self):
        return {k: v for k, v in self.config.items()
                if k not in core.OWN_KEYS}


@pytest.fixture(scope="module", params=[("tiny-hnerv", "hnerv"),
                                        ("tiny-nerv", "nerv")],
                ids=["hnerv", "nerv"])
def built(request):
    cell = _Cell(*request.param)
    dev = program.device(cell)
    model, cfg, sd = program.build(cell, dev)
    frames = program.frames(cell, dev)
    return cell, model, cfg, sd, frames


def test_decode_and_embedding(built):
    cell, model, cfg, sd, frames = built
    ref = core.module("reference", cell.arch)
    idx = torch.arange(4)
    norm = idx.float() / 8
    with torch.no_grad():
        emb = model.encode(model.model_input(frames[:4], norm))
        want = ref.embed(sd, cfg, frames[:4], idx, 8)
        assert torch.allclose(emb, want, atol=1e-6, rtol=0)
        got = model.decode(emb)
        assert torch.allclose(got, ref.decode(sd, cfg, want), atol=1e-6,
                              rtol=0)


def test_training_gradients(built):
    """A stage-1 loss's gradients: the program's autograd against the
    reference's, every leaf."""
    cell, model, cfg, sd, frames = built
    ref = core.module("reference", cell.arch)
    x = model.model_input(frames[:2], torch.arange(2).float() / 8)
    model.zero_grad()
    ((model(x) - frames[:2]) ** 2).mean().backward()
    leaves = {k: sd[k].clone().requires_grad_(True)
              for k, _ in model.named_parameters()}
    sdl = dict(sd, **leaves)
    y = ref.decode(sdl, cfg, ref.embed(sdl, cfg, frames[:2], torch.arange(2),
                                       8))
    grads = torch.autograd.grad(((y - frames[:2]) ** 2).mean(),
                                list(leaves.values()), allow_unused=True)
    for (k, p), g in zip(model.named_parameters(), grads):
        g = torch.zeros_like(p) if g is None else g
        assert torch.allclose(p.grad, g, atol=1e-7,
                              rtol=1e-4), k


@pytest.mark.parametrize("mode", ["uaq", "adaround"])
def test_fake_quant(built, mode):
    """Init scales and the alphas' start exactly; the fake-quantized
    weights and their gradients in the Hadamard domain to rounding."""
    from neuroquant_tpu_torch.ops.fused_fakequant import fake_quant_ref
    from neuroquant_tpu_torch.quantization import (
        adaround_upgrade, init_quant_state, make_spec, quantize_params)

    cell, model, cfg, sd, frames = built
    spec = make_spec(cell.arch, cfg, channel_wise=True, hadamard=True)
    bits = [6, 5, 4, 5, 6]
    spec = spec.with_bits(bits)
    state = init_quant_state(sd, spec)
    if mode == "adaround":
        state = adaround_upgrade(sd, spec, state)
    qp = quantize_params(sd, spec, state, mode=mode)
    for ln, pre, nb in zip(spec.layer_names, common.quant_prefixes(cfg),
                           bits):
        w, b = sd[pre + ".weight"], sd[pre + ".bias"]
        s0 = common.init_scales(w, b, nb)
        assert torch.equal(state[ln]["b_zp"].reshape(-1), s0["b_zp"].reshape(-1)) or mode == "adaround"
        if mode == "uaq":
            assert torch.equal(state[ln]["w_delta"].reshape(-1),
                               s0["w_delta"].reshape(-1))
            s = s0
        else:
            s = {"w_delta": state[ln]["w_delta"].reshape(-1, 1, 1, 1),
                 "w_zp": state[ln]["w_zp"].reshape(-1, 1, 1, 1),
                 "b_delta": state[ln]["b_delta"], "b_zp": state[ln]["b_zp"]}
            s["w_alpha"] = common.init_alpha(common.to_domain(w),
                                             s["w_delta"])
            s["b_alpha"] = common.init_alpha(b, s["b_delta"])
            assert torch.equal(state[ln]["w_alpha"].permute(3, 0, 1, 2),
                               s["w_alpha"])
        wq, bq = common.fake_quant(w, b, s, nb, mode)
        assert torch.allclose(qp[pre + ".weight"], wq, atol=1e-7, rtol=0)
        assert torch.allclose(qp[pre + ".bias"], bq, atol=1e-7, rtol=0)
        if mode == "adaround":
            a = s["w_alpha"].clone().requires_grad_(True)
            a_p = state[ln]["w_alpha"].clone().requires_grad_(True)
            g = torch.randn_like(w)
            got = torch.autograd.grad(
                (fake_quant_ref(w.permute(2, 3, 1, 0), state[ln]["w_delta"],
                                state[ln]["w_zp"], a_p, nb, True)
                 * g.permute(2, 3, 1, 0)).sum(), a_p)[0]
            want = torch.autograd.grad(
                (common.fake_quant(w, b, dict(s, w_alpha=a), nb, mode)[0]
                 * g).sum(), a)[0]
            assert torch.allclose(got.permute(3, 0, 1, 2), want, atol=1e-6,
                                  rtol=1e-5)


def test_calibration_order_from_the_reference(monkeypatch):
    """The calibration driver takes the quantized layers' order from the
    architecture's reference where it defines one: HNeRV's and NeRV's
    references define none, so theirs is ``common``'s."""
    calib = core.module("drivers", "calib")
    cfg = tiny.CONFIGS["tiny-hnerv"]
    for arch in ("hnerv", "nerv"):
        assert calib.quant_prefixes(arch, cfg) == common.quant_prefixes(cfg)
    own = types.SimpleNamespace(quant_prefixes=lambda c: ["dec_exc", "h"])
    monkeypatch.setattr(core, "module", lambda kind, name: own)
    assert calib.quant_prefixes("pnerv1", cfg) == ["dec_exc", "h"]


def test_adam_and_schedule():
    from neuroquant_tpu_torch.schedules import make_lr_schedule

    torch.manual_seed(0)
    p = torch.randn(10, requires_grad=True)
    q = p.detach().clone()
    opt = torch.optim.Adam([p], lr=1e-3, eps=1e-8)
    mine = common.Adam([q], lr=1e-3)
    sched = make_lr_schedule("cosine_0.1_1_0.1", 5e-4, 1000)
    for s in (0, 1, 2, 150, 999):
        g = torch.randn(10)
        p.grad = g.clone()
        lr = sched(s)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        mine.step([g], lr=common.lr_cosine("cosine_0.1_1_0.1", 5e-4, s,
                                            1000))
        assert lr == common.lr_cosine("cosine_0.1_1_0.1", 5e-4, s, 1000)
    assert torch.allclose(p.detach(), q, atol=1e-7, rtol=0)


def test_regulariser_exponent():
    from neuroquant_tpu_torch.quantization.calibrate import LinearTempDecay

    for warmup in (0.0, 0.2):
        decay = LinearTempDecay(2000, warmup, 20, 2)
        for t in (0, 1, 3, 399, 400, 401, 1999, 2000):
            assert common.temp_b(t, 2000, warmup, 20, 2) == decay(t)


HNERV_BUNNY = dict(
    crop_h=640, crop_w=1280, stage_block=1, enc_strides=[5, 4, 4, 2, 2],
    enc_channel=[64, 64, 64, 64, 16], dec_in_channel=92,
    dec_kernels=[1, 3, 5, 5, 5], dec_strides=[5, 4, 4, 2, 2],
    channel_reduce=1.2, channel_lbound=12)


def test_work_counts_hnerv_tail():
    """The useful MACs of HNeRV Bunny-3M's tail convs a frame: 4.34,
    11.94, 33.34 and 0.82 G."""
    w = core.module("work", "hnerv")
    dec = work.decoder_convs(HNERV_BUNNY, w.decoder_entry(HNERV_BUNNY))
    macs = [work.flops(c, 1) / 2e9 for c in dec[-4:]]
    assert [round(m, 2) for m in macs] == [4.34, 11.94, 33.34, 0.82]
    assert w.decode_flops(HNERV_BUNNY, 2) == 2 * w.decode_flops(HNERV_BUNNY,
                                                                1)
    # a calibration step: forward, input and weight gradients, no input
    # gradient into the embeddings
    f = [work.flops(c, 2) for c in dec]
    assert w.step_flops(HNERV_BUNNY, 2, "calib") == 3 * sum(f) - f[0]
    # the blocks' convs are bound by their FLOPs at the TF32 peak, the
    # 3-channel head by its bytes at 3.35 TB/s
    bound = [work.flops(c, 1) / 495e12 > work.nbytes(c, 1) / 3.35e12
             for c in dec[-4:]]
    assert bound == [True, True, True, False]
    least = w.tail_least_s(HNERV_BUNNY, 1, 4, ("fwd",))
    assert least == pytest.approx(
        sum(work.flops(c, 1) for c in dec[-4:-1]) / 495e12
        + work.nbytes(dec[-1], 1) / 3.35e12)
