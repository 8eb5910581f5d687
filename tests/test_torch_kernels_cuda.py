"""The CUDA kernels of neuroquant_tpu_torch against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and nvcc, and
skips without them (the CPU tests hold the plain versions against the JAX
package). The file imports neither JAX nor the JAX package, so it runs on
a machine without them:

  python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances: the conv, its dx pass and the dW kernel sum fp32 products in
another order than the plain version's matmul, 1e-4 relative to the
output's largest value (gradients through a whole tail 1e-4 relative to
the largest gradient); the layout kernels copy, so they are exact;
out_img 1e-6; the fake-quant kernel 1e-6 of the output's largest value with
no flipped rounding decision (its butterfly repeats the plain chain's
operations in their order)."""

import numpy as np
import pytest
import torch

from neuroquant_tpu_torch.ops import tail_fused as tf

BLOCKS = [(5, 5, 16, 2), (3, 4, 12, 2)]     # (k, cin, cout*r*r, r)
HEAD = (3, 3, 3)
TINY_HNERV = dict(
    crop_h=80, crop_w=160, diff_enc=False, stage_block=1,
    enc_strides=[5, 4, 4], enc_channel=[16, 16, 8], channel_reduce=1.2,
    channel_lbound=4, dec_in_channel=24, dec_kernels=[1, 3, 3],
    dec_strides=[5, 4, 4], dec_norm="none", dec_acts="gelu", out_bias="tanh",
    loss="l2", epoch=4, workers=0, eval_freq=2, batch_size=2,
    learning_rate=0.002)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from neuroquant_tpu_torch.ops import _cuda

    try:
        _cuda._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.lib()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small(dev):
    rng = np.random.RandomState(0)
    blocks = [(torch.from_numpy(rng.randn(k, k, cin, crr).astype(np.float32)
                                * 0.3).to(dev),
               torch.from_numpy(rng.randn(crr).astype(np.float32)).to(dev), r)
              for k, cin, crr, r in BLOCKS]
    k, cin, cout = HEAD
    head = (torch.from_numpy(rng.randn(k, k, cin, cout).astype(np.float32)
                             * 0.3).to(dev),
            torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dev))
    return tf.plan_and_pack(16, 24, blocks, head, tm=128)


def _cf(plan, cin, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((2, cin, plan.mp), generator=g, device=dev)
    return (x * tf.border_mask(plan, device=dev)).contiguous()


@pytest.mark.parametrize("li", [0, 1, 2], ids=["f1", "f2", "head_f4"])
@pytest.mark.parametrize("emit,act_in", [("z", False), ("y", False),
                                         ("z", True), ("y", True)])
def test_tail_conv_cf(dev, small, li, emit, act_in):
    plan, kks, bms, _, _ = small
    layer = plan.layers[li]
    x = _cf(plan, layer.cin, dev, li)
    tf.reset_launch_counts()
    got = tf.conv_cf(x, kks[li], bms[li], plan, layer, emit, act_in)
    want = tf.conv_cf_ref(x, kks[li], bms[li], plan, layer, emit, act_in)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["tail_conv_cf"] == 1
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    w_op = tf.conv_w_operand(kks[li], plan, layer)       # packed beforehand
    assert torch.equal(tf.conv_cf(x, kks[li], bms[li], plan, layer, emit,
                                  act_in, w_op), got)


@pytest.mark.parametrize("c", [5, 8, 13])
def test_pack_cf(dev, small, c):
    plan = small[0]
    g = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn((2, plan.h, plan.w, c), generator=g, device=dev)
    got = tf.pack_cf(x, plan)
    assert torch.equal(got, tf.pack_cf_ref(x, plan))


@pytest.mark.parametrize("out_bias", ["sigmoid", "tanh", "0.5"])
def test_unpack_frames(dev, small, out_bias):
    plan, _, _, f, ch = small
    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn((2, plan.layers[-1].cout, plan.mp), generator=g,
                    device=dev)
    got = tf.unpack_frames(z, plan, f, ch, out_bias)
    want = tf.unpack_frames_ref(z, plan, f, ch, out_bias)
    assert got.shape == want.shape == (2, plan.h * f, plan.w * f, 3)
    assert float((got - want).abs().max()) <= 1e-6


def test_wrappers_refuse_what_the_kernels_do_not_take(dev, small):
    plan, kks, bms, _, _ = small
    layer = plan.layers[0]
    x = _cf(plan, layer.cin, dev, 0)
    with pytest.raises(TypeError):
        tf.conv_cf(x.double(), kks[0], bms[0], plan, layer)
    with pytest.raises(ValueError, match="contiguous"):
        tf.pack_cf(torch.zeros((2, plan.w, plan.h, 5), device=dev)
                   .transpose(1, 2), plan)


def test_decode_goes_through_the_kernels(dev):
    from neuroquant_tpu_torch.models import build_model

    kern = build_model("hnerv", TINY_HNERV, device=dev).eval()
    plain = build_model("hnerv", dict(TINY_HNERV, packed_tail="off"),
                        device=dev).eval()
    plain.load_state_dict(kern.state_dict())
    g = torch.Generator(device=dev).manual_seed(2)
    frames = torch.rand((2, 80, 160, 3), generator=g, device=dev)
    with torch.no_grad():
        emb = kern.encode(frames)
        tf.reset_launch_counts()
        got = kern.decode(emb)
        torch.cuda.synchronize()
        counts = dict(tf.KERNEL_LAUNCHES)
        want = plain.decode(emb)
        assert all(wts.w_ops is not None for _, wts in kern._packed.values())
        assert torch.equal(kern.decode(emb), got)        # packed weights kept
    n_layers = len(kern.blocks) - kern.pack_start + 1
    assert counts == {"tail_conv_cf": n_layers + 1, "tail_conv_dw_cf": 0,
                      "pack_cf": 2, "unpack_cf": 0, "unpack_frames": 1,
                      "fq_uaq": 0, "fq_ada": 0}
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("li", [0, 1, 2], ids=["f1", "f2", "head_f4"])
def test_tail_conv_cf_dx_pass(dev, small, li):
    """The backward's dx launch: the transposed layer (mirrored taps, the
    convT's union blocks) with the GELU'(out_mul) epilogue."""
    plan, kks, _, _, _ = small
    lt = plan.layers[li].transposed()
    g = _cf(plan, lt.cin, dev, 10 + li)
    out_mul = _cf(plan, lt.cout, dev, 20 + li)
    kt = tf._kk_transpose(kks[li]).contiguous()
    tf.reset_launch_counts()
    got = tf.conv_cf(g, kt, None, plan, lt, out_mul=out_mul)
    want = tf.conv_cf_ref(g, kt, None, plan, lt, out_mul=out_mul)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["tail_conv_cf"] == 1
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("li", [0, 1, 2], ids=["f1", "f2", "head_f4"])
@pytest.mark.parametrize("act_in", [False, True])
def test_tail_conv_dw_cf(dev, small, li, act_in):
    plan, _, _, _, _ = small
    layer = plan.layers[li]
    x = _cf(plan, layer.cin, dev, 30 + li)
    g = _cf(plan, layer.cout, dev, 40 + li)
    tf.reset_launch_counts()
    dkk, db = tf.conv_cf_dw(x, g, plan, layer, act_in)
    want_kk, want_b = tf.conv_cf_dw_ref(x, g, plan, layer, act_in,
                                        tf._k_blocks(plan, layer))
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["tail_conv_dw_cf"] == 1
    assert dkk.shape == (layer.side, layer.side, layer.cin, layer.cout)
    for got, want in ((dkk, want_kk), (db, want_b)):
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    again = tf.conv_cf_dw(x, g, plan, layer, act_in)
    assert torch.equal(again[0], dkk)        # fixed-order split sums


@pytest.mark.parametrize("c", [5, 8, 13])
def test_unpack_cf(dev, small, c):
    plan = small[0]
    gen = torch.Generator(device=dev).manual_seed(c)
    g = torch.randn((2, tf._r8(c), plan.mp), generator=gen, device=dev)
    got = tf.unpack_cf(g, plan, c)
    assert got.shape == (2, plan.h, plan.w, c)
    assert torch.equal(got, tf.unpack_cf_ref(g, plan, c))


def test_unpack_frames_width_tiled(dev):
    """A plan whose JAX unpack takes the width-tiled _unpack_kernel5."""
    plan, f = tf.plan_geometry(4, 480, [(3, 17, 224, 4)], (3, 14, 3))
    gen = torch.Generator(device=dev).manual_seed(3)
    z = torch.randn((2, plan.layers[-1].cout, plan.mp), generator=gen,
                    device=dev)
    got = tf.unpack_frames(z, plan, f, 48, "tanh")
    want = tf.unpack_frames_ref(z, plan, f, 48, "tanh")
    assert got.shape == (2, 16, 1920, 3)
    assert float((got - want).abs().max()) <= 1e-6


def test_tail_backward_matches_plain_autograd(dev, small):
    """Gradients of the tail Function (dx and dW kernels) against autograd
    through the plain conv chain (dense taps), on the card. The Function's
    dx is zero on the border, as its input is, and a packed layer's dW is
    its union-block gradient, so dx is compared inside the border and dW
    where the packed kernel can be nonzero."""
    plan, kks, bms, _, _ = small
    x0 = _cf(plan, plan.layers[0].cin, dev, 50)
    wt = _cf(plan, plan.layers[-1].cout, dev, 51)

    def grads(run):
        x = x0.clone().requires_grad_()
        ks = [k.clone().requires_grad_() for k in kks]
        bs = [b.clone().requires_grad_() for b in bms]
        (run(x, ks, bs) * wt).sum().backward()
        return [x.grad] + [k.grad for k in ks] + [b.grad for b in bs]

    def plain(x, ks, bs):
        h = x
        for li, layer in enumerate(plan.layers):
            h = tf.conv_cf_ref(h, ks[li], bs[li], plan, layer, "z",
                               act_in=layer.gelu_in)
        return h

    tf.reset_launch_counts()
    got = grads(lambda x, ks, bs: tf.tail_apply(plan, x, ks, bs))
    torch.cuda.synchronize()
    n = len(plan.layers)
    assert tf.KERNEL_LAUNCHES["tail_conv_cf"] == 2 * n
    assert tf.KERNEL_LAUNCHES["tail_conv_dw_cf"] == n
    live = [k != 0 for k in tf.plan_and_pack(
        16, 24, [(torch.ones(k, k, c, crr, device=dev), None, r)
                 for k, c, crr, r in BLOCKS],
        (torch.ones(HEAD[0], HEAD[0], *HEAD[1:], device=dev), None),
        tm=128)[1]]
    where = [tf.border_mask(plan, device=dev)] + live + [1.0] * n
    for g, w, m in zip(got, grads(plain), where):
        assert float(((g - w) * m).abs().max()) <= 1e-4 * float(w.abs().max())


def test_calibration_step_runs_on_the_kernels(dev, monkeypatch):
    """One calibration step of the tiny HNeRV on the card: every tail conv,
    its dx and dW, the tail entries and their backward launch kernels, and
    no plain version is reached; the gradients equal the plain unpacked
    decoder's (cuDNN, NHWC loss) within 1e-4 of the largest."""
    from neuroquant_tpu_torch.models import build_model, tail_plan_for
    from neuroquant_tpu_torch.quantization import (
        init_quant_state, make_spec)
    from neuroquant_tpu_torch.quantization.calibrate import make_loss

    kern = build_model("hnerv", TINY_HNERV, device=dev)
    plain = build_model("hnerv", dict(TINY_HNERV, packed_tail="off"),
                        device=dev)
    plain.load_state_dict(kern.state_dict())
    params = {k: v.detach().clone() for k, v in kern.state_dict().items()}
    spec = make_spec("hnerv", TINY_HNERV, hadamard=True).with_bits(
        (6, 5, 4, 5, 6))
    state = init_quant_state(params, spec)
    gen = torch.Generator(device=dev).manual_seed(4)
    frames = torch.rand((2, 80, 160, 3), generator=gen, device=dev)
    with torch.no_grad():
        emb = kern.encode(frames)
    plan, f, ch = tail_plan_for("hnerv", TINY_HNERV)
    cf_pack = {"gt": tf.pack_targets(frames, plan, f),
               "mask": tf.border_mask(plan, ch=ch, device=dev),
               "denom": 80 * 160}

    def step(model, pack):
        st = {ln: {k: v.clone().requires_grad_(k == "w_delta")
                   for k, v in s.items()} for ln, s in state.items()}
        loss = make_loss(model, params, spec, "uaq", cf_pack=pack)
        total, _ = loss(st, pack["gt"] if pack else frames, emb, 1)
        total.backward()
        return float(total), [st[ln]["w_delta"].grad for ln in st]

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    with monkeypatch.context() as m:
        for name in ("conv_cf_ref", "conv_cf_dw_ref", "pack_cf_ref",
                     "unpack_cf_ref", "cf_to_nhwc", "unpack_frames_ref"):
            m.setattr(tf, name, refuse)
        tf.reset_launch_counts()
        loss_k, grads_k = step(kern, cf_pack)
        torch.cuda.synchronize()
        counts = dict(tf.KERNEL_LAUNCHES)
    loss_p, grads_p = step(plain, None)
    n = len(plan.layers) + 1                 # the tail and the prefix block
    assert counts == {"tail_conv_cf": 2 * n, "tail_conv_dw_cf": n,
                      "pack_cf": 2, "unpack_cf": 2, "unpack_frames": 0,
                      "fq_uaq": 0, "fq_ada": 0}
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    top = max(float(g.abs().max()) for g in grads_p)
    for a, b in zip(grads_k, grads_p):
        assert float((a - b).abs().max()) <= 1e-4 * top


def _fq_case(dev, khw, cin, cout, hadamard, channel_wise, bits, seed):
    from neuroquant_tpu_torch.ops import quant as Q
    from neuroquant_tpu_torch.ops.hadamard import fwht, pad_cin_to_pow2

    g = torch.Generator(device=dev).manual_seed(seed)
    # an OIHW parameter seen as HWIO, as quantize_params hands it over
    w = (torch.randn((cout, cin, *khw), generator=g, device=dev)
         * 0.2).permute(2, 3, 1, 0)
    dom = fwht(pad_cin_to_pow2(w), axis=2) if hadamard else w
    d, z = Q.init_weight_scale(dom, bits, channel_wise, "max")
    a = Q.adaround_init_alpha(dom, d) + 3 * torch.randn(
        dom.shape, generator=g, device=dev)
    return w, d, z, a


@pytest.mark.parametrize("mode", ["uaq", "soft", "hard"])
@pytest.mark.parametrize("khw,cin,cout,hadamard,channel_wise", [
    ((1, 1), 16, 92, True, True), ((3, 3), 77, 64, True, True),
    ((5, 5), 53, 44, True, True), ((3, 3), 37, 3, True, True),
    ((3, 3), 5, 7, True, True), ((1, 1), 1, 9, True, True),
    ((3, 3), 300, 5, True, True), ((1, 3), 1000, 3, True, True),
    ((5, 5), 44, 37, True, False), ((5, 5), 53, 44, False, True),
    ((3, 3), 37, 11, False, False)])
def test_fq_hadamard(dev, mode, khw, cin, cout, hadamard, channel_wise):
    from neuroquant_tpu_torch.ops import fused_fakequant as ff

    bits = 5
    w, d, z, a = _fq_case(dev, khw, cin, cout, hadamard, channel_wise, bits,
                          cin + cout)
    alpha, soft = (None if mode == "uaq" else a), mode != "hard"
    want = ff.fake_quant_ref(w, d, z, alpha, bits, hadamard, soft)
    tf.reset_launch_counts()
    got = ff.fused_fake_quant_hwio(w, d, z, bits, hadamard, alpha, soft)
    torch.cuda.synchronize()
    counts = dict(tf.KERNEL_LAUNCHES)
    assert counts.pop("fq_uaq" if mode == "uaq" else "fq_ada") == 1
    assert not any(counts.values())
    assert got.shape == want.shape
    err = (got - want).abs()
    assert float(err.max()) <= 1e-6 * max(1.0, float(want.abs().max()))
    # a flipped round or floor moves a transformed value by one delta
    assert int((err > 0.5 * d.min() / (w.shape[2] ** 0.5 * 2)).sum()) == 0
    # the same through a contiguous HWIO weight
    again = ff.fused_fake_quant_hwio(w.contiguous(), d, z, bits, hadamard,
                                     alpha, soft)
    assert torch.equal(again, got)


def test_fq_hadamard_refuses_what_it_does_not_take(dev):
    from neuroquant_tpu_torch.ops import fused_fakequant as ff

    s = torch.ones((1, 1, 1, 4), device=dev)
    with pytest.raises(ValueError, match="at most 1024"):
        ff.fused_fake_quant_hwio(torch.zeros((1, 1, 1025, 4), device=dev), s,
                                 s, 4)
    w = torch.zeros((3, 3, 8, 4), device=dev)
    with pytest.raises(ValueError, match="alpha"):
        ff.fused_fake_quant_hwio(w, s, s, 4, alpha=torch.zeros(
            (3, 3, 5, 4), device=dev))
    with pytest.raises(ValueError, match="delta"):
        ff.fused_fake_quant_hwio(w, torch.ones(3, device=dev), s, 4)
    with pytest.raises(ValueError, match="delta"):
        ff.fused_fake_quant_hwio(w, s.cpu(), s, 4)


@pytest.mark.parametrize("mode", ["uaq", "soft"])
def test_fq_functions_give_the_plain_gradients(dev, mode):
    """Kernel forward, the plain version's VJP backward: the gradients of
    w, delta, zp and alpha are those of autograd through the plain chain."""
    from neuroquant_tpu_torch.ops import fused_fakequant as ff

    w, d, z, a = _fq_case(dev, (3, 3), 53, 12, True, True, 4, 3)
    wt = torch.randn(w.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    tensors = (w, d, z) if mode == "uaq" else (w, d, z, a)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in tensors]
        (fn(*leaves) * wt).sum().backward()
        return [t.grad for t in leaves]

    tf.reset_launch_counts()
    if mode == "uaq":
        got = grads(lambda *t: ff.uaq_fake_quant(*t, 4, True))
        want = grads(lambda *t: ff.fake_quant_ref(*t, None, 4, True))
    else:
        got = grads(lambda *t: ff.ada_fake_quant(*t, 4, True, True))
        want = grads(lambda *t: ff.fake_quant_ref(*t, 4, True, True))
    assert tf.KERNEL_LAUNCHES["fq_uaq" if mode == "uaq" else "fq_ada"] == 1
    for g, r in zip(got, want):
        # the same chain on the same inputs; the cotangent is the same
        assert float((g - r).abs().max()) <= 1e-6 * max(
            1.0, float(r.abs().max()))


@pytest.mark.parametrize("mode,soft", [("uaq", True), ("adaround", True),
                                       ("adaround", False)])
def test_quantize_params_on_the_kernel(dev, mode, soft):
    """quantize_params(fq_impl='pallas') on the card: one launch per layer
    and the 'jnp' implementation's weights."""
    import dataclasses

    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization import (
        adaround_upgrade, init_quant_state, make_spec, quantize_params)

    model = build_model("hnerv", TINY_HNERV, device=dev).eval()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    spec = make_spec("hnerv", TINY_HNERV, hadamard=True).with_bits(
        (6, 5, 4, 5, 6))
    state = init_quant_state(params, spec)
    if mode == "adaround":
        state = adaround_upgrade(params, spec, state)
    want = quantize_params(params, spec, state, mode=mode, soft=soft)
    tf.reset_launch_counts()
    got = quantize_params(params, dataclasses.replace(spec, fq_impl="pallas"),
                          state, mode=mode, soft=soft)
    torch.cuda.synchronize()
    key = "fq_uaq" if mode == "uaq" else "fq_ada"
    assert tf.KERNEL_LAUNCHES[key] == spec.num_layers
    for k in want:
        assert got[k].shape == want[k].shape and got[k].is_contiguous()
        assert float((got[k] - want[k]).abs().max()) <= 1e-6 * max(
            1.0, float(want[k].abs().max())), k
