"""The CUDA kernels of neuroquant_tpu_torch against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and nvcc, and
skips without them (the CPU tests hold the plain versions against the JAX
package). The file imports neither JAX nor the JAX package, so it runs on
a machine without them:

  python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances: the conv sums fp32 products in another order than the plain
version's matmul, 1e-4 relative to the output's largest value; the layout
kernels copy, so they are exact; out_img 1e-6."""

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
    assert counts == {"tail_conv_cf": n_layers + 1, "pack_cf": 2,
                      "unpack_frames": 1}
    assert float((got - want).abs().max()) <= 1e-4
