"""The CUDA kernels of neuroquant_tpu_torch against their plain PyTorch
versions, on the card. Every test here needs a CUDA device and nvcc, and
skips without them (the CPU tests hold the plain versions against the JAX
package). The file imports neither JAX nor the JAX package, so it runs on
a machine without them:

  python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Tolerances: the conv, its dx pass and the dW kernel multiply on the tensor
cores with three TF32 products per fp32 product (~2^-20 of a product) and
sum in another order than the plain version's matmul, 1e-4 relative to the
output's largest value (gradients through a whole tail 1e-4 relative to
the largest gradient); the layout kernels copy, so they are exact;
out_img 1e-6; the fake-quant kernel 1e-6 of the output's largest value with
no flipped rounding decision (its butterfly repeats the plain chain's
operations in their order).

The bf16 instantiations (the ``_bf16`` cases): a conv's bf16 output within
one bf16 unit (2^-8 relative, the spacing at the element) of the plain
version's, which rounds the same fp32 sum once to nearest even: the two
sums differ only in their order, so an element whose sum lies that close
to a rounding boundary rounds the other way; beyond the unit, the fp32
tolerance above (1e-4 of the largest value) for elements near zero, whose
spacing is smaller than that order difference. dW and db within 1e-5 of
the largest: bf16 x bf16 products are exact in fp32, only the order of the
fp32 sums differs. The layout kernels copy or round once to nearest even
as the plain versions' casts do: exact; unpack_frames' bf16 frames within
one unit (its expf/tanhf against torch's). Gradients through a whole bf16
tail against the same Function on the CPU (the plain versions) within
2^-5 of each leaf's largest: every layer rounds its output and its dx to
bf16, and values that part by a unit move their successors' sums."""

import numpy as np
import pytest
import torch

from _layout_cases import PACK_CASES, UNPACK_CASES, case_id
from _layout_cases import plan as layout_plan
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
TINY_NERV = dict(
    crop_h=80, crop_w=160, diff_enc=False, base=1.25, level=16,
    channel_reduce=2, channel_lbound=6, dec_in_channel=32,
    dec_kernels=[3, 3, 3], dec_strides=[5, 4, 4], dec_norm="none",
    dec_acts="gelu", out_bias="tanh", loss="l2", epoch=4, workers=0,
    eval_freq=2, batch_size=2, learning_rate=0.002, n_frames=8)


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


def _tuple(t):
    return t if isinstance(t, tuple) else (t,)


def _counts(**launched):
    """The launch counts with every kernel not named at 0."""
    return {k: launched.get(k, 0) for k in tf.KERNEL_LAUNCHES}


def _assert_close(got, want, rel=1e-4):
    for a, b in zip(_tuple(got), _tuple(want)):
        assert a.shape == b.shape
        tol = rel * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("li", [0, 1, 2], ids=["f1", "f2", "head_f4"])
@pytest.mark.parametrize("emit,act_in", [("z", False), ("y", False),
                                         ("z", True), ("y", True),
                                         ("zy", False), ("zy", True)])
def test_tail_conv_cf(dev, small, li, emit, act_in):
    plan, kks, bms, _, _ = small
    layer = plan.layers[li]
    x = _cf(plan, layer.cin, dev, li)
    tf.reset_launch_counts()
    got = tf.conv_cf(x, kks[li], bms[li], plan, layer, emit, act_in)
    want = tf.conv_cf_ref(x, kks[li], bms[li], plan, layer, emit, act_in)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["tail_conv_cf"] == 1
    assert tf.KERNEL_LAUNCHES["tail_conv_cf_wgmma"] == 1
    assert len(_tuple(got)) == len(emit)
    _assert_close(got, want)
    w_op = tf.conv_w_operand(kks[li], plan, layer)       # packed beforehand
    again = tf.conv_cf(x, kks[li], bms[li], plan, layer, emit, act_in, w_op)
    assert all(torch.equal(a, b) for a, b in zip(_tuple(again), _tuple(got)))
    if emit == "zy":                   # both from the one accumulator
        assert torch.equal(got[0], tf.conv_cf(x, kks[li], bms[li], plan,
                                              layer, "z", act_in))
        assert torch.equal(got[1], tf.conv_cf(x, kks[li], bms[li], plan,
                                              layer, "y", act_in))


# (h, w, blocks (k, cin, cout*r*r, r), head (k, cin, cout), layer): the
# launch shapes the small fixture does not reach
SHAPES = {
    # 4 position tiles x K = 2304: the conv splits K across blocks
    "split_k": (6, 10, [(3, 256, 64, 2)], (3, 16, 3), 0),
    "cout48": (16, 24, [(3, 8, 48, 2)], (3, 12, 3), 0),      # one 64-tile
    "cout56": (16, 24, [(3, 8, 56, 2)], (3, 14, 3), 0),
    "cout176": (16, 24, [(3, 32, 176, 2)], (3, 44, 3), 0),    # two 96-tiles
    # two 128-tiles, the second with 5 of its 8 fragment rows
    "cout208": (16, 24, [(3, 32, 208, 2)], (3, 52, 3), 0),
    # K runs of 5 and of 3 rows: steps with zero rows
    "ragged5": (16, 24, [(3, 6, 20, 2), (3, 5, 12, 2)], (3, 3, 3), 1),
    "ragged3_f4": (16, 24, [(3, 6, 20, 2), (3, 5, 12, 2)], (3, 3, 3), 2),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tail_conv_kernels_launch_shapes(dev, shape):
    """Forward ('zy'), dx pass and dW at batch 2 (every shifted read near a
    batch boundary must read zero, not the neighbour frame) at launch shapes
    beyond the small fixture's; dW twice, the same bits."""
    h, w, blocks, head, li = SHAPES[shape]
    plan, _ = tf.plan_geometry(h, w, blocks, head, tm=128)
    layer = plan.layers[li]
    gen = torch.Generator(device=dev).manual_seed(len(shape))
    kk = torch.randn((layer.side, layer.side, layer.cin, layer.cout),
                     generator=gen, device=dev) * 0.2
    bias = torch.randn((layer.cout, 1), generator=gen, device=dev)
    # no zero border here: a read across the batch boundary would show
    x = torch.randn((2, layer.cin, plan.mp), generator=gen, device=dev)
    g = _cf(plan, layer.cout, dev, 7)
    kblocks = tf._k_blocks(plan, layer)
    if shape == "split_k":
        steps = tf._conv_steps(kblocks, layer.cin, layer.taps)[0]
        assert tf.conv_f32_geometry(layer.cout, plan.mp, 2,
                                    len(steps))["splits"] > 1
    _assert_close(tf.conv_cf(x, kk, bias, plan, layer, "zy"),
                  tf.conv_cf_ref(x, kk, bias, plan, layer, "zy",
                                 blocks=kblocks))
    lt = layer.transposed()
    kt = tf._kk_transpose(kk).contiguous()
    _assert_close(tf.conv_cf(g, kt, None, plan, lt, out_mul=x),
                  tf.conv_cf_ref(g, kt, None, plan, lt,
                                 blocks=tf._k_blocks(plan, lt), out_mul=x))
    got = tf.conv_cf_dw(x, g, plan, layer)
    _assert_close(got, tf.conv_cf_dw_ref(x, g, plan, layer, False, kblocks))
    again = tf.conv_cf_dw(x, g, plan, layer)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def _bunny_layers(dev):
    """The four conv layers of HNeRV Bunny-3M's kernel path, (plan, layer)
    for the fused prefix block and the tail's three layers."""
    import os

    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.models import build_model, tail_plan_for

    cfg = get_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                  "HNeRV", "Bunny_1280x640_3M.yaml"))
    model = build_model("hnerv", cfg, device=dev)
    kern = model.blocks[model.pack_start - 1].conv_params()[0]
    pplan = tf._prefix_plan(cfg["crop_h"] // 16, cfg["crop_w"] // 16,
                            kern.shape[0], kern.shape[2], kern.shape[3])
    plan = tail_plan_for("hnerv", cfg)[0]
    return [(pplan, pplan.layers[0])] + [(plan, l) for l in plan.layers]


# the K splits of a stage-1 step's dx passes and the position splits of its
# dW passes at batch 1: the prefix's dx splits K 4 ways (2 at batch 2)
BUNNY_B1_SPLITS = {"prefix": (4, 2), "L0": (1, 12), "L1": (1, 4),
                   "head": (1, 22)}


@pytest.mark.parametrize("name", list(BUNNY_B1_SPLITS))
def test_bunny_backward_at_batch_1(dev, name):
    """A stage-1 step's dx pass (GELU' epilogue where the layer's input
    went through GELU) and dW pass at HNeRV Bunny-3M, batch 1, against
    their plain versions: the launch geometries calibration's batch 2 does
    not reach."""
    plan, layer = _bunny_layers(dev)[list(BUNNY_B1_SPLITS).index(name)]
    gen = torch.Generator(device=dev).manual_seed(11)
    mask = tf.border_mask(plan, device=dev)
    x = torch.randn((1, layer.cin, plan.mp), generator=gen, device=dev) * mask
    g = torch.randn((1, layer.cout, plan.mp), generator=gen, device=dev) * mask
    kk = torch.randn((layer.side, layer.side, layer.cin, layer.cout),
                     generator=gen, device=dev) * 0.05
    lt = layer.transposed()
    kt = tf._kk_transpose(kk).contiguous()
    blocks = tf._k_blocks(plan, lt)
    nsteps = len(tf._conv_steps(blocks, lt.cin, lt.taps)[0])
    kblocks = tf._k_blocks(plan, layer)
    nk = tf.K_STEP * (len(tf._k_steps(kblocks, layer.cin, layer.taps)[0]) + 1)
    assert (tf.conv_f32_geometry(lt.cout, plan.mp, 1, nsteps)["splits"],
            tf._dw_split(nk, layer.cout, plan.mp)[0]) == \
        BUNNY_B1_SPLITS[name]
    om = x if layer.gelu_in else None
    tf.reset_launch_counts()
    _assert_close(tf.conv_cf(g.contiguous(), kt, None, plan, lt, out_mul=om),
                  tf.conv_cf_ref(g, kt, None, plan, lt, blocks=blocks,
                                 out_mul=om))
    got = tf.conv_cf_dw(x.contiguous(), g.contiguous(), plan, layer)
    _assert_close(got, tf.conv_cf_dw_ref(x, g, plan, layer, False, kblocks))
    torch.cuda.synchronize()
    assert (tf.KERNEL_LAUNCHES["tail_conv_cf"],
            tf.KERNEL_LAUNCHES["tail_conv_cf_wgmma"],
            tf.KERNEL_LAUNCHES["tail_conv_dw_cf"]) == \
        (1, 1, 1)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("name", list(BUNNY_B1_SPLITS))
def test_bunny_conv_on_the_wgmma_design(dev, name, batch):
    """Every fp32 conv pass HNeRV Bunny-3M's cells launch, on the TMA and
    3xTF32 wgmma design, against the plain version: the forward as the
    decode (z, y) and the steps (zy) run it and with act_in, and the dx
    pass with its GELU' epilogue; the prefix's dx splits K, L1's last
    channel tile is partial (592 = 4 x 128 + 80), the head has 48
    channels (the 64-channel tile), the head's dx pass has 5 K stages and
    592 channels. Each launch counts once under tail_conv_cf and once
    under tail_conv_cf_wgmma."""
    plan, layer = _bunny_layers(dev)[list(BUNNY_B1_SPLITS).index(name)]
    gen = torch.Generator(device=dev).manual_seed(41 + batch)
    mask = tf.border_mask(plan, device=dev)
    x = torch.randn((batch, layer.cin, plan.mp), generator=gen,
                    device=dev) * mask
    g = torch.randn((batch, layer.cout, plan.mp), generator=gen,
                    device=dev) * mask
    kk = torch.randn((layer.side, layer.side, layer.cin, layer.cout),
                     generator=gen, device=dev) * 0.05
    bias = torch.randn((layer.cout, 1), generator=gen, device=dev) * 0.1
    blocks = tf._k_blocks(plan, layer)
    lt = layer.transposed()
    kt = tf._kk_transpose(kk).contiguous()
    om = x if layer.gelu_in else None
    tf.reset_launch_counts()
    for emit, act_in in (("z", False), ("y", False), ("zy", False),
                         ("z", True)):
        _assert_close(tf.conv_cf(x, kk, bias, plan, layer, emit, act_in),
                      tf.conv_cf_ref(x, kk, bias, plan, layer, emit, act_in,
                                     blocks=blocks))
    _assert_close(tf.conv_cf(g, kt, None, plan, lt, out_mul=om),
                  tf.conv_cf_ref(g, kt, None, plan, lt,
                                 blocks=tf._k_blocks(plan, lt), out_mul=om))
    torch.cuda.synchronize()
    assert (tf.KERNEL_LAUNCHES["tail_conv_cf"],
            tf.KERNEL_LAUNCHES["tail_conv_cf_wgmma"]) == \
        (5, 5)


def test_f32_conv_launch_geometry_is_python_s(dev):
    """The fp32 launcher's tile, ring and shared memory are what
    tf.conv_f32_geometry computes."""
    import ctypes

    from neuroquant_tpu_torch.ops import _cuda

    out = (ctypes.c_int * 4)()
    for cout in (8, 48, 56, 64, 72, 96, 176, 592, 848):
        assert _cuda.lib().nq_tail_conv_cf_tile(cout, out) == 0
        geo = tf.conv_f32_geometry(cout, 4096, 1, 64)
        assert list(out) == [geo["bm"], geo["bn"], geo["stages"],
                             geo["smem"]], cout


def test_training_step_runs_on_the_kernels(dev, monkeypatch):
    """One stage-1 step of the tiny HNeRV at batch 1 on the card: the
    forward through the encoder and the fused tail, the l2 loss and the
    backward launch every tail conv, its dx and dW, both entries' pack_cf
    and unpack_cf and one unpack_frames, and no plain conv or pack runs;
    every gradient, encoder included, equals the plain unpacked path's
    (cuDNN) within 1e-4 of its leaf's largest."""
    from neuroquant_tpu_torch.metrics import loss_fn
    from neuroquant_tpu_torch.models import build_model, tail_plan_for

    kern = build_model("hnerv", TINY_HNERV, device=dev)
    plain = build_model("hnerv", dict(TINY_HNERV, fused_tail="off"),
                        device=dev)
    plain.load_state_dict(kern.state_dict())
    gen = torch.Generator(device=dev).manual_seed(5)
    img = torch.rand((1, 80, 160, 3), generator=gen, device=dev)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    with monkeypatch.context() as m:
        for fn in ("conv_cf_ref", "conv_cf_dw_ref", "pack_cf_ref",
                   "unpack_cf_ref"):
            m.setattr(tf, fn, refuse)
        tf.reset_launch_counts()
        loss_k = loss_fn(kern(img), img, "l2")
        loss_k.backward()
        torch.cuda.synchronize()
        counts = dict(tf.KERNEL_LAUNCHES)
    loss_p = loss_fn(plain(img), img, "l2")
    loss_p.backward()
    n = len(tail_plan_for("hnerv", TINY_HNERV)[0].layers) + 1
    assert counts == _counts(tail_conv_cf=2 * n, tail_conv_cf_wgmma=2 * n,
                             tail_conv_dw_cf=n, pack_cf=2, unpack_cf=2,
                             unpack_frames=1)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * float(loss_p)
    grads_p = dict(plain.named_parameters())
    for name, prm in kern.named_parameters():
        want = grads_p[name].grad
        assert float((prm.grad - want).abs().max()) <= \
            1e-4 * float(want.abs().max()), name


def _nerv_bunny_layers():
    """NeRV Bunny-3M's four conv layers on the kernels, (plan, layer): the
    fused prefix block 36 -> 24 * 16 at 40x80 (cin 36 padded to 40) and the
    tail's 24 -> 96 (f=1), 96 -> 384 (f=2, union-sparse) and head 384 -> 48
    (f=4) at 160x320."""
    import os

    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.models import tail_plan_for

    cfg = get_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                  "NeRV", "Bunny_1280x640_3M.yaml"))
    pplan = tf._prefix_plan(40, 80, 3, 36, 384)
    plan = tail_plan_for("nerv", cfg)[0]
    return [(pplan, pplan.layers[0])] + [(plan, l) for l in plan.layers]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("li", [0, 1, 2, 3],
                         ids=["prefix", "L3", "L4", "head"])
def test_nerv_bunny_conv_passes(dev, li, batch):
    """Each NeRV Bunny-3M conv's forward (z, and the pair zy), its dx pass
    (GELU' epilogue where its input went through GELU) and its dW pass at
    stage 1's batch 1 and calibration's batch 2, against their plain
    versions: the odd prefix width, the ragged K of 9 * 24 rows, grids with
    fewer tiles than the card holds blocks."""
    plan, layer = _nerv_bunny_layers()[li]
    gen = torch.Generator(device=dev).manual_seed(17 + li)
    mask = tf.border_mask(plan, device=dev)
    x = torch.randn((batch, layer.cin, plan.mp), generator=gen,
                    device=dev) * mask
    g = torch.randn((batch, layer.cout, plan.mp), generator=gen,
                    device=dev) * mask
    kk = torch.randn((layer.side, layer.side, layer.cin, layer.cout),
                     generator=gen, device=dev) * 0.05
    bias = torch.randn((layer.cout, 1), generator=gen, device=dev) * 0.1
    blocks = tf._k_blocks(plan, layer)
    tf.reset_launch_counts()
    for emit in ("z", "zy"):
        _assert_close(tf.conv_cf(x, kk, bias, plan, layer, emit),
                      tf.conv_cf_ref(x, kk, bias, plan, layer, emit,
                                     blocks=blocks))
    lt = layer.transposed()
    kt = tf._kk_transpose(kk).contiguous()
    om = x if layer.gelu_in else None
    _assert_close(tf.conv_cf(g, kt, None, plan, lt, out_mul=om),
                  tf.conv_cf_ref(g, kt, None, plan, lt,
                                 blocks=tf._k_blocks(plan, lt), out_mul=om))
    _assert_close(tf.conv_cf_dw(x, g, plan, layer),
                  tf.conv_cf_dw_ref(x, g, plan, layer, False, blocks))
    torch.cuda.synchronize()
    assert (tf.KERNEL_LAUNCHES["tail_conv_cf"],
            tf.KERNEL_LAUNCHES["tail_conv_cf_wgmma"],
            tf.KERNEL_LAUNCHES["tail_conv_dw_cf"]) == \
        (3, 3, 1)


def _pnerv_bunny_layers():
    """PNeRV Bunny-3M's two tail conv layers on the kernels, (plan, layer):
    the block 100 -> 400 (f=1, cin padded to 104, no union sparsity) and
    the head 400 -> 12 (f=2, padded to 16) at 320x640."""
    import os

    from neuroquant_tpu_torch.config import get_config
    from neuroquant_tpu_torch.models import tail_plan_for

    cfg = get_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                  "PNeRV", "Bunny_1280x640_3M.yaml"))
    plan = tail_plan_for("pnerv", cfg)[0]
    return [(plan, l) for l in plan.layers]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("li", [0, 1], ids=["block", "head"])
def test_pnerv_bunny_conv_passes(dev, li, batch):
    """Each PNeRV Bunny-3M tail conv's forward (z, y and the pair zy), its
    dx pass (GELU' epilogue where its input went
    through GELU) and its dW pass at batch 1 and 2, against their plain
    versions: the largest tail conv of the shipped configs and the
    narrowest head tile."""
    plan, layer = _pnerv_bunny_layers()[li]
    gen = torch.Generator(device=dev).manual_seed(29 + li)
    mask = tf.border_mask(plan, device=dev)
    x = torch.randn((batch, layer.cin, plan.mp), generator=gen,
                    device=dev) * mask
    g = torch.randn((batch, layer.cout, plan.mp), generator=gen,
                    device=dev) * mask
    kk = torch.randn((layer.side, layer.side, layer.cin, layer.cout),
                     generator=gen, device=dev) * 0.05
    bias = torch.randn((layer.cout, 1), generator=gen, device=dev) * 0.1
    blocks = tf._k_blocks(plan, layer)
    tf.reset_launch_counts()
    for emit in ("z", "y", "zy"):
        _assert_close(tf.conv_cf(x, kk, bias, plan, layer, emit),
                      tf.conv_cf_ref(x, kk, bias, plan, layer, emit,
                                     blocks=blocks))
    lt = layer.transposed()
    kt = tf._kk_transpose(kk).contiguous()
    om = x if layer.gelu_in else None
    _assert_close(tf.conv_cf(g, kt, None, plan, lt, out_mul=om),
                  tf.conv_cf_ref(g, kt, None, plan, lt,
                                 blocks=tf._k_blocks(plan, lt), out_mul=om))
    _assert_close(tf.conv_cf_dw(x, g, plan, layer),
                  tf.conv_cf_dw_ref(x, g, plan, layer, False, blocks))
    torch.cuda.synchronize()
    assert (tf.KERNEL_LAUNCHES["tail_conv_cf"],
            tf.KERNEL_LAUNCHES["tail_conv_cf_wgmma"],
            tf.KERNEL_LAUNCHES["tail_conv_dw_cf"]) == \
        (4, 4, 1)


def _bunny_passes_bf16(dev, plan, layer, seed, emits):
    """A Bunny-3M conv's forward (each of `emits`), dx pass (GELU' epilogue
    where its input went through GELU) and dW pass at batch 1 and 2 on the
    bf16 instantiations against their plain versions; the launches."""
    for batch in (1, 2):
        gen = torch.Generator(device=dev).manual_seed(seed + batch)
        mask = tf.border_mask(plan, device=dev)
        x = (torch.randn((batch, layer.cin, plan.mp), generator=gen,
                         device=dev) * mask).to(BF16)
        g = (torch.randn((batch, layer.cout, plan.mp), generator=gen,
                         device=dev) * mask).to(BF16)
        kk = (torch.randn((layer.side, layer.side, layer.cin, layer.cout),
                          generator=gen, device=dev) * 0.05).to(BF16)
        bias = (torch.randn((layer.cout, 1), generator=gen, device=dev)
                * 0.1).to(BF16)
        blocks = tf._k_blocks(plan, layer)
        tf.reset_launch_counts()
        for emit in emits:
            _bf16_close(tf.conv_cf(x, kk, bias, plan, layer, emit),
                        tf.conv_cf_ref(x, kk, bias, plan, layer, emit,
                                       blocks=blocks))
        lt = layer.transposed()
        kt = tf._kk_transpose(kk).contiguous()
        om = x if layer.gelu_in else None
        _bf16_close(tf.conv_cf(g, kt, None, plan, lt, out_mul=om),
                    tf.conv_cf_ref(g, kt, None, plan, lt,
                                   blocks=tf._k_blocks(plan, lt),
                                   out_mul=om))
        for a, b in zip(tf.conv_cf_dw(x, g, plan, layer),
                        tf.conv_cf_dw_ref(x, g, plan, layer, False, blocks)):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        torch.cuda.synchronize()
        assert (tf.KERNEL_LAUNCHES["tail_conv_cf_bf16"],
                tf.KERNEL_LAUNCHES["tail_conv_dw_cf_bf16"],
                tf.KERNEL_LAUNCHES["tail_conv_cf"]) == (len(emits) + 1, 1, 0)


@pytest.mark.parametrize("li", [0, 1, 2, 3],
                         ids=["prefix", "L3", "L4", "head"])
def test_nerv_bunny_conv_passes_bf16(dev, li):
    """test_nerv_bunny_conv_passes on the bf16 instantiations (each batch
    1 and 2)."""
    plan, layer = _nerv_bunny_layers()[li]
    _bunny_passes_bf16(dev, plan, layer, 170 + li, ("z", "zy"))


@pytest.mark.parametrize("li", [0, 1], ids=["block", "head"])
def test_pnerv_bunny_conv_passes_bf16(dev, li):
    """test_pnerv_bunny_conv_passes on the bf16 instantiations: the block
    104 -> 400 at 320x640 and the head 400 -> 16 (batch 1 and 2)."""
    plan, layer = _pnerv_bunny_layers()[li]
    _bunny_passes_bf16(dev, plan, layer, 290 + li, ("z", "y", "zy"))


def test_nerv_training_step_runs_on_the_kernels(dev, monkeypatch):
    """One stage-1 step of the tiny NeRV at batch 1 on the card: the
    position encoding's table, layer 0's (1, 2) shuffle, the fused prefix
    block and the tail, the l2 loss and the backward launch every tail
    conv, its dx and dW, both entries' pack_cf and unpack_cf and one
    unpack_frames, no plain conv or pack; every gradient equals the plain
    unpacked path's (cuDNN) within 1e-4 of its leaf's largest."""
    from neuroquant_tpu_torch.metrics import loss_fn
    from neuroquant_tpu_torch.models import build_model, tail_plan_for

    kern = build_model("nerv", TINY_NERV, device=dev)
    plain = build_model("nerv", dict(TINY_NERV, fused_tail="off"),
                        device=dev)
    plain.load_state_dict(kern.state_dict())
    gen = torch.Generator(device=dev).manual_seed(6)
    img = torch.rand((1, 80, 160, 3), generator=gen, device=dev)
    idx = torch.tensor([3 / 8], device=dev)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    with monkeypatch.context() as m:
        for fn in ("conv_cf_ref", "conv_cf_dw_ref", "pack_cf_ref",
                   "unpack_cf_ref"):
            m.setattr(tf, fn, refuse)
        tf.reset_launch_counts()
        loss_k = loss_fn(kern(idx), img, "l2")
        loss_k.backward()
        torch.cuda.synchronize()
        counts = dict(tf.KERNEL_LAUNCHES)
    loss_p = loss_fn(plain(idx), img, "l2")
    loss_p.backward()
    n = len(tail_plan_for("nerv", TINY_NERV)[0].layers) + 1
    assert counts == _counts(tail_conv_cf=2 * n, tail_conv_cf_wgmma=2 * n,
                             tail_conv_dw_cf=n, pack_cf=2, unpack_cf=2,
                             unpack_frames=1)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * float(loss_p)
    grads_p = dict(plain.named_parameters())
    for name, prm in kern.named_parameters():
        want = grads_p[name].grad
        assert float((prm.grad - want).abs().max()) <= \
            1e-4 * float(want.abs().max()), name


def _rand(dev, shape, seed, offset=0):
    """Random values of `shape` on the card; with `offset`, a contiguous
    view that starts `offset` floats past a 16-byte boundary."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = int(np.prod(shape))
    buf = torch.randn((n + offset,), generator=g, device=dev)
    return buf[offset:].view(shape)


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("case", PACK_CASES, ids=case_id)
def test_pack_cf(dev, case, offset):
    """The Bunny-3M entries at batch 1 and 2, the fixtures' plans, channel
    counts 1 to 100, widths that are no multiple of 4 or of the tile; the
    input aligned or 1 or 3 floats past a 16-byte boundary: exact."""
    name, c, nb = case
    plan, _ = layout_plan(name)
    x = _rand(dev, (nb, plan.h, plan.w, c), c + nb, offset)
    tf.reset_launch_counts()
    got = tf.pack_cf(x, plan)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["pack_cf"] == 1
    assert torch.equal(got, tf.pack_cf_ref(x, plan))


@pytest.mark.parametrize("case", [("bunny", 53, 1), ("bunny_prefix", 64, 2),
                                  ("f2_w13", 5, 2)], ids=case_id)
def test_pack_cf_writes_every_pad(dev, case):
    """torch.empty hands back freed memory: a same-sized buffer is filled
    with NaN and freed first, so a border, channel pad or tail pad element
    the kernel did not write would show."""
    name, c, nb = case
    plan, _ = layout_plan(name)
    x = _rand(dev, (nb, plan.h, plan.w, c), 5)
    junk = torch.full((nb, tf._r8(c), plan.mp), float("nan"), device=dev)
    ptr = junk.data_ptr()
    del junk
    got = tf.pack_cf(x, plan)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr          # the NaN-filled block came back
    live = tf.border_mask(plan, device=dev).reshape(-1) > 0
    assert bool((got[:, :, ~live] == 0).all())       # ring and tail pad
    assert bool((got[:, c:, :] == 0).all())          # channel pad
    assert torch.equal(got, tf.pack_cf_ref(x, plan))


@pytest.mark.parametrize("out_bias", ["sigmoid", "tanh", "0.5"])
@pytest.mark.parametrize("case", UNPACK_CASES, ids=case_id)
def test_unpack_frames(dev, case, out_bias):
    """The Bunny-3M decode at batch 1 and 2, UVG's f=6, the fixtures' plans,
    the plan whose JAX unpack is the width-tiled _unpack_kernel5 (case
    width_tiled), f = 2, 3, 4, 6 with widths that are no multiple of 4 or
    of the span, c = 1 to 13 (the generic instantiation): out_img 1e-6."""
    name, c, nb = case
    plan, f = layout_plan(name)
    ch = c * f * f
    cp = max(plan.layers[-1].cout, tf._r8(ch))
    z = _rand(dev, (nb, cp, plan.mp), f + c, offset=2 if nb == 1 else 0)
    tf.reset_launch_counts()
    got = tf.unpack_frames(z, plan, f, ch, out_bias)
    want = tf.unpack_frames_ref(z, plan, f, ch, out_bias)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["unpack_frames"] == 1
    assert got.shape == want.shape == (nb, plan.h * f, plan.w * f, c)
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
    assert counts == _counts(tail_conv_cf=n_layers + 1,
                             tail_conv_cf_wgmma=n_layers + 1, pack_cf=2,
                             unpack_frames=1)
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
    tf.reset_launch_counts()
    got = tf.unpack_cf(g, plan, c)
    assert tf.KERNEL_LAUNCHES["unpack_cf"] == 1    # the parameter block path
    assert got.shape == (2, plan.h, plan.w, c) and got.is_contiguous()
    assert torch.equal(got, tf.unpack_cf_ref(g, plan, c))
    assert torch.equal(tf.unpack_cf(g, plan, c), got)     # a cached block


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("case", PACK_CASES, ids=case_id)
def test_unpack_cf_cases(dev, case, offset):
    """The Bunny-3M step's two entries at batch 1 and 2, the fixtures'
    plans, channel counts 1 to 100, widths that are no multiple of 4 or of
    the tile; the input aligned or 1 or 3 floats past a 16-byte boundary;
    NaN in its border ring, channel pad and tail pad, which must not reach
    the output: exact."""
    name, c, nb = case
    plan, _ = layout_plan(name)
    g = _rand(dev, (nb, tf._r8(c), plan.mp), c + nb, offset)
    live = tf.border_mask(plan, device=dev).reshape(-1) > 0
    g[:, :, ~live] = float("nan")
    g[:, c:] = float("nan")
    tf.reset_launch_counts()
    got = tf.unpack_cf(g, plan, c)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["unpack_cf"] == 1
    assert not bool(got.isnan().any())
    assert torch.equal(got, tf.unpack_cf_ref(g, plan, c))


def test_second_derivative_through_the_layout_functions_raises(dev, small):
    """pack_cf's backward (unpack_cf) and unpack_frames' build no graph:
    a second derivative through either raises on the card, as on the
    CPU."""
    plan = small[0]
    for fn in ("pack_cf", "unpack_frames"):
        if fn == "pack_cf":
            x = _rand(dev, (2, plan.h, plan.w, 5), 7).requires_grad_()
            y = tf.pack_cf(x, plan)
        else:
            x = _cf(plan, plan.layers[-1].cout, dev, 8).requires_grad_()
            y = tf.unpack_frames(x, plan, 4, 48, "tanh")
        (first,) = torch.autograd.grad((y ** 2).sum(), [x],
                                       create_graph=True)
        with pytest.raises(RuntimeError, match="not have been used"):
            torch.autograd.grad((first * first).sum(), [x])
        with pytest.raises(RuntimeError, match="differentiate twice"):
            (first * first).sum().backward()


def test_tail_apply_fo_on_the_kernels(dev, small):
    """The forward-mode tail on the card against its plain versions on the
    CPU: value, tangent and grad-of-jvp (Hv w.r.t. the kernels), 1e-4 of
    the largest value; each conv_p differentiated once: 3 forward conv
    launches a layer, dx where its input needs one, dW where its kernel
    does."""
    plan, kks, bms, _, _ = small
    x0 = _cf(plan, plan.layers[0].cin, dev, 60)
    dx0 = _cf(plan, plan.layers[0].cin, dev, 61)
    wt = _cf(plan, plan.layers[-1].cout, dev, 62)
    gen = torch.Generator(device=dev).manual_seed(63)
    dks = [0.01 * torch.randn(k.shape, generator=gen, device=dev)
           for k in kks]

    def run(d):
        ks = [k.detach().to(d, copy=True).requires_grad_() for k in kks]
        h, dh = tf.tail_apply_fo(plan, x0.to(d), dx0.to(d), ks,
                                 [k.to(d) for k in dks],
                                 [b.to(d) for b in bms])
        hv = torch.autograd.grad((dh * wt.to(d) * h).sum(), ks)
        return [t.detach().cpu() for t in (h, dh, *hv)]

    tf.reset_launch_counts()
    got = run(dev)
    torch.cuda.synchronize()
    n = len(plan.layers)
    # the first layer's input and its tangent need no gradient: no dx, and
    # its conv_p(x, dk) none at all
    assert tf.KERNEL_LAUNCHES["tail_conv_cf"] == 3 * n + 3 * (n - 1)
    assert tf.KERNEL_LAUNCHES["tail_conv_dw_cf"] == 2 * n
    for g, w in zip(got, run("cpu")):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_hvp_on_the_kernels_matches_the_plain_path(dev):
    """One batch's Hv of the tiny HNeRV: the forward-mode tail on the
    kernels (fused_tail pallas_hvp; no unpack_frames) against the plain
    unpacked decode (cuDNN), 1e-4 of each leaf's largest."""
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.quantization import (
        get_perturbation, hessian_vector_product, init_quant_state,
        make_spec)

    kern = build_model("hnerv", dict(TINY_HNERV, fused_tail="pallas_hvp"),
                       device=dev)
    plain = build_model("hnerv", dict(TINY_HNERV, fused_tail="off"),
                        device=dev)
    plain.load_state_dict(kern.state_dict())
    params = {k: v.detach().clone() for k, v in kern.state_dict().items()}
    spec = make_spec("hnerv", TINY_HNERV).with_bits((2, 3, 4, 6, 4))
    vec = get_perturbation(params, spec, init_quant_state(params, spec))
    gen = torch.Generator(device=dev).manual_seed(5)
    frames = torch.rand((2, 80, 160, 3), generator=gen, device=dev)
    tf.reset_launch_counts()
    got = hessian_vector_product(kern, spec, vec, frames, None, [[0, 1]])
    torch.cuda.synchronize()
    counts = dict(tf.KERNEL_LAUNCHES)
    want = hessian_vector_product(plain, spec, vec, frames, None, [[0, 1]])
    for k in ("tail_conv_cf", "tail_conv_dw_cf", "pack_cf", "unpack_cf"):
        assert counts[k] > 0, counts
    assert counts["unpack_frames"] == 0, counts
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


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
    assert counts == _counts(tail_conv_cf=2 * n, tail_conv_cf_wgmma=2 * n,
                             tail_conv_dw_cf=n, pack_cf=2, unpack_cf=2)
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
    with pytest.raises(ValueError, match="at most 256"):
        ff.fused_fake_quant_hwio(torch.zeros((17, 17, 8, 4), device=dev), s,
                                 s, 4)
    for first, second in ((w, w.cpu()), (w.cpu(), w)):  # either order
        with pytest.raises(ValueError, match="several devices"):
            ff.fake_quant_group([(first, s.to(first.device),
                                  s.to(first.device), None, 4, True),
                                 (second, s.to(second.device),
                                  s.to(second.device), None, 4, True)], True)
    # the backward launch takes the gradient the forward's output gets
    with pytest.raises(ValueError, match="gradient"):
        ff._backward([(w, s, s, None, 4, True)], True,
                     [torch.zeros(w.shape, dtype=torch.float64, device=dev)],
                     [(False, True, False, False)])


def _fq_grads_close(got, want, scales, what):
    """dw and dalpha within 1e-6 of the leaf's largest value (the kernel
    takes autograd's products in autograd's order); the reduced ddelta and
    dzp within 1e-5 of each channel's sum of the magnitudes of their terms
    (an fp32 sum in another order; their two halves cancel)."""
    for name, g, w, sc in zip(("dw", "ddelta", "dzp", "dalpha"), got, want,
                              (None, *scales, None)):
        if w is None:
            assert g is None or not bool(g.any()), (what, name)
            continue
        assert g.shape == w.shape, (what, name)
        err = (g - w).abs()
        tol = (1e-5 * sc if sc is not None
               else 1e-6 * max(1.0, float(w.abs().max())))
        assert bool((err <= tol).all()), (what, name, float(err.max()))


@pytest.mark.parametrize("mode", ["uaq", "soft", "hard"])
@pytest.mark.parametrize("khw,cin,cout,hadamard,channel_wise", [
    ((3, 3), 53, 12, True, True), ((5, 5), 64, 9, True, True),
    ((1, 1), 92, 40, True, False), ((3, 3), 37, 3, False, True),
    ((3, 3), 300, 5, True, True)])
def test_fq_functions_give_the_plain_gradients(dev, mode, khw, cin, cout,
                                               hadamard, channel_wise):
    """The backward kernel: the gradients of w, delta, zp and alpha against
    the closed form (fake_quant_vjp_ref) and autograd through the plain
    chain, one forward and one backward launch; the same bits twice."""
    from neuroquant_tpu_torch.ops import fused_fakequant as ff

    w, d, z, a = _fq_case(dev, khw, cin, cout, hadamard, channel_wise, 4, 3)
    wt = torch.randn(w.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    alpha, soft = (None if mode == "uaq" else a), mode != "hard"
    tensors = (w, d, z) if alpha is None else (w, d, z, a)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in tensors]
        (fn(*leaves) * wt).sum().backward()
        return [t.grad for t in leaves] + [None] * (4 - len(leaves))

    def kernel(*t):
        if alpha is None:
            return ff.uaq_fake_quant(*t, 4, hadamard)
        return ff.ada_fake_quant(*t, 4, hadamard, soft)

    tf.reset_launch_counts()
    got = grads(kernel)
    torch.cuda.synchronize()
    name = "fq_uaq" if alpha is None else "fq_ada"
    assert tf.KERNEL_LAUNCHES[name] == 1
    assert tf.KERNEL_LAUNCHES[name + "_bwd"] == 1
    want = grads(lambda *t: ff.fake_quant_ref(*t[:3], t[3] if len(t) > 3
                                              else None, 4, hadamard, soft))
    closed = ff.fake_quant_vjp_ref(wt, w, d, z, alpha, 4, hadamard, soft)
    scales = ff.fake_quant_vjp_ref(
        wt, w, d, z, alpha, 4, hadamard, soft,
        sum_like=lambda t, like: ff._sum_like(t.abs(), like))[1:3]
    _fq_grads_close(got, closed, scales, "closed form")
    _fq_grads_close(got, want, scales, "autograd")
    again = grads(kernel)
    for g1, g2 in zip(got, again):
        assert (g1 is None) == (g2 is None)
        assert g1 is None or torch.equal(g1, g2)     # no atomics


def test_fq_group_is_the_plain_chain(dev):
    """One grouped launch over a mixed-rounding group (UAQ, soft, hard;
    channel-wise and per-layer scales; 1x1, 3x3, 5x5; C_in 16-300) gives
    each layer's plain chain bit for bit, and one backward launch its
    closed-form gradients."""
    from neuroquant_tpu_torch.ops import fused_fakequant as ff

    specs = [((3, 3), 53, 12, True, "uaq"), ((1, 1), 16, 92, True, "soft"),
             ((5, 5), 44, 7, False, "uaq"), ((3, 3), 37, 3, True, "hard"),
             ((5, 5), 64, 9, False, "soft"), ((3, 3), 300, 5, True, "soft")]
    leaves, layers, cots = [], [], []
    for i, (khw, cin, cout, cw, mode) in enumerate(specs):
        w, d, z, a = _fq_case(dev, khw, cin, cout, True, cw, 5, 40 + i)
        lv = [t.detach().clone().requires_grad_() for t in (w, d, z, a)]
        if mode == "uaq":
            lv[3] = None
        leaves.append(lv)
        layers.append((*lv, 5, mode != "hard"))
        cots.append(torch.randn(w.shape, device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(i)))
    tf.reset_launch_counts()
    outs = ff.fake_quant_group(layers, True)
    sum((o * c).sum() for o, c in zip(outs, cots)).backward()
    torch.cuda.synchronize()
    counts = {k: v for k, v in tf.KERNEL_LAUNCHES.items() if v}
    assert counts == {"fq_ada": 1, "fq_ada_bwd": 1}, counts
    for lv, (*_, bits, soft), out, cot in zip(leaves, layers, outs, cots):
        w, d, z, a = (None if t is None else t.detach() for t in lv)
        assert torch.equal(out.detach(),
                           ff.fake_quant_ref(w, d, z, a, bits, True, soft))
        closed = ff.fake_quant_vjp_ref(cot, w, d, z, a, bits, True, soft)
        scales = ff.fake_quant_vjp_ref(
            cot, w, d, z, a, bits, True, soft,
            sum_like=lambda t, like: ff._sum_like(t.abs(), like))[1:3]
        _fq_grads_close([None if t is None else t.grad for t in lv], closed,
                        scales, "group")


@pytest.mark.parametrize("mode,soft,mixed", [
    ("uaq", True, False), ("adaround", True, False),
    ("adaround", False, False), ("adaround", True, True)])
def test_quantize_params_on_the_kernel(dev, mode, soft, mixed):
    """quantize_params(fq_impl='pallas') on the card: one forward launch
    per call and one backward launch per backward (a mixed-rounding state
    too: AdaRound on every other layer), the 'jnp' implementation's weights
    bit for bit and its trained leaves' gradients (alphas 1e-6 of the
    largest; deltas, reduced in another order, 1e-5)."""
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
        state = adaround_upgrade(params, spec, state, only=(
            tuple(spec.layer_names[::2]) if mixed else None))
    leaf = "w_delta" if mode == "uaq" else "w_alpha"
    gen = torch.Generator(device=dev).manual_seed(5)
    cot = {k: torch.randn(v.shape, generator=gen, device=dev)
           for k, v in params.items() if k.endswith("weight")}

    def run(sp):
        st = {ln: {k: v.clone().requires_grad_(k == leaf)
                   for k, v in s.items()} for ln, s in state.items()}
        out = quantize_params(params, sp, st, mode=mode, soft=soft)
        torch.cuda.synchronize()
        fwd = dict(tf.KERNEL_LAUNCHES)
        total = sum((out[k] * c).sum() for k, c in cot.items())
        if total.requires_grad:       # hard rounding: no path to an alpha
            total.backward()
        return out, {ln: st[ln][leaf].grad for ln in st if leaf in st[ln]}, fwd

    want, gwant, _ = run(spec)
    tf.reset_launch_counts()
    got, ggot, fwd = run(dataclasses.replace(spec, fq_impl="pallas"))
    torch.cuda.synchronize()
    key = "fq_uaq" if mode == "uaq" else "fq_ada"
    assert {k: v for k, v in fwd.items() if v} == {key: 1}, fwd
    counts = {k: v for k, v in tf.KERNEL_LAUNCHES.items() if v}
    assert counts == ({key: 1, key + "_bwd": 1} if soft or mode == "uaq"
                      else {key: 1}), counts     # hard alphas get nothing
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].is_contiguous()
        g, w = got[k].detach(), want[k].detach()
        if k.endswith("weight"):
            assert torch.equal(g, w), k
        assert float((g - w).abs().max()) <= 1e-6 * max(
            1.0, float(w.abs().max())), k
    for ln, g in gwant.items():
        if g is None:
            assert ggot[ln] is None, ln
            continue
        tol = 1e-5 if leaf == "w_delta" else 1e-6
        assert float((ggot[ln] - g).abs().max()) <= tol * max(
            1e-30, float(g.abs().max())), ln


# ---- bf16 instantiations ---------------------------------------------------
BF16 = torch.bfloat16


def _units(t):
    """The bf16 spacing at each element of t (2^-7 of the power of two at
    or below |t|)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _bf16_close(got, want, rel=1e-4):
    """Every element within one bf16 unit, beyond `rel` of the largest."""
    for a, b in zip(_tuple(got), _tuple(want)):
        assert a.dtype == b.dtype == BF16 and a.shape == b.shape
        a, b = a.float(), b.float()
        tol = (torch.maximum(_units(a), _units(b))
               + rel * max(1.0, float(b.abs().max())))
        assert bool(((a - b).abs() <= tol).all()), \
            float(((a - b).abs() - tol).max())


def _small_bf16(small):
    plan, kks, bms, _, _ = small
    return plan, [k.to(BF16) for k in kks], [b.to(BF16) for b in bms]


@pytest.mark.parametrize("li", [0, 1, 2], ids=["f1", "f2", "head_f4"])
@pytest.mark.parametrize("emit,act_in", [("z", False), ("y", False),
                                         ("z", True), ("y", True),
                                         ("zy", False), ("zy", True)])
def test_tail_conv_cf_bf16(dev, small, li, emit, act_in):
    plan, kks, bms = _small_bf16(small)
    layer = plan.layers[li]
    x = _cf(plan, layer.cin, dev, li).to(BF16)
    tf.reset_launch_counts()
    got = tf.conv_cf(x, kks[li], bms[li], plan, layer, emit, act_in)
    want = tf.conv_cf_ref(x, kks[li], bms[li], plan, layer, emit, act_in)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["tail_conv_cf_bf16"] == 1
    assert tf.KERNEL_LAUNCHES["tail_conv_cf"] == 0
    _bf16_close(got, want)
    w_op = tf.conv_w_operand(kks[li], plan, layer)
    assert w_op.dtype == BF16
    again = tf.conv_cf(x, kks[li], bms[li], plan, layer, emit, act_in, w_op)
    assert all(torch.equal(a, b) for a, b in zip(_tuple(again), _tuple(got)))
    if emit == "zy":                   # both from the one accumulator
        assert torch.equal(got[0], tf.conv_cf(x, kks[li], bms[li], plan,
                                              layer, "z", act_in))
        assert torch.equal(got[1], tf.conv_cf(x, kks[li], bms[li], plan,
                                              layer, "y", act_in))


def _bf16_launch_shape(dev, plan, layer, seed):
    """Forward ('zy'), the dx pass with its GELU' epilogue and dW twice (the
    same bits) at batch 2 on the bf16 instantiations, x without a zero
    border (a read across the batch boundary would show)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kk = (torch.randn((layer.side, layer.side, layer.cin, layer.cout),
                      generator=gen, device=dev) * 0.2).to(BF16)
    bias = torch.randn((layer.cout, 1), generator=gen, device=dev).to(BF16)
    x = torch.randn((2, layer.cin, plan.mp), generator=gen,
                    device=dev).to(BF16)
    g = _cf(plan, layer.cout, dev, 7).to(BF16)
    kblocks = tf._k_blocks(plan, layer)
    _bf16_close(tf.conv_cf(x, kk, bias, plan, layer, "zy"),
                tf.conv_cf_ref(x, kk, bias, plan, layer, "zy",
                               blocks=kblocks))
    lt = layer.transposed()
    kt = tf._kk_transpose(kk).contiguous()
    _bf16_close(tf.conv_cf(g, kt, None, plan, lt, out_mul=x),
                tf.conv_cf_ref(g, kt, None, plan, lt,
                               blocks=tf._k_blocks(plan, lt), out_mul=x))
    got = tf.conv_cf_dw(x, g, plan, layer)
    want = tf.conv_cf_dw_ref(x, g, plan, layer, False, kblocks)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    again = tf.conv_cf_dw(x, g, plan, layer)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tail_conv_kernels_launch_shapes_bf16(dev, shape):
    """The launch shapes of test_tail_conv_kernels_launch_shapes on the
    bf16 instantiations: forward ('zy'), the dx pass (split K at
    'split_k') and dW twice, the same bits."""
    h, w, blocks, head, li = SHAPES[shape]
    plan, _ = tf.plan_geometry(h, w, blocks, head, tm=128)
    _bf16_launch_shape(dev, plan, plan.layers[li], len(shape))


# (h, w, blocks, head, layer): the bf16 kernels' edges. Their tiles are
# 128 channels x 128 positions or 64 x 256 (tf.conv_bf16_tile), their dW
# tiles 64, 96 or 128 channels x 128 K rows (tf.dw_bf16_tile); x rows come
# by TMA boxes of 4-32 rows (a run of steps, tf._box_plan) from the shift
# rounded down to 8 positions and are realigned on the chip.
BF16_EDGES = {
    # cout 200: two 128-channel tiles, the second 72 channels short; its
    # dx (cout 16) a 64 x 256 tile past Mp; dW 200 in 4 x 64 (56 short)
    "cout200": (16, 24, [(3, 16, 200, 2)], (3, 50, 3), 0),
    # cout 136: three 64-channel tiles (64 x 256), the last 8 channels;
    # dW 136 in 2 x 96
    "cout136_wide": (16, 24, [(3, 32, 136, 2)], (3, 34, 3), 0),
    # Mp = (h + 2P)(w + 2P) exactly: no flat padding, so the shifted boxes
    # start before 0 and end past Mp at the batch boundary
    "mp_exact": (14, 30, [(3, 6, 20, 2), (3, 5, 12, 2)], (3, 3, 3), 1),
    "mp_exact_f4": (14, 30, [(3, 6, 20, 2), (3, 5, 12, 2)], (3, 3, 3), 2),
    "mp_exact_wide": (14, 30, [(3, 32, 136, 2)], (3, 34, 3), 0),
    # a head packed with f=4 over 37-channel groups: runs of 37 (a box of
    # 8 steps, then 1, the last step one valid row); its dx runs of 3
    "runs37_f4": (16, 24, [(3, 8, 16, 2), (3, 4, 148, 2)], (3, 37, 3), 2),
    # K = 2304 at 4 position tiles: the forward and dx split K (9 or more
    # splits), the dW splits positions
    "split_k": (6, 10, [(3, 256, 64, 2)], (3, 16, 3), 0),
    # long runs: 64 channels at each of 25 shifts, boxes of 32 rows
    "runs64_k5": (12, 20, [(5, 64, 96, 1)], (3, 96, 3), 0),
}


@pytest.mark.parametrize("shape", sorted(BF16_EDGES))
def test_bf16_conv_edges(dev, shape):
    h, w, blocks, head, li = BF16_EDGES[shape]
    plan, _ = tf.plan_geometry(h, w, blocks, head, tm=128)
    layer = plan.layers[li]
    if shape.startswith("mp_exact"):
        assert plan.mp == plan.hp * plan.wp
    if shape == "split_k":
        steps = tf._conv_steps(tf._k_blocks(plan, layer), layer.cin,
                               layer.taps)[0]
        assert tf.conv_bf16_geometry(layer.cout, plan.mp, 2,
                                     len(steps))["splits"] > 1
    tf.reset_launch_counts()
    _bf16_launch_shape(dev, plan, layer, 100 + len(shape))
    torch.cuda.synchronize()
    assert (tf.KERNEL_LAUNCHES["tail_conv_cf_bf16"],
            tf.KERNEL_LAUNCHES["tail_conv_dw_cf_bf16"]) == (2, 2)


def test_bf16_conv_launch_geometry_is_python_s(dev):
    """The launchers' tiles, stages and shared memory are the ones
    tf.conv_bf16_geometry and tf.dw_bf16_geometry compute."""
    import ctypes

    from neuroquant_tpu_torch.ops import _cuda

    lib = _cuda.lib()
    for cout in (8, 16, 48, 56, 64, 72, 136, 176, 200, 384, 400, 592, 848,
                 1152, 1408):
        out = (ctypes.c_int * 4)()
        assert lib.nq_tail_conv_cf_bf16_tile(cout, ctypes.addressof(out)) == 0
        geo = tf.conv_bf16_geometry(cout, 4096, 1, 64)
        assert list(out) == [geo["bm"], geo["bn"], geo["stages"],
                             geo["smem"]], cout
        out3 = (ctypes.c_int * 3)()
        assert lib.nq_tail_conv_dw_cf_bf16_tile(
            cout, ctypes.addressof(out3)) == 0
        dgeo = tf.dw_bf16_geometry(64, cout, 1, 4096)
        assert list(out3) == [dgeo["bn"], dgeo["stages"], dgeo["smem"]], cout


def test_bf16_conv_refuses_what_tma_does_not_take(dev, small):
    """A bf16 tensor whose data does not start on 16 bytes, or a layer of
    a cout that is not a multiple of 8, raises before any launch."""
    plan, kks, bms = _small_bf16(small)
    layer = plan.layers[0]
    x = _cf(plan, layer.cin, dev, 3).to(BF16)
    buf = torch.empty(x.numel() + 1, dtype=BF16, device=dev)
    off = buf[1:].view(x.shape)
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16
    tf.reset_launch_counts()
    with pytest.raises(ValueError):
        tf.conv_cf(off, kks[0], bms[0], plan, layer)
    g = _cf(plan, layer.cout, dev, 4).to(BF16)
    with pytest.raises(ValueError):
        tf.conv_cf_dw(off, g, plan, layer)
    odd = tf.TailLayer(cin=layer.cin, cout=20, side=layer.side,
                       off=layer.off, gelu_in=False)
    kk = torch.zeros((odd.side, odd.side, odd.cin, 20), dtype=BF16,
                     device=dev)
    with pytest.raises(ValueError):
        tf.conv_cf(x, kk, None, plan, odd)
    assert tf.KERNEL_LAUNCHES["tail_conv_cf_bf16"] == 0
    assert tf.KERNEL_LAUNCHES["tail_conv_dw_cf_bf16"] == 0


@pytest.mark.parametrize("li", [0, 1, 2], ids=["f1", "f2", "head_f4"])
@pytest.mark.parametrize("act_in", [False, True])
def test_tail_conv_dw_cf_bf16(dev, small, li, act_in):
    plan = small[0]
    layer = plan.layers[li]
    x = _cf(plan, layer.cin, dev, 30 + li).to(BF16)
    g = _cf(plan, layer.cout, dev, 40 + li).to(BF16)
    tf.reset_launch_counts()
    dkk, db = tf.conv_cf_dw(x, g, plan, layer, act_in)
    want_kk, want_b = tf.conv_cf_dw_ref(x, g, plan, layer, act_in,
                                        tf._k_blocks(plan, layer))
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["tail_conv_dw_cf_bf16"] == 1
    for got, want in ((dkk, want_kk), (db, want_b)):
        assert got.dtype == torch.float32
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


def _rand_as(dev, shape, seed, offset, dtype):
    """_rand in `dtype`: a contiguous view that starts `offset` elements of
    `dtype` past a 16-byte boundary."""
    n = int(np.prod(shape))
    buf = _rand(dev, (n + offset,), seed).to(dtype)
    return buf[offset:].view(shape)


def _nan_freed(dev, shape, dtype):
    """Fill a block of `shape` with NaN and free it: the next allocation of
    that size gets it back, so an output element a kernel leaves unwritten
    shows. Returns its address."""
    junk = torch.full(shape, float("nan"), device=dev, dtype=dtype)
    ptr = junk.data_ptr()
    del junk
    return ptr


@pytest.mark.parametrize("src", ["fp32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1, 3, 7])
@pytest.mark.parametrize("case", PACK_CASES, ids=case_id)
def test_pack_cf_bf16(dev, case, offset, src):
    """pack_cf to bf16 from fp32 (the entry cast in the same pass) and from
    bf16, the input 0, 1, 3 or 7 elements past a 16-byte boundary, the
    output in a NaN-filled freed block: the plain version's cast, bit for
    bit, the border ring and the pads zero."""
    name, c, nb = case
    plan, _ = layout_plan(name)
    x = _rand_as(dev, (nb, plan.h, plan.w, c), c + nb, offset,
                 torch.float32 if src == "fp32" else BF16)
    ptr = _nan_freed(dev, (nb, tf._r8(c), plan.mp), BF16)
    tf.reset_launch_counts()
    got = tf.pack_cf(x, plan, BF16)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["pack_cf_bf16"] == 1
    assert tf.KERNEL_LAUNCHES["pack_cf"] == 0
    assert got.dtype == BF16 and got.data_ptr() == ptr
    assert torch.equal(got, tf.pack_cf_ref(x, plan, BF16))


@pytest.mark.parametrize("out", ["fp32", "bf16"])
@pytest.mark.parametrize("case", PACK_CASES, ids=case_id)
def test_unpack_cf_bf16(dev, case, out):
    """unpack_cf of a bf16 cotangent to fp32 (pack_cf's input was fp32) and
    to bf16, NaN in the border ring and pads: exact."""
    name, c, nb = case
    plan, _ = layout_plan(name)
    g = _rand(dev, (nb, tf._r8(c), plan.mp), c + nb, 0).to(BF16)
    live = tf.border_mask(plan, device=dev).reshape(-1) > 0
    g[:, :, ~live] = float("nan")
    g[:, c:] = float("nan")
    dt = torch.float32 if out == "fp32" else BF16
    tf.reset_launch_counts()
    got = tf.unpack_cf(g, plan, c, dt)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["unpack_cf_bf16"] == 1
    assert got.dtype == dt and not bool(got.isnan().any())
    assert torch.equal(got, tf.unpack_cf_ref(g, plan, c, dt))


def _nan_pads(g, plan, c):
    """NaN in the border ring, the channel pad and the tail pad of a
    (B, c8, Mp) input: a pad element that reached the output would show."""
    live = tf.border_mask(plan, device=g.device).reshape(-1) > 0
    g[:, :, ~live] = float("nan")
    g[:, c:] = float("nan")
    return g


@pytest.mark.parametrize("out", ["fp32", "bf16"])
@pytest.mark.parametrize("offset", [1, 3, 7])
@pytest.mark.parametrize("case", [*((f"f2_w{w}", c, 2) for w in (13, 131)
                                    for c in (1, 3, 7, 9)),
                                  ("bunny", 53, 2), ("bunny_prefix", 64, 2),
                                  ("pnerv_bunny", 100, 2)], ids=case_id)
def test_unpack_cf_bf16_edges(dev, case, offset, out):
    """The bf16 unpack_cf kernel at c = 1, 3, 7, 9 on images 13 and 131
    wide, and at the Bunny-3M step's two entries and PNeRV's c = 100 entry,
    the input 1, 3 or 7 elements past a 16-byte boundary: its bulk copies
    start on the boundary before it; exact, to fp32 and to bf16."""
    name, c, nb = case
    plan, _ = layout_plan(name)
    g = _nan_pads(_rand_as(dev, (nb, tf._r8(c), plan.mp), c + offset,
                           offset, BF16), plan, c)
    dt = torch.float32 if out == "fp32" else BF16
    tf.reset_launch_counts()
    got = tf.unpack_cf(g, plan, c, dt)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["unpack_cf_bf16"] == 1
    assert got.dtype == dt and not bool(got.isnan().any())
    assert torch.equal(got, tf.unpack_cf_ref(g, plan, c, dt))


@pytest.mark.parametrize("tq", [8, 16, 56, 64, 128, 200, 256])
@pytest.mark.parametrize("name,c", [("f2_w13", 9), ("small", 7),
                                    ("f2_w131", 3), ("tiny", 17),
                                    ("bunny", 53), ("pnerv_bunny", 100)])
def test_unpack_cf_bf16_other_tiles(dev, name, c, tq):
    """The launcher at every tile it takes, whatever the geometry picks:
    tiles wider than the image (they cross many rows and their border
    columns) and narrower; exact, to bf16 and to fp32."""
    plan, _ = layout_plan(name)
    lib = tf._cuda.lib()
    c8 = tf._r8(c)
    g = _nan_pads(_rand_as(dev, (2, c8, plan.mp), tq + c, 0, BF16), plan, c)
    smem = tf._unpack_cf_bf16_smem(tq, plan.w, plan.pad, c)
    for dt in (BF16, torch.float32):
        out = torch.full((2, plan.h, plan.w, c), float("nan"), device=dev,
                         dtype=dt)
        prm, addr = tf._c_ints(2, plan.h, plan.w, c, c8, plan.pad, plan.mp,
                               tq, 1, tf._TYPE_CODES[dt], smem)
        err = lib.nq_unpack_cf(g.data_ptr(), out.data_ptr(), addr,
                               torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0, tf._cuda.error_string(err)
        assert torch.equal(out, tf.unpack_cf_ref(g, plan, c, dt)), dt


@pytest.mark.parametrize("out", ["fp32", "bf16"])
@pytest.mark.parametrize("out_bias", ["sigmoid", "tanh", "0.5"])
@pytest.mark.parametrize("case", UNPACK_CASES, ids=case_id)
def test_unpack_frames_bf16(dev, case, out_bias, out):
    """A bf16 head output to fp32 frames (regress's bf16 precision) and to
    bf16 frames (a bf16 decode), z 0, 1, 3 or 7 elements past a 16-byte
    boundary (by case), the frames in a NaN-filled freed block: out_img
    1e-6 in fp32, one unit in bf16, the offset form exact."""
    name, c, nb = case
    plan, f = layout_plan(name)
    ch = c * f * f
    cp = max(plan.layers[-1].cout, tf._r8(ch))
    offset = (0, 1, 3, 7)[(len(name) + c + nb) % 4]
    z = _rand_as(dev, (nb, cp, plan.mp), f + c, offset, BF16)
    dt = torch.float32 if out == "fp32" else BF16
    ptr = _nan_freed(dev, (nb, plan.h * f, plan.w * f, c), dt)
    tf.reset_launch_counts()
    got = tf.unpack_frames(z, plan, f, ch, out_bias, dt)
    want = tf.unpack_frames_ref(z, plan, f, ch, out_bias, dt)
    torch.cuda.synchronize()
    assert tf.KERNEL_LAUNCHES["unpack_frames_bf16"] == 1
    assert tf.KERNEL_LAUNCHES["unpack_frames"] == 0
    assert got.shape == want.shape == (nb, plan.h * f, plan.w * f, c)
    assert got.data_ptr() == ptr and not bool(got.isnan().any())
    if out_bias == "0.5":
        assert torch.equal(got, want)
    elif dt is BF16:
        _bf16_close(got, want, rel=0.0)
    else:
        assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("offset", [0, 1, 3, 7])
@pytest.mark.parametrize("name,c", [("bunny", 3), ("width_tiled", 3),
                                    ("pnerv_bunny", 3), ("f3_w37", 5)])
def test_unpack_frames_bf16_offsets(dev, name, c, offset):
    """The Bunny-3M decode, the width-tiled plan, PNeRV's head and an edge
    plan with z 0, 1, 3 and 7 elements past a 16-byte boundary, to both
    frame types: the offset form bit for bit."""
    plan, f = layout_plan(name)
    ch = c * f * f
    cp = max(plan.layers[-1].cout, tf._r8(ch))
    z = _rand_as(dev, (2, cp, plan.mp), 40 + offset, offset, BF16)
    for dt in (torch.float32, BF16):
        got = tf.unpack_frames(z, plan, f, ch, "0.25", dt)
        torch.cuda.synchronize()
        assert torch.equal(got, tf.unpack_frames_ref(z, plan, f, ch, "0.25",
                                                     dt)), dt


@pytest.mark.parametrize("case", [("bunny", 53, 1), ("bunny_prefix", 64, 2),
                                  ("pnerv_bunny", 100, 1), ("f2_w13", 5, 2)],
                         ids=case_id)
def test_fp32_layout_kernels_unchanged(dev, case):
    """The fp32 instantiations beside the bf16 ones: pack_cf and
    unpack_frames (offset form) fp32 -> fp32 bit for bit, into NaN-filled
    freed blocks, counted under their own names."""
    name, c, nb = case
    plan, f = layout_plan(name)
    x = _rand(dev, (nb, plan.h, plan.w, c), 9, 1)
    ptr = _nan_freed(dev, (nb, tf._r8(c), plan.mp), torch.float32)
    tf.reset_launch_counts()
    got = tf.pack_cf(x, plan)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert torch.equal(got, tf.pack_cf_ref(x, plan))
    if name.endswith("prefix"):
        assert tf.KERNEL_LAUNCHES["pack_cf"] == 1
        return
    cp, ch = plan.layers[-1].cout, 3 * f * f
    z = _rand(dev, (nb, cp, plan.mp), 10, 2)
    ptr = _nan_freed(dev, (nb, plan.h * f, plan.w * f, 3), torch.float32)
    got = tf.unpack_frames(z, plan, f, ch, "0.25")
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert torch.equal(got, tf.unpack_frames_ref(z, plan, f, ch, "0.25"))
    assert (tf.KERNEL_LAUNCHES["pack_cf"],
            tf.KERNEL_LAUNCHES["unpack_frames"],
            tf.KERNEL_LAUNCHES["pack_cf_bf16"],
            tf.KERNEL_LAUNCHES["unpack_frames_bf16"]) == (1, 1, 0, 0)


def test_bf16_wrappers_refuse_mixed_dtypes(dev, small):
    plan, kks, bms = _small_bf16(small)
    layer = plan.layers[0]
    x = _cf(plan, layer.cin, dev, 0)
    with pytest.raises(TypeError):                  # fp32 x, bf16 kernel
        tf.conv_cf(x, kks[0], bms[0], plan, layer)
    with pytest.raises(TypeError):
        tf.conv_cf_dw(x.to(BF16), _cf(plan, layer.cout, dev, 1), plan, layer)
    with pytest.raises(TypeError):                  # no bf16 -> fp32 pack
        tf.pack_cf(torch.zeros((2, plan.h, plan.w, 5), device=dev,
                               dtype=BF16), plan, torch.float32)


def test_bf16_tail_gradients(dev, small):
    """The tail Function in bf16 on the kernels against the same Function
    on CPU copies (the plain versions): the backward's cotangent and every
    gradient come back bf16 (the weights' dtype), the launches are the bf16
    instantiations', the gradients within 2^-5 of each leaf's largest."""
    plan, kks, bms = _small_bf16(small)
    x0 = _cf(plan, plan.layers[0].cin, dev, 50).to(BF16)
    wt = _cf(plan, plan.layers[-1].cout, dev, 51)
    seen = []

    def grads(device):
        x = x0.detach().to(device).requires_grad_()
        ks = [k.detach().to(device).requires_grad_() for k in kks]
        bs = [b.detach().to(device).requires_grad_() for b in bms]
        out = tf.tail_apply(plan, x, ks, bs)
        assert out.dtype == BF16
        out.register_hook(lambda g: seen.append(g.dtype))
        (out.float() * wt.to(device)).sum().backward()
        return [t.grad for t in (x, *ks, *bs)]

    tf.reset_launch_counts()
    got = grads(dev)
    torch.cuda.synchronize()
    n = len(plan.layers)
    assert tf.KERNEL_LAUNCHES["tail_conv_cf_bf16"] == 2 * n
    assert tf.KERNEL_LAUNCHES["tail_conv_dw_cf_bf16"] == n
    assert tf.KERNEL_LAUNCHES["tail_conv_cf"] == 0
    assert seen == [BF16]
    want = grads("cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == BF16
        top = float(w.float().abs().max())
        assert float((g.float().cpu() - w.float()).abs().max()) <= \
            2.0 ** -5 * top


def test_bf16_precision_decode_and_step(dev):
    """Under the bf16 matmul precision a decode and a stage-1 step of the
    tiny HNeRV launch only the bf16 instantiations on the tail and the
    fused prefix; the frames come back fp32, finite, near the fp32 decode's
    (bf16 operands through five layers: 2e-2 on frames in [0, 1])."""
    from neuroquant_tpu_torch.metrics import loss_fn
    from neuroquant_tpu_torch.models import build_model
    from neuroquant_tpu_torch.ops import precision

    model = build_model("hnerv", TINY_HNERV, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    frames = torch.rand((2, 80, 160, 3), generator=g, device=dev)
    with torch.no_grad():
        ref = model(frames)
        with precision.matmul_precision("bfloat16"):
            tf.reset_launch_counts()
            got = model(frames)
            torch.cuda.synchronize()
            counts = dict(tf.KERNEL_LAUNCHES)
    n_layers = len(model.blocks) - model.pack_start + 1
    assert counts == _counts(tail_conv_cf_bf16=n_layers + 1, pack_cf_bf16=2,
                             unpack_frames_bf16=1)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 2e-2
    with precision.matmul_precision("bfloat16"):
        tf.reset_launch_counts()
        loss = loss_fn(model(frames), frames, "l2")
        loss.backward()
        torch.cuda.synchronize()
        counts = dict(tf.KERNEL_LAUNCHES)
    n = n_layers + 1
    assert counts == _counts(tail_conv_cf_bf16=2 * n, tail_conv_dw_cf_bf16=n,
                             pack_cf_bf16=2, unpack_cf_bf16=2,
                             unpack_frames_bf16=1)
    assert all(p.grad is None or (p.grad.dtype == torch.float32
                                  and bool(torch.isfinite(p.grad).all()))
               for p in model.parameters())
