"""The backward of the port's grouped fake-quant (ops/fused_fakequant.py):
the closed-form VJP that the backward kernel computes
(``fake_quant_vjp_ref``) against the JAX package's VJP of its Pallas
fake-quant functions (forward in interpret mode, as the JAX tests run it)
and against autograd through the port's plain chain; the grouped Function
against per-layer calls; a numpy emulation of the kernels' block -> row
map over the descriptor the launch passes; and first-order backwards (a
second derivative raises). Weights, scales and cotangents come from numpy
seeds; on the CPU the port runs its plain versions.

Tolerances, each with its reason:
- dw and dalpha against JAX: 1e-5 of each leaf's largest value (the same
  fp32 products; the JAX transform's transpose may take its stages in
  another order);
- the reduced ddelta and dzp against JAX: 1e-5 of each channel's sum of
  the magnitudes of the terms summed (an fp32 sum in another order moves by
  a few 2^-24 of that; the two halves of each, dequantization against
  clip, cancel to ~1e-4 of the largest value, so the largest value is no
  scale for them);
- against autograd through the plain chain: equal, every leaf (the same
  products in the same order, summed as autograd sums them)."""

import ctypes
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.ops import pallas_fakequant as jpf
from neuroquant_tpu_torch.config import get_config, validate_config
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.ops import fused_fakequant as tff
from neuroquant_tpu_torch.ops import quant as TQ
from neuroquant_tpu_torch.ops import tail_fused as ttf
from neuroquant_tpu_torch.ops.hadamard import fwht, pad_cin_to_pow2
from neuroquant_tpu_torch.quantization import qmodel as tqm
from neuroquant_tpu_torch.quantization.qmodel import _get
from neuroquant_tpu_torch.quantization.spec import make_spec

BITS = 4
MODES = {"uaq": (False, True), "soft": (True, True), "hard": (True, False)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(khw, cin, cout, hadamard, channel_wise, seed):
    """An OIHW weight seen as HWIO, max-init scales in the quantization
    domain, alphas moved off their init (so both clip bounds of h occur),
    and a cotangent."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((rng.randn(cout, cin, *khw) * 0.2).astype(
        np.float32)).permute(2, 3, 1, 0)
    dom = fwht(pad_cin_to_pow2(w), axis=2) if hadamard else w
    d, z = TQ.init_weight_scale(dom, BITS, channel_wise, "max")
    a = TQ.adaround_init_alpha(dom, d) + torch.from_numpy(
        (rng.randn(*dom.shape) * 0.3).astype(np.float32))
    g = torch.from_numpy(rng.randn(*w.shape).astype(np.float32))
    return w, d, z, a, g


CASES = [(mode, hadamard, cw, khw, cin, cout)
         for mode in MODES for hadamard in (True, False)
         for cw, khw, cin, cout in ((True, (3, 3), 5, 6),
                                    (False, (1, 1), 53, 7))]


def _ids(c):
    mode, hadamard, cw, khw, cin, cout = c
    return (f"{mode}-{'had' if hadamard else 'plain'}-"
            f"{'cw' if cw else 'layer'}-{khw[0]}x{khw[1]}x{cin}x{cout}")


def _magnitudes(g, w, d, z, a, hadamard, soft):
    """Per scale entry, the sum of the magnitudes of ddelta's and dzp's
    terms: what an fp32 sum of them in another order can move by."""
    return tff.fake_quant_vjp_ref(
        g, w, d, z, a, BITS, hadamard, soft,
        sum_like=lambda t, like: tff._sum_like(t.abs(), like))[1:3]


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_vjp_ref_matches_jax_vjp(case):
    mode, hadamard, cw, khw, cin, cout = case
    ada, soft = MODES[mode]
    w, d, z, a, g = _case(khw, cin, cout, hadamard, cw, 3 + cin)
    alpha = a if ada else None
    if ada:
        def fn(w_, d_, z_, a_):
            return jpf.pallas_ada_fake_quant(w_, d_, z_, a_, BITS, hadamard,
                                             soft)
        args = (w, d, z, a)
    else:
        def fn(w_, d_, z_):
            return jpf.pallas_uaq_fake_quant(w_, d_, z_, BITS, hadamard)
        args = (w, d, z)
    # jitted, as the JAX calibration runs it: the eager JAX FWHT divides
    # by sqrt(n) where the jitted one multiplies by its reciprocal
    want = jax.jit(lambda g_, *xs: jax.vjp(fn, *xs)[1](g_))(
        jnp.asarray(g.numpy()), *(jnp.asarray(t.contiguous().numpy())
                                  for t in args))
    got = tff.fake_quant_vjp_ref(g, w, d, z, alpha, BITS, hadamard, soft)
    scales = _magnitudes(g, w, d, z, alpha, hadamard, soft)
    for i, name in enumerate(("dw", "ddelta", "dzp", "dalpha")[:len(args)]):
        wv = np.asarray(want[i])
        gv = (np.zeros_like(wv) if got[i] is None else got[i].numpy())
        assert gv.shape == wv.shape, name
        if name in ("ddelta", "dzp"):
            tol = 1e-5 * scales[i - 1].numpy()
        else:
            tol = 1e-5 * max(float(np.abs(wv).max()), 1e-30)
        assert np.all(np.abs(gv - wv) <= tol), (name, np.abs(gv - wv).max())
    if mode == "soft":
        assert float(got[3].abs().max()) > 0
    if ada:
        assert not bool(got[0].any())      # the floor passes nothing to w


@pytest.mark.parametrize("case", CASES + [
    ("uaq", True, True, (5, 5), 53, 4), ("soft", True, False, (5, 5), 37, 3),
    ("hard", True, True, (1, 1), 16, 9)],
    ids=[_ids(c) for c in CASES] + ["uaq-had-cw-5x5x53x4",
                                    "soft-had-layer-5x5x37x3",
                                    "hard-had-cw-1x1x16x9"])
def test_vjp_ref_is_autograd_of_the_plain_chain(case):
    mode, hadamard, cw, khw, cin, cout = case
    ada, soft = MODES[mode]
    w, d, z, a, g = _case(khw, cin, cout, hadamard, cw, 7 + cout)
    leaves = [t.clone().requires_grad_() for t in (w, d, z, a)]
    out = tff.fake_quant_ref(*leaves[:3], leaves[3] if ada else None, BITS,
                             hadamard, soft)
    want = torch.autograd.grad(out, leaves, g, allow_unused=True)
    got = tff.fake_quant_vjp_ref(g, w, d, z, a if ada else None, BITS,
                                 hadamard, soft)
    for name, x, y in zip(("dw", "ddelta", "dzp", "dalpha"), got, want):
        if y is None or (name == "dalpha" and not soft):
            assert x is None, name          # hard rounding passes nothing
            continue
        assert torch.equal(x, y), name


def test_needs_select_the_leaves():
    w, d, z, a, g = _case((3, 3), 13, 4, True, True, 1)
    got = tff.fake_quant_vjp_ref(g, w, d, z, a, BITS, True, True,
                                 needs=(False, False, True, True))
    assert got[0] is None and got[1] is None
    assert got[2].shape == z.shape and got[3].shape == a.shape


def _group_layers(hadamard):
    """A mixed-rounding group: UAQ (channel-wise and per-layer scales),
    soft and hard AdaRound, at 3x3, 1x1 and 5x5."""
    out = []
    for seed, (khw, cin, cout, cw, mode) in enumerate((
            ((3, 3), 5, 6, True, "uaq"), ((1, 1), 53, 7, True, "soft"),
            ((5, 5), 13, 3, False, "uaq"), ((3, 3), 37, 4, True, "hard"),
            ((5, 5), 9, 5, False, "soft"))):
        w, d, z, a, g = _case(khw, cin, cout, hadamard, cw, 20 + seed)
        ada, soft = MODES[mode]
        out.append(((w, d, z, a if ada else None, BITS, soft), g))
    return out


@pytest.mark.parametrize("hadamard", [True, False])
def test_group_matches_per_layer_calls(hadamard):
    """One grouped call over a mixed-rounding group gives each layer's
    plain chain and, backward, each layer's closed-form VJP; on the CPU it
    launches nothing."""
    layers = _group_layers(hadamard)
    leaves = []
    for (w, d, z, a, bits, soft), _ in layers:
        leaves.append([t.clone().requires_grad_() if t is not None else None
                       for t in (w, d, z, a)])
    ttf.reset_launch_counts()
    outs = tff.fake_quant_group(
        [(*lv, BITS, lay[0][5]) for lv, lay in zip(leaves, layers)],
        hadamard)
    sum((o * g).sum() for o, (_, g) in zip(outs, layers)).backward()
    assert not any(ttf.KERNEL_LAUNCHES.values())
    for out, lv, ((w, d, z, a, bits, soft), g) in zip(outs, leaves, layers):
        assert torch.equal(out.detach(),
                           tff.fake_quant_ref(w, d, z, a, bits, hadamard,
                                              soft))
        want = tff.fake_quant_vjp_ref(g, w, d, z, a, bits, hadamard, soft)
        for t, wv in zip(lv, want):
            if t is None:
                continue
            if wv is None:                 # alpha under hard rounding
                assert t.grad is None
            else:
                assert torch.equal(t.grad, wv)


def test_quantize_params_makes_one_group_call(tiny_hnerv_cfg, monkeypatch):
    """quantize_params(fq_impl='pallas') hands every layer to one grouped
    call, in a mixed-rounding state too (a layer without alphas rounds to
    nearest), with the 'jnp' implementation's weights and gradients."""
    cfg = dict(tiny_hnerv_cfg)
    model = build_model("hnerv", cfg, device="cpu")
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    spec = make_spec("hnerv", cfg, hadamard=True).with_bits((6, 5, 4, 5, 6))
    state = tqm.init_quant_state(params, spec)
    only = tuple(spec.layer_names[1::2])
    state = tqm.adaround_upgrade(params, spec, state, only=only)
    calls = []
    group = tff.fake_quant_group

    def counting(layers, hadamard):
        calls.append([lay[3] is not None for lay in layers])
        return group(layers, hadamard)

    monkeypatch.setattr(tqm, "fake_quant_group", counting)
    got = {}
    for impl in ("pallas", "jnp"):
        st = {ln: {k: v.clone().requires_grad_(k == "w_alpha")
                   for k, v in s.items()} for ln, s in state.items()}
        qp = tqm.quantize_params(params, dataclasses.replace(
            spec, fq_impl=impl), st, mode="adaround")
        sum((qp[k] ** 2).sum() for k in qp if k.endswith("weight")).backward()
        got[impl] = (qp, {ln: st[ln]["w_alpha"].grad for ln in only})
    assert calls == [[ln in only for ln in spec.layer_names]]
    for k in got["jnp"][0]:
        assert torch.equal(got["pallas"][0][k].detach(),
                           got["jnp"][0][k].detach()), k
    for ln in only:
        assert torch.equal(got["pallas"][1][ln], got["jnp"][1][ln]), ln


@pytest.mark.parametrize("fn", ["uaq", "ada"])
def test_second_derivative_raises(fn):
    """The group's backward is first-order, as the JAX custom VJP: a
    second derivative through it raises instead of coming out wrong."""
    w, d, z, a, g = _case((3, 3), 5, 4, True, True, 2)
    d = d.clone().requires_grad_()
    a = a.clone().requires_grad_()
    if fn == "uaq":
        out = tff.uaq_fake_quant(w, d, z, BITS, True)
        leaf = d
    else:
        out = tff.ada_fake_quant(w, d, z, a, BITS, True, True)
        leaf = a
    # a loss whose gradient at the output depends on the leaf, as a
    # Hessian-vector product's does
    (first,) = torch.autograd.grad((out ** 2 * g).sum(), leaf,
                                   create_graph=True)
    # the first derivative's graph ends at the backward, which was marked
    # first-order: asked for the leaf, autograd finds no path to it; run
    # to its end, the backward refuses
    with pytest.raises(RuntimeError, match="not have been used in the graph"):
        torch.autograd.grad(first.sum(), leaf)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        first.sum().backward()


# --------------------------------------------------------------------------
# The launch map: a numpy emulation of the kernels' block -> row -> element
# map, read from the descriptor the launch passes
# --------------------------------------------------------------------------
def _emulate(grp, shapes, backward):
    """Every row (o, k) and element (o, k, c < C) of every layer of the
    Group `grp` is covered by exactly one live lane of one tile, each tile
    by one layer (the kernel's prefix scan); the staged and summed indices
    stay inside what the launcher gives a block (a persistent block takes
    tiles in turn, so its tile map is this one)."""
    n, total = grp.n, grp.blocks
    block0 = np.array([grp.layer[i].block0 for i in range(n)])
    blocks = np.arange(total)
    layer_of = np.zeros(total, int)
    for i in range(1, n):
        layer_of[blocks >= block0[i]] = i      # the kernel's linear scan
    most_smem = 0
    for i, (kh, kw, cin, cout) in enumerate(shapes):
        lay = grp.layer[i]
        kk, lanes, v, cpb = lay.kk, lay.lanes, lay.v, lay.cpb
        assert (lay.cout, kk, lay.cin) == (cout, kh * kw, cin)
        c = lanes * v
        b = blocks[layer_of == i] - lay.block0
        assert len(b) == -(-cout // cpb)
        o0 = b * cpb
        nch = np.minimum(cpb, cout - o0)
        assert nch.min() >= 1
        rpw = 32 // lanes
        rpi = tff.FQ_WARPS * rpw
        iters = -(-cpb * kk // rpi)
        it, warp, lane = np.meshgrid(np.arange(iters),
                                     np.arange(tff.FQ_WARPS),
                                     np.arange(32), indexing="ij")
        lr = (it * rpi + warp * rpw + lane // lanes).ravel()
        gl = (lane % lanes).ravel()
        live = lr[None, :] < (nch * kk)[:, None]          # (blocks, lanes)
        assert np.broadcast_to(lr, live.shape)[live].max() < (
            tff.MAX_BLOCK_ROWS)                  # the sums' slots
        o = o0[:, None] + lr[None, :] // kk
        k = np.broadcast_to(lr % kk, o.shape)
        rows = np.zeros((cout, kk), int)
        np.add.at(rows, (o[live & (gl == 0)], k[live & (gl == 0)]), 1)
        assert (rows == 1).all()
        elems = np.zeros((cout, kk, c), int)
        for j in range(v):
            cc = np.broadcast_to(j * lanes + gl, o.shape)
            np.add.at(elems, (o[live], k[live], cc[live]), 1)
        assert (elems == 1).all()
        if lay.staged:
            ol = np.broadcast_to(lr // kk, o.shape)
            for width in (cin, lay.cq):
                for j in range(v):
                    cc = np.broadcast_to(j * lanes + gl, o.shape)
                    ok = live & (cc < width)
                    idx = ((ol * width + cc) * kk + k)[ok]
                    assert idx.size == 0 or idx.max() < cpb * width * kk, (
                        i, j, width)
        ada = lay.mode != tff.MODE_UAQ
        tile = lay.staged * cpb * kk * ((1 + backward) * cin + ada * lay.cq)
        assert tile <= tff.STAGE_FLOATS
        most_smem = max(most_smem, tile)
    # two tile buffers and, backward, the rows' sums: no opt-in needed
    assert 4 * (2 * most_smem + backward * 4 * tff.MAX_BLOCK_ROWS) <= 48 * 1024
    return total


def _bunny_shapes():
    cfg = validate_config(get_config(os.path.join(
        REPO, "configs", "HNeRV", "Bunny_1280x640_3M.yaml")), "hnerv")
    model = build_model("hnerv", cfg, device="cpu")
    params = model.state_dict()
    spec = make_spec("hnerv", cfg, hadamard=True)
    return [tuple(_get(params, pre)[0].shape) for pre in spec.layer_keys]


BUNNY = [(1, 1, 16, 92), (1, 1, 92, 1925), (3, 3, 77, 1024),
         (5, 5, 64, 848), (5, 5, 53, 176), (5, 5, 44, 148), (3, 3, 37, 3)]


def test_bunny_shapes_are_the_models():
    assert _bunny_shapes() == BUNNY


def _fixture_shapes(cfg):
    model = build_model("hnerv", cfg, device="cpu")
    params = model.state_dict()
    spec = make_spec("hnerv", cfg, hadamard=True)
    return [tuple(_get(params, pre)[0].shape) for pre in spec.layer_keys]


@pytest.mark.parametrize("which", ["bunny", "fixture", "edges"])
@pytest.mark.parametrize("hadamard", [True, False])
@pytest.mark.parametrize("kind", ["uaq", "mixed", "backward"])
def test_block_map_covers_every_row_once(which, hadamard, kind,
                                         tiny_hnerv_cfg):
    if which == "bunny":
        shapes = BUNNY
    elif which == "fixture":
        shapes = _fixture_shapes(dict(tiny_hnerv_cfg))
    else:   # one-channel layers, C_in past a lane group, wide and tall ones
        shapes = [(1, 1, 1, 9), (1, 3, 1000, 3), (3, 3, 300, 5),
                  (7, 7, 33, 2), (2, 2, 31, 17), (16, 16, 4, 2)]
    keys = []
    for i, (kh, kw, cin, cout) in enumerate(shapes):
        w = torch.zeros((cout, cin, kh, kw)).permute(2, 3, 1, 0)
        s = torch.ones((1, 1, 1, cout))
        mode = "uaq" if kind == "uaq" or i % 2 else "soft"
        alpha = None
        if mode != "uaq":
            c = tff.fq_geometry(cout, kh * kw, cin, hadamard, True).cq
            alpha = torch.zeros((kh, kw, c, cout))
        p = tff._prepare(w, s, s, alpha, BITS, hadamard, True)
        keys.append((p.key, (p.key[7], 7) if kind == "backward" else None))
    grp = tff._descriptor(tuple(keys), kind == "backward")
    assert ctypes.sizeof(grp) <= 4096      # a kernel parameter's limit
    assert _emulate(grp, shapes, kind == "backward") == grp.blocks


def test_geometry_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="at most 1024"):
        tff.fq_geometry(4, 1, 1025, True, False)
    with pytest.raises(ValueError, match="at most 256"):
        tff.fq_geometry(4, 17 * 17, 8, True, False)
    w = torch.zeros((3, 3, 8, 4))
    s = torch.ones((1, 1, 1, 4))
    with pytest.raises(ValueError, match="alpha"):
        tff._prepare(w, s, s, torch.zeros((3, 3, 5, 4)), BITS, True, True)
    with pytest.raises(ValueError, match="delta"):
        tff._prepare(w, torch.ones(3), s, None, BITS, True, True)


@pytest.mark.parametrize("where", ["second weight", "first delta"])
def test_group_on_several_devices_raises(where):
    """A group whose tensors do not all lie on the first weight's device
    raises before it picks the kernels or the plain chain (meta stands in
    for the card, which this test need not have)."""
    w, s = torch.zeros((3, 3, 8, 4)), torch.ones((1, 1, 1, 4))
    other = torch.zeros((3, 3, 8, 4), device="meta")
    if where == "second weight":
        layers = [(w, s, s, None, BITS, True), (other, s, s, None, BITS,
                                                 True)]
    else:
        layers = [(w, s.to("meta"), s, None, BITS, True)]
    with pytest.raises(ValueError, match="several devices"):
        tff.fake_quant_group(layers, True)
    with pytest.raises(ValueError, match="several devices"):
        tff._backward(layers, True, [w] * len(layers),
                      [(True, True, True, False)] * len(layers))


# --------------------------------------------------------------------------
# The launch path on the CPU: the kernels' arithmetic stands in for them,
# reading the Group each launch passes from the pointers in it
# --------------------------------------------------------------------------
def _at(ptr, view, shape):
    """(o, k, c) float32 tensor over the memory at ptr, with view's
    strides."""
    cout, kk, c = shape
    n = (cout - 1) * view.so + (kk - 1) * view.sk + (c - 1) * view.sc + 1
    buf = (ctypes.c_float * n).from_address(ptr)
    return torch.as_strided(torch.from_numpy(np.frombuffer(
        buf, np.float32, n)), (cout, kk, c), (view.so, view.sk, view.sc))


def _inputs(lay):
    """A Group layer's (w, delta, zp, alpha) as (kk, 1, c, cout) HWIO
    tensors, its scales per channel (the kernels' sums are per channel)."""
    def hwio(t):
        return t.permute(1, 2, 0).unsqueeze(1).clone()

    def scale(ptr):
        n = lay.cout if lay.dstride else 1
        t = torch.from_numpy(np.frombuffer(
            (ctypes.c_float * n).from_address(ptr), np.float32, n)).clone()
        return t.expand(lay.cout).reshape(1, 1, 1, lay.cout).clone()

    alpha = (None if lay.mode == tff.MODE_UAQ else hwio(
        _at(lay.alpha, lay.av, (lay.cout, lay.kk, lay.cq))))
    return (hwio(_at(lay.w, lay.wv, (lay.cout, lay.kk, lay.cin))),
            scale(lay.delta), scale(lay.zp), alpha,
            int(lay.levels).bit_length() - 1, lay.mode != tff.MODE_ADA_HARD,
            bool(lay.hadamard))


class _Kernels:
    """The library's fake-quant entries, computed by the plain versions."""

    def nq_fq_group_bytes(self):
        return ctypes.sizeof(tff._Group)

    def nq_fq_group_forward(self, addr, stream):
        grp = tff._Group.from_address(addr)
        for lay in grp.layer[:grp.n]:
            w, d, z, a, bits, soft, had = _inputs(lay)
            out = tff.fake_quant_ref(w, d, z, a, bits, had, soft)
            oihw = tff._View(lay.cin * lay.kk, 1, lay.kk)
            _at(lay.out, oihw, (lay.cout, lay.kk, lay.cin)).copy_(
                out[:, 0].permute(2, 0, 1))
        return 0

    def nq_fq_group_backward(self, addr, stream):
        grp = tff._Group.from_address(addr)
        for lay in grp.layer[:grp.n]:
            w, d, z, a, bits, soft, had = _inputs(lay)
            g = _at(lay.g, lay.gv, (lay.cout, lay.kk, lay.cin))
            need = [bool(lay.need & f) for f in (
                tff.NEED_W, tff.NEED_DELTA, tff.NEED_ZP, tff.NEED_ALPHA)]
            dw, dd, dz, da = tff.fake_quant_vjp_ref(
                g.permute(1, 2, 0).unsqueeze(1), w, d, z, a, bits, had,
                soft, need)
            oihw = tff._View(lay.cin * lay.kk, 1, lay.kk)
            sums = (ctypes.c_float * lay.cout)
            for flag, ptr, val in ((tff.NEED_DELTA, lay.ddelta, dd),
                                   (tff.NEED_ZP, lay.dzp, dz)):
                if lay.need & flag:
                    torch.from_numpy(np.frombuffer(
                        sums.from_address(ptr), np.float32)).copy_(
                        val.reshape(-1))
            if need[0]:
                _at(lay.dw, oihw, (lay.cout, lay.kk, lay.cin)).copy_(
                    dw[:, 0].permute(2, 0, 1))
            if need[3]:
                _at(lay.dalpha, lay.av, (lay.cout, lay.kk, lay.cq)).copy_(
                    da[:, 0].permute(2, 0, 1))
        return 0


@pytest.mark.parametrize("hadamard", [True, False])
def test_launch_path_with_the_kernels_arithmetic(hadamard, monkeypatch):
    """The card's launch path run on the CPU, with the plain versions in
    place of the kernels behind the Group each launch passes: a group of 18
    layers (two launches of 16 and 2), mixed rounding and per-layer scales,
    results as views of one allocation, gradients in alpha's layout, and
    the same values from a repeated call (its plan reused)."""
    monkeypatch.setattr(tff, "_lib", lambda: _Kernels())
    monkeypatch.setattr(tff, "_route", lambda x, name: True)
    counts = {}

    def launch(name, fn, *args):
        assert fn(*args, None) == 0
        counts[name] = counts.get(name, 0) + 1

    monkeypatch.setattr(tff, "_launch", launch)
    monkeypatch.setattr(tff, "_PLANS", {})
    layers = _group_layers(hadamard) * 3 + _group_layers(hadamard)[:3]
    leaves = [[None if t is None else t.clone().requires_grad_()
               for t in lay[:4]] for lay, _ in layers]
    for rep in range(2):
        for t in (t for lv in leaves for t in lv if t is not None):
            t.grad = None
        outs = tff.fake_quant_group(
            [(*lv, *lay[4:]) for lv, (lay, _) in zip(leaves, layers)],
            hadamard)
        sum((o * g).sum() for o, (_, g) in zip(outs, layers)).backward()
        assert counts == {"fq_ada": 2 * (rep + 1), "fq_ada_bwd": 2 * (rep + 1)}
        assert len({o.untyped_storage().data_ptr() for o in outs}) == 1
        for out, lv, ((w, d, z, a, bits, soft), g) in zip(outs, leaves,
                                                         layers):
            assert torch.equal(out.detach(), tff.fake_quant_ref(
                w, d, z, a, bits, hadamard, soft))
            want = tff.fake_quant_vjp_ref(g, w, d, z, a, bits, hadamard, soft)
            mags = _magnitudes(g, w, d, z, a, hadamard, soft)
            for i, (t, wv) in enumerate(zip(lv, want)):
                if t is None:
                    continue
                if wv is None:
                    assert t.grad is None
                elif i in (1, 2):      # channel sums, then summed per layer
                    assert bool(((t.grad - wv).abs()
                                 <= 1e-5 * mags[i - 1]).all())
                else:
                    assert torch.equal(t.grad, wv)
                    if i == 3:
                        assert t.grad.stride() == a.stride()
    assert len(tff._PLANS) == 2      # one forward and one backward plan


def test_pnerv1_group_takes_two_launches(tiny_pnerv_cfg, monkeypatch):
    """PNeRV1 at five strides has 19 quantized layers, more than one
    launch takes (MAX_LAYERS 16): quantize_params on fq_impl 'pallas'
    through the card's launch path, the kernels' arithmetic standing in,
    builds two descriptors of 16 and 3 layers forward and backward, and
    gives the 'jnp' implementation's weights and AdaRound gradients."""
    monkeypatch.setattr(tff, "_lib", lambda: _Kernels())
    monkeypatch.setattr(tff, "_route", lambda x, name: True)
    monkeypatch.setattr(tff, "_PLANS", {})
    sizes = []

    def launch(name, fn, *args):
        sizes.append((name, tff._Group.from_address(args[0]).n))
        assert fn(*args, None) == 0

    monkeypatch.setattr(tff, "_launch", launch)
    cfg = dict(tiny_pnerv_cfg, kfc_h_w_c=[1, 2, 6], emd_channel=4,
               enc_strides=[5, 4, 4], kfc_strides=[2, 2, 2, 2, 5])
    model = build_model("pnerv", cfg, device="cpu")
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    spec = make_spec("pnerv", cfg, hadamard=True)
    assert spec.num_layers == 19 > tff.MAX_LAYERS == 16
    state = tqm.adaround_upgrade(params, spec, tqm.init_quant_state(
        params, spec))
    got = {}
    for impl in ("pallas", "jnp"):
        st = {ln: {k: v.clone().requires_grad_(k == "w_alpha")
                   for k, v in s.items()} for ln, s in state.items()}
        qp = tqm.quantize_params(params, dataclasses.replace(
            spec, fq_impl=impl), st, mode="adaround")
        sum((qp[k] ** 2).sum() for k in qp if k.endswith("weight")).backward()
        got[impl] = (qp, {ln: st[ln]["w_alpha"].grad
                          for ln in spec.layer_names})
    assert sizes == [("fq_ada", 16), ("fq_ada", 3), ("fq_ada_bwd", 16),
                     ("fq_ada_bwd", 3)]
    for k in got["jnp"][0]:
        assert torch.equal(got["pallas"][0][k].detach(),
                           got["jnp"][0][k].detach()), k
    for ln in spec.layer_names:
        assert torch.equal(got["pallas"][1][ln], got["jnp"][1][ln]), ln
