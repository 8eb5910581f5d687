"""The backward half of the port's channels-first tail against the JAX
package's: the dx epilogue (GELU'), the dW/db pass dense and union-sparse,
the tail Function's gradients against ``jax.vjp`` of ``tail_apply`` (its
Pallas kernels in interpret mode on the CPU), and the layout kernels'
backwards. Inputs come from numpy seeds; the port runs its plain versions.

Tolerances: fp32 with another summation order, 1e-5 relative to the
largest value compared (gradients summed over every position, 1e-4);
layout backwards are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroquant_tpu.ops import tail_fused as jtf
from neuroquant_tpu_torch.ops import tail_fused as ttf

B = 2
SMALL = dict(h=8, w=12, block_geoms=[(5, 5, 16, 2), (3, 4, 12, 2)],
             head_geom=(3, 3, 3), tm=128)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


def _live(plan, li):
    """1 where layer li's canonical packed kernel can be nonzero: the
    positions the packing gather writes from a weight."""
    k, cin, cout = SMALL["head_geom"]
    kks = ttf.plan_and_pack(
        plan.h, plan.w, [(torch.ones(kb, kb, c, crr), None, r)
                         for kb, c, crr, r in SMALL["block_geoms"]],
        (torch.ones(k, k, cin, cout), None), tm=plan.tm)[1]
    return (kks[li] != 0).numpy()


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    blocks = [((rng.randn(k, k, cin, crr) * 0.3).astype(np.float32),
               (rng.randn(crr) * 0.1).astype(np.float32), r)
              for k, cin, crr, r in SMALL["block_geoms"]]
    k, cin, cout = SMALL["head_geom"]
    head = ((rng.randn(k, k, cin, cout) * 0.3).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32))
    h, w, tm = SMALL["h"], SMALL["w"], SMALL["tm"]
    jp = jtf.plan_and_pack(h, w, [(jnp.asarray(a), jnp.asarray(b), r)
                                  for a, b, r in blocks],
                           (jnp.asarray(head[0]), jnp.asarray(head[1])),
                           tm=tm)
    tp = ttf.plan_and_pack(h, w, [(torch.from_numpy(a), torch.from_numpy(b),
                                   r) for a, b, r in blocks],
                           (torch.from_numpy(head[0]),
                            torch.from_numpy(head[1])), tm=tm)
    plan = tp[0]
    mask = jtf._mask_np(plan.h, plan.w, plan.pad, plan.mp)
    cf = lambda c: (rng.randn(B, c, plan.mp) * mask).astype(np.float32)  # noqa
    return jp, tp, cf


LAYERS = pytest.mark.parametrize("li", [0, 1, 2], ids=["f1", "f2", "head_f4"])


@LAYERS
def test_dx_epilogue_matches_jnp(case, li):
    """conv_cf_ref with out_mul on the transposed layer (the dx pass)
    against the JAX ``_conv_cf_jnp``; the wrapper's union K list too."""
    (jplan, jkks, *_), (tplan, tkks, *_), cf = case
    lt, jlt = tplan.layers[li].transposed(), jplan.layers[li].transposed()
    g, m = cf(lt.cin), cf(lt.cout)
    want = jtf._conv_cf_jnp(jnp.asarray(g), jtf._kk_transpose(jkks[li]),
                            None, jnp.asarray(m), jplan, jlt, jnp.float32)
    kt = ttf._kk_transpose(tkks[li])
    np.testing.assert_array_equal(kt.numpy(),
                                  np.asarray(jtf._kk_transpose(jkks[li])))
    for got in (ttf.conv_cf_ref(torch.from_numpy(g), kt, None, tplan, lt,
                                out_mul=torch.from_numpy(m)),
                ttf.conv_cf(torch.from_numpy(g), kt, None, tplan, lt,
                            out_mul=torch.from_numpy(m))):
        _close(got.numpy(), want, 1e-5)


def test_transposed_layer_matches_jax(case):
    (jplan, *_), (tplan, *_), _ = case
    for jl, tl in zip(jplan.layers, tplan.layers):
        a, b = jl.transposed(), tl.transposed()
        assert (b.cin, b.cout, b.side, b.off, b.gelu_in, b.sparse,
                b.sparse_t) == (a.cin, a.cout, a.side, a.off, a.gelu_in,
                                a.sparse, a.sparse_t)


def test_gelu_grad_matches_jax():
    z = np.linspace(-6, 6, 4001).astype(np.float32)
    _close(ttf._gelu_grad(torch.from_numpy(z)).numpy(),
           jtf._gelu_grad(jnp.asarray(z)), 1e-6)


@LAYERS
@pytest.mark.parametrize("act_in", [False, True])
def test_dw_matches_jax(case, li, act_in):
    """dW/db: the plain version on dense taps against ``_conv_cf_dw_jnp``;
    the wrapper (the union K list for f >= 2, scattered to the canonical
    kernel) against ``_conv_cf_dw``, the Pallas kernel in interpret mode
    (whose mode on these layers is the same union layout)."""
    (jplan, *_), (tplan, *_), cf = case
    layer, jl = tplan.layers[li], jplan.layers[li]
    x, g = cf(layer.cin), cf(layer.cout)
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    want_d = jtf._conv_cf_dw_jnp(jx, jg, jplan, jl, act_in=act_in)
    want_k = jtf._conv_cf_dw(jx, jg, jplan, jl, act_in=act_in)
    got_d = ttf.conv_cf_dw_ref(torch.from_numpy(x), torch.from_numpy(g),
                               tplan, layer, act_in)
    got_k = ttf.conv_cf_dw(torch.from_numpy(x), torch.from_numpy(g), tplan,
                           layer, act_in)
    for got, want in ((got_d, want_d), (got_k, want_k)):
        assert got[0].shape == (layer.side, layer.side, layer.cin,
                                layer.cout)
        _close(got[0].numpy(), want[0], 1e-5)
        _close(got[1].numpy(), want[1], 1e-5)
    if layer.sparse is not None:
        # union and dense agree wherever the packed kernel can be nonzero
        live = _live(tplan, li)
        _close(got_k[0].numpy() * live, got_d[0].numpy() * live, 1e-5)


def test_tail_gradients_match_jax_vjp(case):
    """The tail Function's gradients (x, every canonical kernel and bias)
    against ``jax.vjp`` of the JAX ``tail_apply`` (custom VJP, Pallas dx
    and dW in interpret mode) and of its jnp twin. The custom VJP's dx is
    zero on the border, as its input is, and its dW of a packed layer is
    the union-block gradient; the twin's autodiff gives dx on the border
    and dW at structurally zero kernel positions too, so against the twin
    both are compared where they can be nonzero."""
    (jplan, jkks, jbms, *_), (tplan, tkks, tbms, *_), cf = case
    x = cf(tplan.layers[0].cin)
    gout = np.random.RandomState(9).randn(
        B, tplan.layers[-1].cout, tplan.mp).astype(np.float32)
    outs = []
    for fn in (jtf.tail_apply, jtf.tail_apply_jnp):
        y, vjp = jax.vjp(lambda a, k, b: fn(jplan, a, k, b), jnp.asarray(x),
                         tuple(jkks), tuple(jbms))
        outs.append((y, vjp(jnp.asarray(gout))))
    xt = torch.from_numpy(x).requires_grad_()
    ks = [k.clone().requires_grad_() for k in tkks]
    bs = [b.clone().requires_grad_() for b in tbms]
    y = ttf.tail_apply(tplan, xt, ks, bs)
    assert y.grad_fn is not None
    (y * torch.from_numpy(gout)).sum().backward()
    mask = jtf._mask_np(tplan.h, tplan.w, tplan.pad, tplan.mp)
    for i, (want_y, (dx, dks, dbs)) in enumerate(outs):
        _close(y.detach().numpy(), want_y, 1e-5)
        inside = 1.0 if i == 0 else mask
        _close(xt.grad.numpy() * inside, np.asarray(dx) * inside, 1e-4)
        for li, (a, b) in enumerate(zip(ks, dks)):
            live = 1.0 if i == 0 else _live(tplan, li)
            _close(a.grad.numpy() * live, np.asarray(b) * live, 1e-4)
        for a, b in zip(bs, dbs):
            _close(a.grad.numpy(), b, 1e-4)


def test_pack_cf_backward_is_jax_vjp_exactly(case):
    (_, _, _, _, _), (tplan, *_), _ = case
    x = np.random.RandomState(3).randn(B, tplan.h, tplan.w, 13).astype(
        np.float32)
    g = np.random.RandomState(4).randn(B, 16, tplan.mp).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jtf.pack_cf(a, tplan, jnp.float32),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = ttf.pack_cf(xt, tplan)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ttf.unpack_cf(torch.from_numpy(g), tplan, 13).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("k,r,cin,cout,perm", [
    (5, 2, 5, 16, None), (3, 4, 3, 3, "shuffled")], ids=["f2", "f4_perm"])
def test_pack_conv_kernel_backward_matches_jax_vjp(k, r, cin, cout, perm):
    """The packing gather's backward (a gather over the packed slots that
    read each weight) against the JAX ``pack_conv_kernel`` VJP, its
    gather-based ``linear_call`` transpose."""
    from neuroquant_tpu.ops import packed_decode as jpd
    from neuroquant_tpu_torch.ops import packed_decode as tpd

    rng = np.random.RandomState(k * r)
    if perm is not None:
        perm = rng.permutation(r * r)
    w = rng.randn(k, k, cin, cout).astype(np.float32)
    kk, vjp = jax.vjp(lambda a: jpd.pack_conv_kernel(a, r, in_perm=perm),
                      jnp.asarray(w))
    g = rng.randn(*kk.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_()
    got = tpd.pack_conv_kernel(wt, r, in_perm=perm)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(kk))
    got.backward(torch.from_numpy(g))
    _close(wt.grad.numpy(), want, 1e-6)


def test_unpack_frames_backward_matches_jax():
    plan, f = ttf.plan_geometry(20, 40, [(3, 17, 224, 4)], (3, 14, 3))
    jplan, _ = jtf.plan_geometry(20, 40, [(3, 17, 224, 4)], (3, 14, 3))
    z = np.random.RandomState(5).randn(B, 48, plan.mp).astype(np.float32)
    g = np.random.RandomState(6).randn(B, 80, 160, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jtf.unpack_frames(a, jplan, f, 48, "tanh",
                                                 jnp.float32),
                     jnp.asarray(z))
    (want,) = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_()
    ttf.unpack_frames(zt, plan, f, 48, "tanh").backward(torch.from_numpy(g))
    _close(zt.grad.numpy(), want, 1e-6)


def test_no_graph_without_gradients(case):
    """Decode-time calls build no graph and take the y-emitting path."""
    _, (tplan, tkks, tbms, *_), cf = case
    x = torch.from_numpy(cf(tplan.layers[0].cin))
    y = ttf.tail_apply(tplan, x, tkks, tbms)
    assert y.grad_fn is None
    with torch.no_grad():
        assert ttf.pack_cf(torch.zeros(B, tplan.h, tplan.w, 5,
                                       requires_grad=True),
                           tplan).grad_fn is None


def test_second_derivative_through_the_tail_raises(case):
    """The tail's backward is first-order, as the JAX tail's custom VJP: a
    gradient taken with create_graph=True carries no graph through the
    kernels' backward, so a second derivative through ``tail_apply``
    raises instead of coming out silently wrong."""
    _, (tplan, tkks, tbms, *_), cf = case
    x = torch.from_numpy(cf(tplan.layers[0].cin)).requires_grad_()
    ks = [k.clone().requires_grad_() for k in tkks]
    y = ttf.tail_apply(tplan, x, ks, tbms)
    # a loss whose gradient at the output depends on the inputs, as a
    # Hessian-vector product's does
    first = torch.autograd.grad((y ** 2).sum(), [x, *ks], create_graph=True)
    with pytest.raises(RuntimeError, match="not have been used in the graph"):
        torch.autograd.grad(sum((g * g).sum() for g in first), [x, *ks])
    with pytest.raises(RuntimeError, match="differentiate twice"):
        sum((g * g).sum() for g in first).backward()
