"""Stage 2's sensitivity machinery in the port against the JAX package, on
the 80x160 fixture with the tiny HNeRV: the perturbation, the forward-mode
tail (``tail_apply_fo``), the decode's tangent, the Omega Hessian-vector
product and per-layer scores on both HVP routes, and the diagonal Fisher.
Weights come from the JAX init, frames from the fixture PNGs, batches from
the JAX package's ``jax.random.permutation``; the port runs on the CPU (its
kernels' plain versions), the JAX package as its tests run it on the CPU
(``fused_tail: pallas_hvp`` takes its Pallas kernels in interpret mode; the
fused prefix's grid gate set to 1, as the port fuses at any grid).

Tolerances (fp32, other summation orders): the perturbation 1e-6 of each
layer's largest value; the tail's value exact (the same torch ops), its
tangent 1e-5 of the largest value, its grad-of-jvp 2e-4 of each leaf's
largest (JAX's own ``TestHVPTail`` bound); the decode's tangent, fused
prefix and tail against the plain unpacked path, 1e-4 of the largest;
Hv 1e-4 of each leaf's largest; per-layer omega scores 1e-4 of the layer's
sum of |Hv * v| (the score is a sum of products that cancel); per-layer
Fisher scores (sums of squares) 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.analysis import hessian_eigen as jhe
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.models import layers as jlayers
from neuroquant_tpu.models import quant_layer_paths as jax_paths
from neuroquant_tpu.ops import tail_fused as jtf
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

BITS = (2, 3, 4, 6, 4)
SEED = 903
BATCH = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def setup(tiny_hnerv_cfg, frame_dir):
    cfg = dict(tiny_hnerv_cfg)
    frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
    jm = {ft: jax_build_model("hnerv", dict(cfg, fused_tail=ft))
          for ft in ("off", "pallas_hvp")}
    params = jax.jit(jm["off"].init)(jax.random.PRNGKey(0),
                                     jnp.asarray(frames[:1]))
    sd = state_dict_from_jax("hnerv", _np(params))
    tm = {}
    for ft in ("off", "pallas_hvp", "auto"):
        tm[ft] = build_model("hnerv", dict(cfg, fused_tail=ft), device="cpu")
        tm[ft].load_state_dict(sd, strict=True)
    jspec = jax_make_spec("hnerv", cfg, hadamard=True).with_bits(BITS)
    tspec = make_spec("hnerv", cfg, hadamard=True).with_bits(BITS)
    jstate = jqm.init_quant_state(params, jspec)
    tstate = quant_state_from_numpy(_np(jstate))
    n = frames.shape[0]
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(SEED), n))
    nb = min(jsens.MAX_BATCHES, n // BATCH)
    batches = perm[:nb * BATCH].reshape(nb, BATCH)
    return dict(cfg=cfg, frames=frames, jm=jm, params=params, sd=sd, tm=tm,
                jspec=jspec, tspec=tspec, jstate=jstate, tstate=tstate,
                batches=batches)


@pytest.fixture(scope="module")
def jax_fused_prefix():
    """The JAX package fuses the last prefix block only above a grid size
    (a TPU overhead gate); the port fuses at any size."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlayers, "PREFIX_MIN_GRID", 1)
    yield
    mp.undo()


@pytest.mark.parametrize("hadamard", [True, False])
def test_get_perturbation_matches_jax(setup, hadamard):
    """w - UAQ(w) with the current scales, also where the scales were
    initialized in the Hadamard domain (the reference's quirk)."""
    s = setup
    jspec = jax_make_spec("hnerv", s["cfg"], hadamard=hadamard).with_bits(BITS)
    tspec = make_spec("hnerv", s["cfg"], hadamard=hadamard).with_bits(BITS)
    jstate = jqm.init_quant_state(s["params"], jspec)
    want = jqm.get_perturbation(s["params"], jspec, jstate)
    got = get_perturbation(s["sd"], tspec, quant_state_from_numpy(
        _np(jstate)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.abs(np.asarray(w)).max()) > 0
        _close(g.numpy(), w, 1e-6)


# ---------------------------------------------------------------------------
# The forward-mode tail on a small plan: two packed blocks and a head
# ---------------------------------------------------------------------------
H, W = 8, 12
BLOCKS = [(5, 5, 16, 2), (3, 4, 12, 2)]      # (k, cin, cout*r*r, r)
HEAD = (3, 3, 3)


@pytest.fixture(scope="module")
def small():
    rng = np.random.RandomState(0)
    ws = []
    for k, cin, crr, _ in BLOCKS:
        ws += [(rng.randn(k, k, cin, crr) * 0.3).astype(np.float32),
               (rng.randn(crr) * 0.1).astype(np.float32)]
    k, cin, cout = HEAD
    ws += [(rng.randn(k, k, cin, cout) * 0.3).astype(np.float32),
           (rng.randn(cout) * 0.1).astype(np.float32)]
    x = rng.randn(2, H, W, BLOCKS[0][1]).astype(np.float32)
    dws = [(rng.randn(*a.shape) * 0.01).astype(np.float32) for a in ws]
    dx = (rng.randn(*x.shape) * 0.01).astype(np.float32)
    return x, ws, dx, dws


def _jax_tail(x, *ws):
    blocks = [(ws[2 * i], ws[2 * i + 1], BLOCKS[i][3])
              for i in range(len(BLOCKS))]
    plan, kks, bms, _, _ = jtf.plan_and_pack(H, W, blocks, (ws[-2], ws[-1]),
                                             tm=128)
    return jtf.tail_apply_jnp(plan, jtf.nhwc_to_cf(x, plan), kks, bms)


def _packed(ws):
    blocks = [(ws[2 * i], ws[2 * i + 1], BLOCKS[i][3])
              for i in range(len(BLOCKS))]
    return ttf.plan_and_pack(H, W, blocks, (ws[-2], ws[-1]), tm=128)


def _torch_tail_fo(x, dx, ws, dws):
    plan, kks, bms, _, _ = _packed(ws)
    _, dkks, dbms, _, _ = _packed(dws)
    return ttf.tail_apply_fo(plan, ttf.pack_cf(x, plan),
                             None if dx is None else ttf.pack_cf(dx, plan),
                             kks, dkks, bms, dbms), plan


def test_gelu_tangent_backward_is_autograds():
    """The tail's GELU with its tangent keeps two tensors for the outer
    backward and writes that backward in closed form: the same values as
    the two plain formulas, and within 1e-6 of the largest gradient of
    autograd through them (zero inputs included, where autograd takes
    sign and abs as flat)."""
    rng = np.random.RandomState(5)
    h = torch.from_numpy((rng.randn(4096) * 3).astype(np.float32))
    h[:7] = 0.0
    dh, gy, gd = (torch.from_numpy(rng.randn(4096).astype(np.float32))
                  for _ in range(3))
    outs, grads = [], []
    for fn in (lambda a, b: (ttf._gelu(a), ttf._gelu_grad(a) * b),
               ttf._GeluTangent.apply):
        a, b = h.clone().requires_grad_(), dh.clone().requires_grad_()
        y, d = fn(a, b)
        outs.append((y, d))
        grads.append(torch.autograd.grad((y * gy).sum() + (d * gd).sum(),
                                         [a, b]))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    for got, want in zip(grads[1], grads[0]):
        _close(got.numpy(), want.numpy(), 1e-6)


def test_tail_apply_fo_value_is_tail_apply(small):
    x, ws, dx, dws = small
    t = [torch.from_numpy(a) for a in ws]
    (h, dh), plan = _torch_tail_fo(torch.from_numpy(x), torch.from_numpy(dx),
                                   t, [torch.from_numpy(a) for a in dws])
    _, kks, bms, _, _ = _packed(t)
    want = ttf.tail_apply(plan, ttf.pack_cf(torch.from_numpy(x), plan), kks,
                          bms)
    assert torch.equal(h, want)
    assert dh.shape == h.shape
    # no tangent: the production tail itself, and no tangent back
    h0, dh0 = ttf.tail_apply_fo(plan, ttf.pack_cf(torch.from_numpy(x), plan),
                                None, kks, (None,) * 3, bms)
    assert dh0 is None and torch.equal(h0, want)


def test_tail_apply_fo_tangent_matches_jax_jvp(small):
    """Tangents on the input, every kernel and every bias, against
    ``jax.jvp`` of the JAX tail's jnp twin."""
    x, ws, dx, dws = small
    _, want = jax.jit(lambda p, t: jax.jvp(_jax_tail, p, t))(
        (jnp.asarray(x), *map(jnp.asarray, ws)),
        (jnp.asarray(dx), *map(jnp.asarray, dws)))
    (_, got), _ = _torch_tail_fo(torch.from_numpy(x), torch.from_numpy(dx),
                                 [torch.from_numpy(a) for a in ws],
                                 [torch.from_numpy(a) for a in dws])
    _close(got.numpy(), want, 1e-5)


def test_tail_apply_fo_grad_of_jvp_matches_jax(small):
    """Hv w.r.t. the raw weights: autograd of the port's directional
    derivative (each kernel differentiated once) against JAX's
    jvp-over-grad of the jnp twin."""
    x, ws, _, dws = small
    plan = _packed([torch.from_numpy(a) for a in ws])[0]
    tgt = np.random.RandomState(1).randn(
        2, plan.layers[-1].cout, plan.mp).astype(np.float32)

    def jloss(ws_):
        z = _jax_tail(jnp.asarray(x), *ws_)
        return jnp.mean((z - tgt) ** 2)

    _, want = jax.jit(lambda p, t: jax.jvp(jax.grad(jloss), (p,), (t,)))(
        tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, dws)))
    t = [torch.from_numpy(a).requires_grad_() for a in ws]
    (z, dz), _ = _torch_tail_fo(torch.from_numpy(x), None, t,
                                [torch.from_numpy(a) for a in dws])
    dl = (2.0 * (z - torch.from_numpy(tgt)) * dz).mean()
    got = torch.autograd.grad(dl, t)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 2e-4)


def test_decode_tangent_fused_matches_plain(setup):
    """decode_jvp with the fused prefix and tail (pallas_hvp) against the
    plain unpacked decode's, for tangents on every decoder conv; the value
    of pallas_hvp's decode is decode_jvp's."""
    s = setup
    rng = np.random.RandomState(2)
    emb = s["tm"]["off"].encode(torch.from_numpy(s["frames"][:2]))
    convs = ["decoder.0.weight", "decoder.1.conv.0.weight",
             "decoder.2.conv.0.weight", "decoder.3.conv.0.weight",
             "head_layer.weight"]
    dws = [torch.from_numpy((rng.randn(*s["sd"][k].shape) * 0.01).astype(
        np.float32)) for k in convs]
    fused, plain = s["tm"]["pallas_hvp"], s["tm"]["off"]
    assert fused.pack_start == 2       # blocks[1] fused, blocks[2] the tail
    with torch.no_grad():
        y_f, dy_f = fused.decode_jvp(emb, dws)
        y_p, dy_p = plain.decode_jvp(emb, dws)
        assert torch.equal(fused.decode(emb), y_f)
    _close(y_f.numpy(), y_p.numpy(), 1e-5)
    assert float(dy_p.abs().max()) > 0
    _close(dy_f.numpy(), dy_p.numpy(), 1e-4)


def _jax_hv_sum(s, vec, model):
    """sum over the batches of H_b v on the JAX package's HVP (the
    ``hessian_eigen`` composition) over all the batches' frames at once:
    the mean over n batches of equal size is 1/n of the sum of the batch
    means."""
    matvec_parts = jhe.make_hvp(
        model, s["params"], [tuple(p) for p in jax_paths("hnerv", s["cfg"])],
        jnp.asarray(s["frames"]), None, "hnerv",
        jnp.asarray(s["batches"].reshape(-1)))
    hvp = matvec_parts[3]
    hv = hvp({i: jnp.asarray(v) for i, v in enumerate(vec)})
    return [np.asarray(hv[i]) * len(s["batches"]) for i in range(len(vec))]


@pytest.fixture(scope="module")
def omega_jax(setup, jax_fused_prefix):
    """JAX per-layer omega scores on both executions, and its Hv on the
    plain one, at the same batches."""
    s = setup
    vec = [np.asarray(v) for v in jqm.get_perturbation(
        s["params"], s["jspec"], s["jstate"])]
    per_layer = {}
    for ft in ("off", "pallas_hvp"):
        _, per_layer[ft] = jsens.sensitivity_criterion(
            "omega", "hnerv", s["jm"][ft], s["params"], s["jspec"],
            s["jstate"], jnp.asarray(s["frames"]), None, BATCH, seed=SEED,
            log_fn=lambda m: None)
    hv = _jax_hv_sum(s, vec, s["jm"]["off"])
    mags = [float(np.abs(h * v).sum()) for h, v in zip(hv, vec)]
    return dict(vec=vec, per_layer=per_layer, hv=hv, mags=mags)


@pytest.mark.parametrize("route", ["off", "pallas_hvp"])
def test_omega_matches_jax(setup, omega_jax, route):
    """Hv and the per-layer scores through sensitivity_criterion on the
    JAX batches: the plain unpacked decode (--hvp_impl xla) and the fused
    kernels' forward-mode tail (--hvp_impl pallas), against the JAX
    criterion on the same execution."""
    s, j = setup, omega_jax
    model = s["tm"][route]
    vec = [torch.from_numpy(v.copy()) for v in j["vec"]]
    hv = hessian_vector_product(model, s["tspec"], vec,
                                torch.from_numpy(s["frames"]), None,
                                s["batches"])
    for got, want in zip(hv, j["hv"]):
        _close(got.numpy(), want, 1e-4)
    lines = []
    total, per_layer = sensitivity_criterion(
        "omega", "hnerv", model, s["sd"], s["tspec"], s["tstate"],
        torch.from_numpy(s["frames"]), None, BATCH, log_fn=lines.append,
        batches=s["batches"])
    want = j["per_layer"][route]
    for got, w, mag in zip(per_layer, want, j["mags"]):
        assert abs(got - w) <= 1e-4 * mag, (got, w, mag)
    assert total == pytest.approx(float(np.sum(per_layer)))
    assert lines == [f"[{i:d}-th layer] {v:.3e}"
                     for i, v in enumerate(per_layer)]


def test_remat_gives_the_same_hv(setup):
    s = setup
    vec = get_perturbation(s["sd"], s["tspec"], s["tstate"])
    frames = torch.from_numpy(s["frames"])
    a = hessian_vector_product(s["tm"]["pallas_hvp"], s["tspec"], vec,
                               frames, None, s["batches"][:1])
    b = hessian_vector_product(s["tm"]["pallas_hvp"], s["tspec"], vec,
                               frames, None, s["batches"][:1], remat=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def fisher_jax(setup):
    s = setup
    return jsens.sensitivity_criterion(
        "fisher_diag", "hnerv", s["jm"]["off"], s["params"], s["jspec"],
        s["jstate"], jnp.asarray(s["frames"]), None, BATCH, seed=SEED,
        log_fn=lambda m: None)[1]


@pytest.mark.parametrize("route", ["off", "auto"])
def test_fisher_diag_matches_jax(setup, fisher_jax, route):
    """The plain gradient on the plain unpacked decode and on the
    production fused tail (the tail's autograd Function), against the JAX
    criterion on its plain execution."""
    s, want = setup, fisher_jax
    _, got = sensitivity_criterion(
        "fisher_diag", "hnerv", s["tm"][route], s["sd"], s["tspec"],
        s["tstate"], torch.from_numpy(s["frames"]), None, BATCH,
        log_fn=lambda m: None, batches=s["batches"])
    for g, w in zip(got, want):
        assert w > 0 and g == pytest.approx(w, rel=1e-5)


def test_batches_come_from_the_seed(setup):
    """Without `batches` the criterion draws its own from `seed`: the same
    seed, the same score; at most MAX_BATCHES batches."""
    from neuroquant_tpu_torch.quantization.sensitivity import draw_batches

    s = setup
    b = draw_batches(8, 2, SEED)
    assert b.shape == (4, 2) and sorted(b.reshape(-1).tolist()) == list(
        range(8))
    assert torch.equal(b, draw_batches(8, 2, SEED))
    assert draw_batches(100, 3, 0).shape == (10, 3)
    args = ("fisher_diag", "hnerv", s["tm"]["off"], s["sd"], s["tspec"],
            s["tstate"], torch.from_numpy(s["frames"]), None, BATCH)
    assert (sensitivity_criterion(*args, log_fn=lambda m: None)
            == sensitivity_criterion(*args, log_fn=lambda m: None,
                                     batches=draw_batches(8, 2, SEED)))

