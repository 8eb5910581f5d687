"""The last two flags of the JAX package in the port: a decoder block's
norm (``dec_norm: batch | instance``, ``models/layers.py`` ``norm_layer``)
and stage 2's tangent through every activation of the table
(``layers.activation_tangent``, ``decode_jvp``), against the JAX package on
the CPU, on the same numpy-seeded inputs and weights (the port's init,
carried into the JAX tree by the state-dict mapping, the norms' scale and
bias drawn away from 1 and 0):
- ``NeRVBlock`` for each norm with a non-GELU activation: forward and
  gradients;
- each activation's tangent rule against ``jax.jvp``, at its kinks too;
- HNeRV, NeRV and PNeRV1 at the tiny fixture sizes with a batch and an
  instance norm: the decode, one stage-1 step's loss and gradients;
- the Hessian-vector product of ``decode_jvp`` (stage 2's) against JAX's
  plain HVP, reverse over forward, for HNeRV and NeRV at relu, sin, swish
  and hardswish and for PNeRV1 at swish, with and without ``remat``;
- the ``.pth`` files: the port's carry the norm, the JAX package's do not.
The JAX package runs its plain execution (``fused_tail: off``; a non-GELU
or normed decoder never reaches its Pallas kernels).

Tolerances (fp32, the two frameworks' sums in other orders): frames 1e-5
absolute; losses 1e-5 relative; Hv and a block's gradients 1e-5 of each
leaf's largest value; a model's gradients 1e-5 of the step's largest, and
1e-4 of each leaf's largest (a batch norm's scale sums ~1e4 products that
cancel, and PNeRV's ConvNeXt gamma, at 1e-6, has gradients 1e-5 of the
step's); tangents 1e-6 of the largest, and exact at the kinks and wherever
JAX's rule is a select."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.models import layers as jlayers
from neuroquant_tpu.quantization import sensitivity as jsens
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.models import layers as tlayers
from neuroquant_tpu_torch.quantization import (
    hessian_vector_product, make_spec)
from neuroquant_tpu_torch.utils import convert

ACTS = ("relu", "leaky", "leaky01", "relu6", "sin", "swish", "softplus",
        "hardswish")
# (arch, dec_norm, dec_acts) of the model cases
MODELS = [("hnerv", "batch", "relu"), ("hnerv", "none", "sin"),
          ("hnerv", "instance", "swish"), ("hnerv", "batch", "hardswish"),
          ("nerv", "instance", "relu"), ("nerv", "batch", "sin"),
          ("nerv", "none", "swish"), ("nerv", "instance", "hardswish"),
          ("pnerv", "batch", "swish"), ("pnerv", "instance", "leaky")]
STEP_MODELS = [m for m in MODELS if m[1] != "none"]
HVP_MODELS = [m for m in MODELS if m != ("pnerv", "instance", "leaky")]


def _ids(case):
    return "-".join(case)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


# --------------------------------------------------------------------------
# weights: the port's, into the JAX tree
# --------------------------------------------------------------------------
def _pairs(arch, tree):
    if arch.startswith("pnerv"):
        return convert._pnerv_pairs(tree)
    out = []
    if arch == "hnerv":
        enc = tree["encoder"]
        out += convert._convnext_pairs(
            sum(1 for k in enc if k.startswith("down_conv_")),
            sum(1 for k in enc if k.startswith("stage_0_block_")))
    return out + convert._decoder_pairs(tree)


def jax_params(arch, jm, x, sd):
    """The JAX tree of `jm` holding the port's state dict `sd` (every leaf
    set from it; no JAX init runs)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    p = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, np.nan, np.float32), shapes)
    tree = p["params"]
    t = {k: v.detach().numpy() for k, v in sd.items()}
    for key, path, kind in _pairs(arch, tree):
        node = tree
        for k in path:
            node = node[k]
        if kind == "conv":
            node["kernel"] = np.transpose(t[f"{key}.weight"], (2, 3, 1, 0))
            if "bias" in node:
                node["bias"] = t[f"{key}.bias"]
        elif kind == "linear":
            node["kernel"] = t[f"{key}.weight"].T
            node["bias"] = t[f"{key}.bias"]
        elif kind == "norm":
            node["scale"], node["bias"] = t[f"{key}.weight"], t[f"{key}.bias"]
        elif kind == "raw":
            for name in node:
                node[name] = t[f"{key}.{name}"]
        else:
            node["gamma"] = t[key]
    leaves = jax.tree_util.tree_leaves(p)
    assert not any(np.isnan(a).any() for a in leaves)
    return jax.tree_util.tree_map(jnp.asarray, p)


def _cfg(arch, norm, act, tiny):
    cfg = dict(tiny[arch], dec_norm=norm, dec_acts=act)
    return dict(cfg, n_frames=8) if arch == "nerv" else cfg


def _port_model(arch, cfg):
    """The port's init from seed 0; the norms' weight and bias drawn away
    from 1 and 0 (numpy, seed 1)."""
    model = build_model(arch, dict(cfg, fused_tail="off"), device="cpu",
                        seed=0)
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if convert.is_block_norm(k):
                v.copy_(torch.from_numpy(
                    (float(k.endswith("weight")) + 0.2 * rng.randn(
                        *v.shape)).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def tiny(tiny_hnerv_cfg, tiny_nerv_cfg, tiny_pnerv_cfg):
    return {"hnerv": dict(tiny_hnerv_cfg), "nerv": dict(tiny_nerv_cfg),
            "pnerv": dict(tiny_pnerv_cfg)}


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(2).rand(2, 80, 160, 3).astype(np.float32)


@pytest.fixture(scope="module")
def models(tiny, frames):
    """Per model case, built on first use: the port's model, the JAX model
    and its tree holding the same weights, and the model's input."""
    cache = {}

    def get(case):
        if case not in cache:
            arch, norm, act = case
            cfg = _cfg(arch, norm, act, tiny)
            tm = _port_model(arch, cfg)
            jm = jax_build_model(arch, dict(cfg, fused_tail="off"))
            x = (np.arange(2, dtype=np.float32) / 8 if arch == "nerv"
                 else frames)
            params = jax_params(arch, jm, jnp.asarray(x), tm.state_dict())
            cache[case] = dict(cfg=cfg, tm=tm, jm=jm, params=params, x=x)
        return cache[case]
    return get


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------
@pytest.mark.parametrize("norm,act", [("batch", "relu"),
                                      ("batch", "hardswish"),
                                      ("instance", "swish"),
                                      ("instance", "leaky01")])
def test_nerv_block(norm, act):
    """conv -> shuffle -> norm -> act: forward, and the gradients of a
    weighted sum of the output w.r.t. the input, the conv's kernel and
    bias and the batch norm's scale and bias."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 7, 4).astype(np.float32)
    gy = rng.randn(2, 10, 14, 6).astype(np.float32)
    jb = jlayers.NeRVBlock(out_channel=6, kernel_size=3, stride=2,
                           norm=norm, act=act)
    tb = tlayers.NeRVBlock(4, 6, 3, 2, norm=norm, act=act)
    sd = tb.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32)
                                     * (0.3 if "conv" in k else 1.0)))
    p = {"conv": {"kernel": jnp.asarray(
        sd["conv.0.weight"].numpy().transpose(2, 3, 1, 0)),
        "bias": jnp.asarray(sd["conv.0.bias"].numpy())}}
    if norm == "batch":
        p["norm_fn"] = {"scale": jnp.asarray(sd["norm.weight"].numpy()),
                        "bias": jnp.asarray(sd["norm.bias"].numpy())}
    else:
        assert not any(k.startswith("norm") for k in sd)

    def jloss(p, x):
        y = jb.apply({"params": p}, x)
        return jnp.sum(y * gy), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tb(xt)
    (y * torch.from_numpy(gy)).sum().backward()
    _close(y.detach().numpy(), jy, 1e-5, "forward")
    _close(xt.grad.numpy(), jgx, 1e-5, "dx")
    grads = dict(tb.named_parameters())
    _close(grads["conv.0.weight"].grad.numpy().transpose(2, 3, 1, 0),
           jgp["conv"]["kernel"], 1e-5, "dW")
    _close(grads["conv.0.bias"].grad.numpy(), jgp["conv"]["bias"], 1e-5,
           "db")
    if norm == "batch":
        _close(grads["norm.weight"].grad.numpy(), jgp["norm_fn"]["scale"],
               1e-5, "dscale")
        _close(grads["norm.bias"].grad.numpy(), jgp["norm_fn"]["bias"],
               1e-5, "dbias")


@pytest.mark.parametrize("act", ACTS + ("gelu",))
def test_block_pickles(act):
    """A block with a batch norm and any activation pickles (a
    data-parallel rank returns its model) and computes as before."""
    import pickle

    blk = tlayers.NeRVBlock(4, 6, 3, 2, norm="batch", act=act)
    blk.conv[0].reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 5, 7, 4).astype(
        np.float32))
    back = pickle.loads(pickle.dumps(blk))
    assert torch.equal(back(x), blk(x))
    z = blk.conv[0](x)
    for a, b in zip(back.after_conv(z, torch.ones_like(z)),
                    blk.after_conv(z, torch.ones_like(z))):
        assert torch.equal(a, b)


def test_norm_layer_names_the_reference_modules():
    """'none' has no parameters, 'batch' is the BatchNorm2d the shortcuts
    use (so norms_over_batch sees it), 'instance' has none; anything else
    raises, as in JAX."""
    assert isinstance(tlayers.norm_layer("none", 4), torch.nn.Identity)
    bn = tlayers.norm_layer("batch", 4)
    assert isinstance(bn, tlayers.BatchNorm2d)
    assert not list(tlayers.norm_layer("instance", 4).parameters())
    assert tlayers.norms_over_batch(tlayers.NeRVBlock(4, 4, 3, 2, "batch"))
    assert not tlayers.norms_over_batch(
        tlayers.NeRVBlock(4, 4, 3, 2, "instance"))
    with pytest.raises(NotImplementedError):
        tlayers.norm_layer("group", 4)


# --------------------------------------------------------------------------
# the tangent rules
# --------------------------------------------------------------------------
KINKS = np.array([0.0, -0.0, 6.0, -3.0, 3.0, 20.0, 21.0, 25.0, 40.0, -25.0,
                  1e-8, -1e-8, 5.999999, 6.000001], np.float32)


@pytest.mark.parametrize("act", ACTS)
def test_tangent_rule_matches_jax_jvp(act):
    """(act(x), act'(x) dx) against ``jax.jvp`` of the JAX table's
    function, on random points and on the kinks (0, -3, 3 and 6) and
    softplus' threshold (20, where torch's F.softplus turns to x): exact
    at the kinks of the select-based rules (relu, leaky, leaky01, relu6,
    hardswish) and past the threshold (x and 1 in both), 1e-6 of the
    largest elsewhere; with a piece size the same values (to the last bit
    of torch's vectorised and scalar loops, 1e-7 of the largest)."""
    rng = np.random.RandomState(4)
    x = np.concatenate([KINKS, rng.randn(500).astype(np.float32) * 4])
    dx = rng.randn(x.size).astype(np.float32)
    jy, jdy = jax.jvp(jlayers.activation(act), (jnp.asarray(x),),
                      (jnp.asarray(dx),))
    rule = tlayers.activation_tangent(act)
    y, dy = rule(torch.from_numpy(x), torch.from_numpy(dx))
    k = KINKS.size
    if act in ("sin", "swish"):         # no kink, no select
        pass
    elif act == "softplus":             # past the threshold: x and 1
        far = KINKS >= 21
        np.testing.assert_array_equal(y.numpy()[:k][far],
                                      np.asarray(jy)[:k][far])
        np.testing.assert_array_equal(dy.numpy()[:k][far], dx[:k][far])
        np.testing.assert_array_equal(np.asarray(jdy)[:k][far], dx[:k][far])
    else:
        np.testing.assert_array_equal(dy.numpy()[:k], np.asarray(jdy)[:k])
        np.testing.assert_array_equal(y.numpy()[:k], np.asarray(jy)[:k])
    _close(y.numpy(), jy, 1e-6, "value")
    _close(dy.numpy(), jdy, 1e-6, "tangent")
    # the value alone, and by pieces (--remat), as the whole
    y0, none = rule(torch.from_numpy(x), None)
    assert none is None
    np.testing.assert_array_equal(
        y0.numpy(), tlayers.activation(act)(torch.from_numpy(x)).numpy())
    yp, dyp = rule(torch.from_numpy(x), torch.from_numpy(dx), 97)
    _close(yp.numpy(), y.numpy(), 1e-7, "value by pieces")
    _close(dyp.numpy(), dy.numpy(), 1e-7, "tangent by pieces")


@pytest.mark.parametrize("act", ["swish", "hardswish", "gelu"])
def test_tangent_by_pieces_backward(act):
    """The rule run piece by piece (a last piece shorter than the rest)
    gives the whole run's gradients w.r.t. x and dx (the HVP's second
    differentiation) to fp32 rounding."""
    gen = torch.Generator().manual_seed(5)
    x, dx, gy, gd = (torch.randn(3, 7, 11, generator=gen) for _ in range(4))
    rule = tlayers.activation_tangent(act)
    got, want = [], []
    for piece, out in ((None, want), (50, got)):
        xr, dxr = x.clone().requires_grad_(True), dx.clone().requires_grad_(
            True)
        torch.autograd.backward(rule(xr, dxr, piece), (gy, gd))
        out += [xr.grad, dxr.grad]
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), 1e-6, act)


# --------------------------------------------------------------------------
# the models: decode, a stage-1 step, the HVP
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", STEP_MODELS, ids=_ids)
def test_decode_and_stage1_step(models, case):
    """The decode of two frames and one stage-1 step's MSE loss and
    gradients of every parameter, the norm's included, against the JAX
    package's."""
    s = models(case)
    arch = case[0]
    frames = np.random.RandomState(2).rand(2, 80, 160, 3).astype(np.float32)
    tgt = jnp.asarray(frames)

    def jloss(p):
        pred = s["jm"].apply(p, jnp.asarray(s["x"]))
        return jnp.mean((pred - tgt) ** 2), pred

    (jl, jpred), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        s["params"])
    tm = s["tm"]
    tm.zero_grad()
    pred = tm(torch.from_numpy(s["x"]))
    loss = ((pred - torch.from_numpy(frames)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = convert.state_dict_from_jax(
        arch, jax.tree_util.tree_map(np.asarray, jg))
    got = {k: v.grad for k, v in tm.named_parameters()}
    assert set(got) == set(want)
    assert any(convert.is_block_norm(k) for k in got) == (case[1] == "batch")
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= max(1e-5 * top, 1e-4 * float(w.abs().max())), (k, err)


def _jax_hvp(s, arch, jspec, vec, frames):
    """JAX's plain HVP of the batch's MSE w.r.t. the spec layers' kernels
    (the JAX package's ``sensitivity_criterion`` loss, one batch), from
    the embedding: no quantized layer is in the encoder."""
    kernels = jsens._kernels_of(s["params"], jspec)
    tgt = jnp.asarray(frames)
    emb = s["jm"].apply(s["params"], jnp.asarray(s["x"]), method="encode")

    def loss(k):
        p = jsens._with_kernels(s["params"], jspec, k)
        return jnp.mean((s["jm"].apply(p, emb, method="decode") - tgt) ** 2)

    def dd(k):
        return jax.jvp(loss, (k,), (vec,))[1]

    return jax.jit(jax.grad(dd))(kernels)


@pytest.mark.parametrize("case", HVP_MODELS, ids=_ids)
def test_hvp_matches_jax(models, case):
    """sum_b H_b v over one batch of two frames from ``decode_jvp`` (the
    plain unpacked chain: each block's norm and activation carry the
    tangent), with and without remat, against JAX's plain HVP; v a numpy
    draw per quantized layer."""
    s = models(case)
    arch = case[0]
    frames = np.random.RandomState(2).rand(2, 80, 160, 3).astype(np.float32)
    jspec = jax_make_spec(arch, s["cfg"])
    tspec = make_spec(arch, s["cfg"])
    rng = np.random.RandomState(6)
    kernels = jsens._kernels_of(s["params"], jspec)
    vnp = {n: (0.1 * rng.randn(*kernels[n].shape)).astype(np.float32)
           for n in jspec.layer_names}
    want = _jax_hvp(s, arch, jspec, {n: jnp.asarray(v)
                                     for n, v in vnp.items()}, frames)
    ft = torch.from_numpy(frames)
    nidx = torch.from_numpy(s["x"]) if arch == "nerv" else None
    vec = [torch.from_numpy(vnp[n]) for n in jspec.layer_names]
    for remat in (False, True):
        got = hessian_vector_product(s["tm"], tspec, vec, ft, nidx,
                                     [[0, 1]], remat=remat)
        for n, g in zip(jspec.layer_names, got):
            _close(g.numpy(), want[n], 1e-5, (n, remat))


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def test_pth_carries_the_norm_in_the_port_only(models, tmp_path):
    """The port's .pth writes and reads a block's batch norm; the JAX
    package's mapping carries none: its .pth of a trained norm loads into
    the port with the norm at its init (the rest exact), and its loader
    reads the port's file with the norm at identity (the deliberate
    divergence of ROADMAP queue C)."""
    from neuroquant_tpu.utils import torch_compat
    from neuroquant_tpu_torch.methods.common import load_pth

    s = models(("hnerv", "batch", "relu"))
    tm, cfg = s["tm"], s["cfg"]
    sd = tm.state_dict()
    norms = [k for k in sd if convert.is_block_norm(k)]
    assert norms == [f"decoder.{i}.norm.{w}" for i in (1, 2, 3)
                     for w in ("weight", "bias")]
    path = str(tmp_path / "port.pth")
    convert.save_pth(path, tm)
    back = build_model("hnerv", cfg, device="cpu", seed=9)
    load_pth(path, back)
    for k, v in back.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # the JAX package's file: no norm key, the norm at the port's init
    jpath = str(tmp_path / "jax.pth")
    torch_compat.save_pth(jpath, "hnerv", s["params"])
    assert not any(convert.is_block_norm(k) for k in torch.load(jpath))
    fresh = build_model("hnerv", cfg, device="cpu", seed=9)
    load_pth(jpath, fresh)
    for k, v in fresh.state_dict().items():
        if convert.is_block_norm(k):
            assert torch.equal(v, torch.full_like(
                v, float(k.endswith("weight")))), k
        else:
            assert torch.equal(v, sd[k]), k
    # the JAX loader on the port's file: everything but the norm
    jp = torch_compat.load_pth(path, "hnerv", s["params"])
    for i in range(3):
        node = jp["params"][f"blocks_{i}"]["norm_fn"]
        np.testing.assert_array_equal(
            np.asarray(node["scale"]),
            np.asarray(s["params"]["params"][f"blocks_{i}"]["norm_fn"][
                "scale"]))
    back_sd = convert.state_dict_from_jax(
        "hnerv", jax.tree_util.tree_map(np.asarray, jp))
    for k, v in back_sd.items():
        assert torch.equal(v, sd[k]), k


def test_state_dict_mapping_carries_pnerv_norms(models):
    """PNeRV's dec_exc/norm_fn and dec_layers_{i}/norm_fn map to
    dec_exc_layers.norm and dec_layers.{i}.norm, and back."""
    s = models(("pnerv", "batch", "swish"))
    sd = convert.state_dict_from_jax(
        "pnerv", jax.tree_util.tree_map(np.asarray, s["params"]))
    keys = [k for k in sd if convert.is_block_norm(k)]
    n = len(s["cfg"]["kfc_strides"])
    assert keys == ["dec_exc_layers.norm.weight", "dec_exc_layers.norm.bias",
                    *(f"dec_layers.{i}.norm.{w}" for i in range(n)
                      for w in ("weight", "bias"))]
    for k, v in s["tm"].state_dict().items():
        assert torch.equal(sd[k], v), k
