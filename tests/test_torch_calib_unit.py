"""Unit-scope calibration in the port (``quantization/calib_unit.py``)
against the JAX package's, on the 80x160 fixture with the tiny HNeRV and
NeRV: the decode's embeds, the units' IO harvest (shared, one unit, the
bf16 stream cache), the fisher gradient cache, the quantized prefix
(``quantize_params(upto=)``), short reconstruction trajectories on the JAX
package's own minibatch indices and QDrop draws, the stream cache against
the shared one, and ``fq_impl='pallas'`` against ``'jnp'`` in the unit
loop. Weights come from the JAX init, embeddings from its encoder; the port
runs on the CPU (the kernel path's decode on the kernels' plain versions,
the fused fake-quant module on its plain version).

Tolerances: embeds and harvests 1e-5 of each tensor's largest value (fp32
convs in another order); the bf16 cache within one bf16 unit (2^-7 of the
value) beyond that; the fisher gradients, before the cache's |g| + 1, 1e-4
of the largest (the gradient is 2 (pred - fp) / N carried back through the
suffix: fp and pred part from the JAX package's by fp32's rounding, ~1e-7
of a frame, where pred - fp at these bits is 1e-3 to 1e-2, and the fixture
reads up to 2.6e-5), the batched gradient against the per-sample loop
1e-5; the quantized prefix 1e-6 (the
weights |w| < 1); trajectories: losses rtol 1e-4, alphas 2 * lr * steps
(Adam's step is about +-lr whatever the gradient's size, as
``test_torch_calibrate.py``'s trajectory argues), the other leaves 1e-6."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.quantization import calib_unit as jcu
from neuroquant_tpu.quantization import qmodel as jqm
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu_torch.metrics import lp_loss
from neuroquant_tpu_torch.models import build_model
from neuroquant_tpu_torch.quantization import calib_unit as tcu
from neuroquant_tpu_torch.quantization import qmodel as tqm
from neuroquant_tpu_torch.quantization.spec import make_spec
from neuroquant_tpu_torch.utils.convert import (
    quant_state_from_numpy, state_dict_from_jax)

BITS = (3, 4, 3, 4, 3)
SEED = 903
ARCHS = ("hnerv", "nerv")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def setup(tiny_hnerv_cfg, tiny_nerv_cfg, frame_dir):
    """Per arch: the JAX model and init, the port's model on the same
    weights, the JAX encoder's embeddings of the 8 frames, both specs
    (Hadamard, channel-wise) and the JAX init state."""
    out = {}
    for arch, cfg in (("hnerv", dict(tiny_hnerv_cfg)),
                      ("nerv", dict(tiny_nerv_cfg, n_frames=8))):
        frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
        x = (frames if arch == "hnerv"
             else np.arange(8, dtype=np.float32) / 8)
        jm = jax_build_model(arch, cfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
        emb = np.asarray(jm.apply(params, jnp.asarray(x), method="encode"))
        tm = build_model(arch, cfg, device="cpu")
        tm.load_state_dict(state_dict_from_jax(arch, _np(params)),
                           strict=True)
        tm.eval()
        sd = {k: v.detach().clone() for k, v in tm.state_dict().items()}
        jspec = jax_make_spec(arch, cfg, hadamard=True).with_bits(BITS)
        tspec = make_spec(arch, cfg, hadamard=True).with_bits(BITS)
        jstate = jqm.init_quant_state(params, jspec)
        out[arch] = dict(cfg=cfg, jm=jm, params=params, emb=emb, tm=tm,
                         sd=sd, jspec=jspec, tspec=tspec, jstate=jstate,
                         tstate=quant_state_from_numpy(_np(jstate)))
    return out


@pytest.fixture(scope="module")
def jax_io(setup):
    """Each arch's JAX shared harvest."""
    return {a: _np(jcu.harvest_unit_io(s["jm"], s["params"], a, s["jspec"],
                                       jnp.asarray(s["emb"])))
            for a, s in setup.items()}


def test_lp_loss_sums_the_last_axis_of_a_4d_tensor():
    """lp_loss's NHWC contract: a 4-D tensor's channels are its last axis
    (the unit caches are NHWC); any other rank sums axis 1."""
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.randn(2, 3, 4, 5).astype(np.float32))
            for _ in range(2))
    want = ((a - b) ** 2).sum(dim=-1).mean()
    assert torch.equal(lp_loss(a, b), want)
    # an NCHW view of the same values gives another value: the scale
    # against the rounding regularizer would change
    got = lp_loss(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))
    assert not torch.allclose(got, want)
    assert float(lp_loss(a, b, p=1.0)) == pytest.approx(
        float((a - b).abs().sum(-1).mean()), rel=1e-6)
    a2, b2 = a.reshape(2, 60), b.reshape(2, 60)
    assert torch.equal(lp_loss(a2, b2), ((a2 - b2) ** 2).sum(1).mean())
    assert float(lp_loss(a, b, reduction="all")) == pytest.approx(
        float(((a - b) ** 2).mean()), rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_return_embeds_matches_jax(setup, arch):
    """decode(return_embeds=True): the frames and every embed, from the
    plain unpacked chain; NeRV's embeds[1] after its fc shuffle."""
    s = setup[arch]
    img, embeds = s["jm"].apply(s["params"], jnp.asarray(s["emb"]),
                                method="decode", return_embeds=True)
    with torch.no_grad():
        got_img, got = s["tm"].decode(torch.from_numpy(s["emb"]),
                                      return_embeds=True)
    assert len(got) == len(embeds) == len(s["cfg"]["dec_strides"]) + 2
    _close(got_img.numpy(), img, 1e-5)
    for g, w in zip(got, embeds):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.numpy(), w, 1e-5)
    # the kernel path decodes the same frames
    with torch.no_grad():
        _close(s["tm"].decode(torch.from_numpy(s["emb"])).numpy(), img,
               1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_harvest_shared_and_one_unit_match_jax(setup, jax_io, arch):
    s = setup[arch]
    emb = torch.from_numpy(s["emb"])
    io = tcu.harvest_unit_io(s["tm"], s["sd"], arch, s["tspec"], emb)
    assert sorted(io) == list(range(len(BITS)))
    for u, (xi, yo) in jax_io[arch].items():
        _close(io[u][0].numpy(), xi, 1e-5)
        _close(io[u][1].numpy(), yo, 1e-5)
        only = tcu.harvest_unit_io(s["tm"], s["sd"], arch, s["tspec"], emb,
                                   only=u, batch_size=3)
        assert list(only) == [u]
        _close(only[u][0].numpy(), xi, 1e-5)
        _close(only[u][1].numpy(), yo, 1e-5)


def _within_one_bf16_unit(got, want):
    """One bf16 unit of the value (2^-7 of it at most), on top of the fp32
    harvests' own 1e-5 of the largest value: near zero the two fp32 values
    part by more than a bf16 unit of themselves."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = np.abs(want) * 2.0 ** -7 + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_bf16_cache_is_the_shared_one_in_bf16(setup, jax_io, arch):
    """The stream cache (one unit, bf16): within one bf16 unit of JAX's
    bf16 stream cache, and equal to the port's fp32 harvest cast to
    bf16."""
    s = setup[arch]
    emb = torch.from_numpy(s["emb"])
    shared = tcu.harvest_unit_io(s["tm"], s["sd"], arch, s["tspec"], emb)
    for u in range(len(BITS)):
        got = tcu.harvest_unit_io(s["tm"], s["sd"], arch, s["tspec"], emb,
                                  only=u, cache_dtype=torch.bfloat16)[u]
        want = jcu.harvest_unit_io(s["jm"], s["params"], arch, s["jspec"],
                                   jnp.asarray(s["emb"]), only=u,
                                   cache_dtype=jnp.bfloat16)[u]
        for g, w, f in zip(got, want, shared[u]):
            assert g.dtype == torch.bfloat16
            _within_one_bf16_unit(g.float().numpy(),
                                  np.asarray(w.astype(jnp.float32)))
            assert torch.equal(g, f.to(torch.bfloat16))


def _jax_raw_grads(s, unit, include_act, check):
    """The JAX package's per-sample gradient before its |g| + 1 (the cache
    stores |g| + 1 in fp32, where a gradient below 2^-24 vanishes): its
    ``harvest_unit_grads`` body, vmapped over the samples; with `check`
    held to that function."""
    jm, spec = s["jm"], s["jspec"]
    n_blocks = len(s["cfg"]["dec_strides"])
    fc = (jm.cfg.fc_h, jm.cfg.fc_w)

    def one(params, state, x):
        qparams = jqm.quantize_params(params, spec, state, mode="uaq",
                                      upto=unit)
        x = x[None]
        fp = jm.apply(params, x, method="decode")
        _, embeds = jm.apply(qparams, x, method="decode", return_embeds=True)
        if unit == 0 or not include_act:
            if unit == 0:
                xin = embeds[0]
            elif unit == 1:
                dec0 = jqm._get(qparams, spec.layer_paths[0])
                xin = jcu.pixel_shuffle(jcu._apply_unit(
                    embeds[0], dec0["kernel"], dec0["bias"], 1,
                    dec0["kernel"].shape[0], None), fc)
            else:
                xin = embeds[unit]
            layer = jqm._get(qparams, spec.layer_paths[unit])
            y_q = jcu._apply_unit(xin, layer["kernel"], layer["bias"], 1,
                                  layer["kernel"].shape[0], None)
            from_conv = unit != 0 and unit <= n_blocks
        else:
            y_q = (embeds[1 + unit] if unit <= n_blocks
                   else jcu._head_conv(embeds[1 + n_blocks],
                                       jqm._get(qparams,
                                                spec.layer_paths[-1])))
            from_conv = False

        def loss(yy):
            pred = jcu._decode_from(jm, params, spec, yy, unit,
                                    from_conv_out=from_conv)
            return jnp.mean((fp - pred) ** 2)

        return jax.grad(loss)(y_q)[0]

    raw = np.asarray(jax.jit(jax.vmap(one, in_axes=(None, None, 0)))(
        s["params"], s["jstate"], jnp.asarray(s["emb"])))
    if not check:
        return raw
    want = np.asarray(jcu.harvest_unit_grads(
        jm, s["params"], spec, s["jstate"], unit, jnp.asarray(s["emb"]),
        include_act=include_act))
    np.testing.assert_allclose(np.abs(raw) + 1.0, want, rtol=0, atol=0)
    return raw


@pytest.mark.parametrize("arch,include_act", [("hnerv", True),
                                              ("hnerv", False),
                                              ("nerv", True),
                                              ("nerv", False)])
def test_unit_grads_match_jax(setup, arch, include_act):
    """The fisher cache's gradient dMSE(fp, pred)/d(unit output) of every
    unit, under the UAQ-quantized prefix, block and layer scope: before
    the cache's |g| + 1, and the cache itself."""
    s = setup[arch]
    emb = torch.from_numpy(s["emb"])
    for u in range(len(BITS)):
        want = _jax_raw_grads(s, u, include_act, check=u == 2)
        got = torch.cat(list(tcu._unit_grads(
            s["tm"], s["sd"], s["tspec"], s["tstate"], u, emb,
            include_act, tcu.HARVEST_BATCH))).numpy()
        assert float(np.abs(want).max()) > 0, u
        _close(got, want, 1e-4)
        cache = tcu.harvest_unit_grads(s["tm"], s["sd"], s["tspec"],
                                       s["tstate"], u, emb,
                                       include_act=include_act)
        assert torch.equal(cache, torch.from_numpy(np.abs(got) + 1.0))


@pytest.mark.parametrize("include_act", [True, False])
def test_batched_grads_equal_the_per_sample_loop(setup, include_act):
    """One backward of the batch's summed per-sample means gives each
    sample's gradient: the same as one sample at a time."""
    s = setup["hnerv"]
    emb = torch.from_numpy(s["emb"])
    for u in (1, 3, 4):
        one, batched = (torch.cat(list(tcu._unit_grads(
            s["tm"], s["sd"], s["tspec"], s["tstate"], u, emb, include_act,
            bs))) for bs in (1, 8))
        _close(batched.numpy(), one.numpy(), 1e-5)


@pytest.mark.parametrize("fq_impl", ["jnp", "pallas"])
def test_quantize_params_upto_matches_jax(setup, fq_impl):
    """quantize_params(upto=u): layers 0..u fake-quantized, the rest the FP
    weights, against the jitted JAX plain chain (the JAX Pallas kernel in
    interpret mode flips a few rounding decisions, queue C of the
    roadmap); both fq_impls give the same bits."""
    s = setup["hnerv"]
    spec = dataclasses.replace(s["tspec"], fq_impl=fq_impl)
    for u in range(len(BITS)):
        want = state_dict_from_jax("hnerv", _np(jax.jit(
            lambda st: jqm.quantize_params(s["params"], s["jspec"], st,
                                           mode="uaq", upto=u))(
            s["jstate"])))
        with torch.no_grad():
            got = tqm.quantize_params(s["sd"], spec, s["tstate"], mode="uaq",
                                      upto=u)
            plain = tqm.quantize_params(s["sd"], s["tspec"], s["tstate"],
                                        mode="uaq", upto=u)
        for i, pre in enumerate(spec.layer_keys):
            for leaf in ("weight", "bias"):
                k = f"{pre}.{leaf}"
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           atol=1e-6, rtol=0, err_msg=k)
                assert torch.equal(got[k], plain[k]), k
                if i > u:
                    assert torch.equal(got[k], s["sd"][k]), k


def _jax_draws(seed, iters, batch_size, n_cached):
    """The JAX loop's minibatch indices per chunk and its QDrop key."""
    rng = jax.random.PRNGKey(seed)
    rng, drop_rng = jax.random.split(rng)
    chunks, done = [], 0
    while done < iters:
        todo = min(tcu.CHUNK, iters - done)
        rng, r = jax.random.split(rng)
        chunks.append(np.asarray(jax.random.randint(
            r, (todo, batch_size), 0, n_cached)))
        done += todo
    return chunks, drop_rng


def _jax_run(monkeypatch, fn, *args, **kw):
    """fn(*args, **kw) with the JAX unit loop's per-step losses recorded
    (its jitted chunk returns them; the loop logs only the last)."""
    losses, jit = [], jax.jit

    def recording_jit(f, *a, **k):
        jf = jit(f, *a, **k)
        if getattr(f, "__name__", "") != "run_chunk":
            return jf

        def run(*xs):
            out = jf(*xs)
            losses.extend(np.asarray(out[3]).tolist())
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    try:
        return fn(*args, **kw), losses
    finally:
        monkeypatch.setattr(jax, "jit", jit)


TRAJ = [("block", "mse", 1.0), ("block", "fisher_diag", 1.0),
        ("block", "fisher_full", 1.0), ("block", "mse", 0.5),
        ("layer", "mse", 1.0), ("layer", "fisher_diag", 1.0),
        ("layer", "fisher_full", 1.0), ("layer", "fisher_diag", 0.5)]


@pytest.mark.parametrize("scope,opt_mode,input_prob", TRAJ)
def test_trajectory_on_jax_draws(setup, jax_io, monkeypatch, scope,
                                 opt_mode, input_prob):
    """Four steps of one unit's reconstruction (a NeRVBlock with its
    shuffle and GELU, the regularizer on from step 2) in both packages,
    the port fed the JAX minibatch indices and QDrop draws: every step's
    loss, the final alphas and the frozen scales."""
    s = setup["hnerv"]
    unit, iters, lr = 2, 4, 0.003
    kw = dict(batch_size=2, iters=iters, lr=lr, warmup=0.25, seed=SEED,
              opt_mode=opt_mode, input_prob=input_prob,
              include_act=(scope == "block"), log_fn=lambda m: None)
    want, jlosses = _jax_run(
        monkeypatch, jcu.unit_reconstruction, s["jm"], s["params"],
        s["jspec"], s["jstate"], unit, jnp.asarray(s["emb"]),
        io={unit: tuple(map(jnp.asarray, jax_io["hnerv"][unit]))}, **kw)
    assert len(jlosses) == iters
    chunks, drop_rng = _jax_draws(SEED, iters, 2, 8)

    def draws(count, shape):
        return torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.fold_in(drop_rng, count), shape)))

    losses = []
    loss = tcu.UnitProblem.loss

    def recording(self, *a, **k):
        out = loss(self, *a, **k)
        losses.append(float(out[0].detach()))
        return out

    monkeypatch.setattr(tcu.UnitProblem, "loss", recording)
    io = tcu.harvest_unit_io(s["tm"], s["sd"], "hnerv", s["tspec"],
                             torch.from_numpy(s["emb"]), only=unit)
    got = tcu.unit_reconstruction(
        s["tm"], s["sd"], s["tspec"], s["tstate"], unit,
        torch.from_numpy(s["emb"]), io=io,
        minibatch_indices=lambda c, *_: chunks[c], qdrop_masks=draws, **kw)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)
    name = s["tspec"].layer_names[unit]
    assert set(got[name]) == set(want[name])
    for k, v in want[name].items():
        np.testing.assert_allclose(
            got[name][k].numpy(), np.asarray(v), rtol=0,
            atol=2 * lr * iters if k.endswith("alpha") else 1e-6,
            err_msg=f"{name}/{k}")
    for other in s["tspec"].layer_names:
        if other != name:
            assert got[other] is s["tstate"][other]


def test_log_lines_and_chunks(setup):
    """One loss line per chunk of CHUNK steps, the stream cache's harvest
    time, the unit's cache size, and the draws from the seed: the same
    seed, the same state."""
    s = setup["hnerv"]
    kw = dict(batch_size=2, iters=tcu.CHUNK + 3, lr=0.003, seed=SEED,
              cache_dtype=torch.bfloat16)
    emb = torch.from_numpy(s["emb"])
    lines = []
    a = tcu.block_reconstruction(s["tm"], s["sd"], s["tspec"], s["tstate"],
                                 0, emb, log_fn=lines.append, **kw)
    name = s["tspec"].layer_names[0]
    assert re.fullmatch(r"Cached init time: [0-9.e-]+", lines[0])
    assert lines[1].startswith(f"[unit 0 {name}] cache ")
    assert [m.split(" loss ")[0] for m in lines[2:]] == [
        f"[unit 0 {name}] iter {tcu.CHUNK}/{tcu.CHUNK + 3}",
        f"[unit 0 {name}] iter {tcu.CHUNK + 3}/{tcu.CHUNK + 3}"]
    b = tcu.block_reconstruction(s["tm"], s["sd"], s["tspec"], s["tstate"],
                                 0, emb, log_fn=lambda m: None, **kw)
    for k in a[name]:
        assert torch.equal(a[name][k], b[name][k]), k
    assert all(bool(torch.isfinite(v).all()) for v in a[name].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_stream_cache_agrees_with_shared(setup, arch):
    """120 steps on the bf16 stream cache against the fp32 shared cache:
    at least 90% of the unit's hard rounding decisions agree (the JAX
    package's own bound)."""
    s = setup[arch]
    emb = torch.from_numpy(s["emb"])
    kw = dict(iters=120, batch_size=2, lr=0.01, log_fn=lambda m: None)
    io = tcu.harvest_unit_io(s["tm"], s["sd"], arch, s["tspec"], emb)
    shared = tcu.block_reconstruction(s["tm"], s["sd"], s["tspec"],
                                      s["tstate"], 1, emb, io=io, **kw)
    stream = tcu.block_reconstruction(s["tm"], s["sd"], s["tspec"],
                                      s["tstate"], 1, emb,
                                      cache_dtype=torch.bfloat16, **kw)
    name = s["tspec"].layer_names[1]
    a = shared[name]["w_alpha"] >= 0
    b = stream[name]["w_alpha"] >= 0
    assert bool(torch.isfinite(stream[name]["w_alpha"]).all())
    assert float((a == b).float().mean()) > 0.9


@pytest.mark.parametrize("scope,opt_mode,input_prob",
                         [("block", "mse", 1.0),
                          ("layer", "fisher_diag", 0.5)])
def test_fq_impl_pallas_matches_jnp_in_the_unit_loop(setup, scope, opt_mode,
                                                     input_prob):
    """The unit loop with its weight on the grouped fake-quant module (its
    plain version here, the kernels on the card) against the plain chain:
    the same trajectory."""
    s = setup["hnerv"]
    emb = torch.from_numpy(s["emb"])
    kw = dict(iters=30, batch_size=2, lr=0.003, warmup=0.2,
              opt_mode=opt_mode, input_prob=input_prob,
              include_act=(scope == "block"), log_fn=lambda m: None)
    out = {}
    for fq_impl in ("jnp", "pallas"):
        spec = dataclasses.replace(s["tspec"], fq_impl=fq_impl)
        out[fq_impl] = tcu.unit_reconstruction(
            s["tm"], s["sd"], spec, s["tstate"], 3, emb, **kw)
    name = s["tspec"].layer_names[3]
    for k, v in out["jnp"][name].items():
        np.testing.assert_allclose(out["pallas"][name][k].numpy(),
                                   v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
