"""Reduced precision in the port against the JAX package, on the 80x160
fixture: a calibration step with ``compute_dtype`` bf16 (HNeRV phases 1 and
2, NeRV and PNeRV1 phase 2), ``decode_cf`` in bf16 with every tail
intermediate bf16, and the port's bf16 matmul precision
(``ops/precision.py``): its definition and one stage-1 step. The port runs
on the CPU (its kernels' plain versions, which round where the bf16
kernels do); the JAX package runs its jnp tail twin, as its own CPU
calibration does, with the same casts.

Tolerances, with their argument:
  * calibration step: loss 1e-3 relative, every trainable leaf's gradient
    within 2^-5 of the leaf's largest (``chip_smoke.BF16_TOL``). Both sides
    cast the quantized tree and the inputs to bf16 and sum in fp32, one
    bf16 rounding per layer output; they part where fp32 sums in another
    order flip a rounding (a unit, 2^-8 relative), and where JAX rounds
    twice (its unfused prefix conv and its bias add in bf16, its bf16
    out_img) and the port once. JAX's bf16 gradient of a bias sums the
    cotangent over every position in bf16 (the port in fp32), and a leaf
    whose gradient cancels to ~1e-10 (PNeRV1's first gate) keeps few
    correct bits in either: where JAX's bf16 gradient is itself further
    than 2^-5 from its fp32 one, the port is held to twice that distance.
    Measured on the CPU: loss 4.0e-5 relative at most; gradients 2.95e-2
    of the largest at most on the leaves held to 2^-5 (NeRV's blocks_1
    b_alpha), and on the others (HNeRV's blocks_1 b_alpha, PNeRV1's
    fusion-stage biases and bsm_z_0 w_alpha) at most 1.13 times JAX's own
    distance from fp32 (0.40 against 0.41 at the largest), while the
    port's bf16 gradients stay within 7.4e-2 of its fp32 ones.
  * decode_cf in bf16: 2^-6 absolute on [0, 1] values (four bf16 units at
    1.0; measured 3.9e-3). The tail Function's dtypes exactly: bf16
    output, cotangent and gradients, fp32 dW sums.
  * the precision's definition: the tail and the fused prefix under it
    equal the same functions on explicitly bf16-cast inputs and weights
    bit for bit (the same operations); the cuDNN-side conv, linear and
    KFc products equal conv(bf16(x), bf16(w)).float() + bias bit for bit.
  * a stage-1 step under it against the JAX package's, which computes
    fp32 on the CPU (it ignores the precision there): the loss within
    1e-2 relative (bf16 operands, 2^-9 relative each, through the
    encoder's and decoder's ~12 products; measured 2.4e-5); every
    gradient within 1e-2 of the model's largest gradient (the head bias's,
    which sets the step's scale; measured 1.5e-4), the gradient as a
    whole at a cosine of at least 0.999 to JAX's (measured 0.999997). Per
    leaf no bound holds: at the JAX init the decode is nearly constant,
    the encoder's gradients are 1e-14 to 1e-6 of sums that cancel, and
    bf16 operands move them by 10% to 100% of their own size.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_threads import single_torch_thread  # noqa: F401
from neuroquant_tpu.data import VideoDataSet as JaxVideoDataSet
from neuroquant_tpu.metrics import loss_fn as jax_loss_fn
from neuroquant_tpu.models import build_model as jax_build_model
from neuroquant_tpu.models import tail_plan_for as jax_tail_plan_for
from neuroquant_tpu.ops import tail_fused as jtf
from neuroquant_tpu.quantization import calibrate as jcal
from neuroquant_tpu.quantization import qmodel as jqm
from neuroquant_tpu.quantization.spec import make_spec as jax_make_spec
from neuroquant_tpu_torch.metrics import loss_fn
from neuroquant_tpu_torch.models import build_model, tail_plan_for
from neuroquant_tpu_torch.models.layers import (
    Conv2d, KFcBias, collect_tail_params)
from neuroquant_tpu_torch.ops import precision
from neuroquant_tpu_torch.ops import tail_fused as ttf
from neuroquant_tpu_torch.quantization import calibrate as tcal
from neuroquant_tpu_torch.quantization.spec import make_spec
from neuroquant_tpu_torch.utils.convert import (
    quant_state_from_numpy, state_dict_from_jax)

BF16 = torch.bfloat16
PRECISION = (6, 5, 4, 5, 6)
KEYS = {1: ("w_delta", "b_delta"), 2: ("w_alpha", "b_alpha")}
MODE = {1: "uaq", 2: "adaround"}
STEP_LOSS_TOL = 1e-3
STEP_GRAD_TOL = 2.0 ** -5
DECODE_TOL = 2.0 ** -6
S1_LOSS_TOL = 1e-2
S1_GRAD_TOL = 1e-2
S1_COSINE = 0.999


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


_CASES = {}


@pytest.fixture(scope="module")
def cases(tiny_hnerv_cfg, tiny_nerv_cfg, tiny_pnerv_cfg, frame_dir):
    """case(arch): the JAX init on a seed, the port's model on its weights,
    the model inputs (NeRV: the frame indices) and their embeddings, the
    specs and both packages' packed targets; built once per arch."""
    cfgs = {"hnerv": tiny_hnerv_cfg, "nerv": dict(tiny_nerv_cfg, n_frames=8),
            "pnerv": tiny_pnerv_cfg}

    def case(arch):
        if arch in _CASES:
            return _CASES[arch]
        cfg = dict(cfgs[arch])
        frames = np.array(JaxVideoDataSet(cfg, frame_dir).frames)
        inputs = (np.arange(len(frames), dtype=np.float32) / len(frames)
                  if arch == "nerv" else frames)
        jm = jax_build_model(arch, cfg)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(inputs[:2]))
        emb = np.asarray(jm.apply(params, jnp.asarray(inputs),
                                  method="encode"))
        tm = build_model(arch, cfg, device="cpu")
        tm.load_state_dict(state_dict_from_jax(arch, _np(params)),
                           strict=True)
        sd = {k: v.detach().clone() for k, v in tm.state_dict().items()}
        n = len(make_spec(arch, cfg).layer_names)
        bits = [PRECISION[i % len(PRECISION)] for i in range(n)]
        jplan, f, ch = jax_tail_plan_for(arch, cfg)
        tplan, _, _ = tail_plan_for(arch, cfg)
        _CASES[arch] = dict(
            cfg=cfg, frames=frames, inputs=inputs, jm=jm, params=params,
            emb=emb, tm=tm, sd=sd,
            jspec=jax_make_spec(arch, cfg, hadamard=True).with_bits(bits),
            tspec=make_spec(arch, cfg, hadamard=True).with_bits(bits),
            jpack={"gt": jtf.pack_targets(jnp.asarray(frames), jplan, f),
                   "mask": jtf.border_mask(jplan, ch=ch),
                   "denom": cfg["crop_h"] * cfg["crop_w"]},
            tpack={"gt": ttf.pack_targets(torch.from_numpy(frames), tplan,
                                          f),
                   "mask": ttf.border_mask(tplan, ch=ch),
                   "denom": cfg["crop_h"] * cfg["crop_w"]})
        return _CASES[arch]

    yield case
    _CASES.clear()


def _jax_step(s, state, phase, batch, dtype=jnp.bfloat16):
    """The JAX calibration loss with compute_dtype `dtype` (None: fp32), as
    ``_run_phase``'s ``loss_at`` builds it, and its gradients on the
    phase's leaves."""
    tstate, frozen = jcal._split_state(state, KEYS[phase])
    pack = s["jpack"]

    def loss_at(ts, img, inputs):
        st = jcal._merge_state(ts, frozen)
        qp = jqm.quantize_params(s["params"], s["jspec"], st,
                                 mode=MODE[phase], soft=True)
        if dtype is not None:
            qp = jax.tree_util.tree_map(lambda x: x.astype(dtype), qp)
            inputs = inputs.astype(dtype)
        pred = s["jm"].apply(qp, inputs,
                             method="decode_cf").astype(jnp.float32)
        diff = (pred - img) * pack["mask"]
        return (diff * diff).sum() / (img.shape[0] * pack["denom"])

    idx = jnp.asarray(batch)
    loss, grads = jax.jit(jax.value_and_grad(loss_at))(
        tstate, pack["gt"][idx], jnp.asarray(s["emb"])[idx])
    return float(loss), grads


class TestCalibrationStep:
    @pytest.mark.parametrize("arch,phase", [("hnerv", 1), ("hnerv", 2),
                                            ("nerv", 2), ("pnerv", 2)])
    def test_bf16_step_matches_jax(self, cases, arch, phase):
        """One step from the same state and batch, the decode in bf16 on
        both sides: the loss, and the gradient of every trainable leaf,
        which reaches the fp32 state through the cast. A leaf whose JAX
        bf16 gradient is itself further than STEP_GRAD_TOL from JAX's fp32
        one is held to twice that distance (see the module docstring)."""
        s = cases(arch)
        jstate = jqm.init_quant_state(s["params"], s["jspec"])
        if phase == 2:
            jstate = jqm.adaround_upgrade(s["params"], s["jspec"], jstate)
        batch = np.array([5, 2])
        want_loss, want_g = _jax_step(s, jstate, phase, batch)
        _, fp32_g = _jax_step(s, jstate, phase, batch, None)
        tstate = quant_state_from_numpy(_np(jstate))
        for st in tstate.values():
            for k in KEYS[phase]:
                if k in st:
                    st[k].requires_grad_()
        loss = tcal.make_loss(s["tm"], s["sd"], s["tspec"], MODE[phase],
                              2.0, s["tpack"], compute_dtype=BF16)
        idx = torch.from_numpy(batch)
        total, (rec, _, _) = loss(tstate, s["tpack"]["gt"][idx],
                                  torch.from_numpy(s["emb"])[idx], 1)
        assert total.dtype == torch.float32
        total.backward()
        assert abs(float(rec) - want_loss) <= STEP_LOSS_TOL * want_loss
        n = 0
        for ln in s["tspec"].layer_names:
            for k in KEYS[phase]:
                if k not in tstate[ln]:
                    continue
                got = tstate[ln][k].grad
                assert got.dtype == torch.float32
                own = _max_rel(want_g[ln][k], fp32_g[ln][k])
                assert _max_rel(got.numpy(), want_g[ln][k]) <= max(
                    STEP_GRAD_TOL, 2 * own), (ln, k)
                n += 1
        assert n >= len(s["tspec"].layer_names)


class TestDecodeCF:
    def test_bf16_decode_cf_matches_jax(self, cases, monkeypatch):
        """HNeRV's decode_cf on bf16 parameters and embeddings: every
        tail conv and entry pack outputs bf16, and the result is JAX's bf16
        decode_cf within DECODE_TOL."""
        s = cases("hnerv")
        emb = s["emb"][:2]
        qp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                    s["params"])
        want = np.asarray(s["jm"].apply(qp, jnp.asarray(emb, jnp.bfloat16),
                                        method="decode_cf"), np.float32)
        seen = []

        def recording(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                seen.extend(t.dtype for t in (out if isinstance(out, tuple)
                                              else (out,)))
                return out
            return wrapped

        monkeypatch.setattr(ttf, "conv_cf", recording(ttf.conv_cf))
        monkeypatch.setattr(ttf, "pack_cf", recording(ttf.pack_cf))
        model = build_model("hnerv", s["cfg"], device="cpu")
        model.load_state_dict(s["sd"])
        model = model.to(BF16)
        with torch.no_grad():
            got = model.decode_cf(torch.from_numpy(emb).to(BF16))
        n_conv = len(model.blocks) - model.pack_start + 2   # tail + prefix
        assert len(seen) == n_conv + 2 and set(seen) == {BF16}
        assert got.dtype == BF16 and got.shape == want.shape
        assert float(np.abs(got.float().numpy() - want).max()) <= DECODE_TOL


class TestTailFunction:
    def test_bf16_gradients_come_back_in_the_weights_dtype(self, cases,
                                                           monkeypatch):
        """The tail Function in bf16: the output, the cotangent its
        backward receives and every gradient (input, kernels, biases) are
        bf16; dW and db are cast from their fp32 sums by the Function, not
        left to autograd."""
        s = cases("hnerv")
        plan, _, _ = tail_plan_for("hnerv", s["cfg"])
        model = s["tm"]
        blocks, head = collect_tail_params(model.blocks, model.head_layer,
                                           model.pack_start)
        wts = ttf.prepare_tail(plan.h, plan.w, blocks, head, dtype=BF16)
        kks = [k.detach().requires_grad_() for k in wts.kks]
        bms = [b.detach().requires_grad_() for b in wts.biases]
        g = torch.Generator().manual_seed(0)
        x = (torch.randn((2, plan.layers[0].cin, plan.mp), generator=g)
             * ttf.border_mask(plan)).to(BF16).requires_grad_()
        seen = []
        dw = ttf.conv_cf_dw

        def recording(*a, **k):
            out = dw(*a, **k)
            seen.extend(t.dtype for t in out)
            return out

        monkeypatch.setattr(ttf, "conv_cf_dw", recording)
        out = ttf.tail_apply(plan, x, kks, bms)
        out.register_hook(lambda t: seen.append(("g", t.dtype)))
        (out.float() ** 2).sum().backward()
        assert out.dtype == BF16 and seen[0] == ("g", BF16)
        assert set(seen[1:]) == {torch.float32}         # the fp32 sums
        assert all(t.grad.dtype == BF16 for t in (x, *kks, *bms))


class TestMatmulPrecision:
    def test_library_products_are_bf16_products(self):
        """Conv2d, the ConvNeXt linears' function and KFc's products under
        the bf16 precision: bf16 operands, fp32 result, fp32 bias; outside
        it, and on bf16 activations, unchanged."""
        g = torch.Generator().manual_seed(0)
        conv = Conv2d(6, 10, 3, padding=1)
        conv.reset_parameters(g)
        x = torch.randn((2, 7, 9, 6), generator=g)
        plain = conv(x)
        w2 = conv.weight[:, :, 1, 1]
        with precision.matmul_precision("bfloat16"):
            got = conv(x)
            lin = precision.linear(x, w2, conv.bias)
            c16 = copy.deepcopy(conv).to(BF16)         # bf16 stays as it is
            x16 = x.to(BF16)
            assert torch.equal(c16(x16), torch.nn.functional.conv2d(
                x16.permute(0, 3, 1, 2), c16.weight, c16.bias,
                padding=1).permute(0, 2, 3, 1))
        want = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2).to(BF16), conv.weight.to(BF16),
            padding=1).float().permute(0, 2, 3, 1) + conv.bias
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert not torch.equal(got, plain)
        assert torch.equal(lin, torch.nn.functional.linear(
            x.to(BF16), w2.to(BF16)).float() + conv.bias)
        assert torch.equal(conv(x), plain)
        kfc = KFcBias(7, 9, 14, 18, 6)
        kfc.reset_parameters(g)
        with precision.matmul_precision("bfloat16"):
            got = kfc(x)
        y = torch.einsum("coh,bchw->bcow", kfc.w_L[0].to(BF16),
                         x.permute(0, 3, 1, 2).to(BF16)).float()
        y = torch.einsum("bcow,cwq->bcoq", y.to(BF16),
                         kfc.w_R[0].to(BF16)).float()
        assert torch.equal(got, y.permute(0, 2, 3, 1).contiguous())
        with pytest.raises(ValueError):
            with precision.matmul_precision("tensorfloat32"):
                pass

    def test_tail_and_prefix_are_their_bf16_runs(self, cases):
        """The decode's tail and fused prefix under the bf16 precision equal
        the same functions on bf16-cast entries and weights, bit for bit,
        and come back fp32; the kept packed weights are keyed on dtype."""
        s = cases("hnerv")
        model = s["tm"]
        emb = torch.from_numpy(s["emb"][:2])
        with torch.no_grad():
            x = model._layer0(emb)
            for blk in model.blocks[:model.pack_start - 1]:
                x = blk(x)
            blk = model.blocks[model.pack_start - 1]
            h, w = int(x.shape[1]), int(x.shape[2])
            with precision.matmul_precision("bfloat16"):
                pw = ttf.prepare_prefix_block(h, w, *blk.conv_params(),
                                              blk.stride,
                                              dtype=precision.operand_dtype(x))
                zp = ttf.run_fused_prefix_block(x, pw)
                xt = model._prefix(emb, "fused")
                tw = model._tail_weights(xt)
                zt = ttf.run_fused_tail_cf(xt, tw)[0]
            assert pw.kks[0].dtype == tw.kks[0].dtype == BF16
            assert zp.dtype == zt.dtype == torch.float32
            pw16 = ttf.prepare_prefix_block(
                h, w, *(t.to(BF16) for t in blk.conv_params()), blk.stride)
            assert torch.equal(zp, ttf.run_fused_prefix_block(
                x.to(BF16), pw16).float())
            blocks, head = collect_tail_params(model.blocks, model.head_layer,
                                               model.pack_start)
            tw16 = ttf.prepare_tail(
                h * blk.stride, w * blk.stride,
                [(k.to(BF16), b.to(BF16), r) for k, b, r in blocks],
                tuple(t.to(BF16) for t in head))
            assert torch.equal(zt, ttf.run_fused_tail_cf(
                xt.to(BF16), tw16)[0].float())
            assert any(k[-1] is BF16 for k in model._packed)

    def test_stage1_step_against_jax_fp32(self, cases):
        """One stage-1 step of the tiny HNeRV (encoder, decode, loss,
        backward) under the bf16 precision against the JAX package's step,
        which computes fp32 on the CPU: the loss and the gradients."""
        from neuroquant_tpu.utils.torch_compat import params_to_state_dict

        s = cases("hnerv")
        frames = s["frames"][:2]

        def jloss(p):
            out = s["jm"].apply(p, jnp.asarray(frames))
            return jax_loss_fn(out, jnp.asarray(frames), "l2")

        want, jg = jax.value_and_grad(jloss)(s["params"])
        want_g = params_to_state_dict("hnerv", _np(jg))
        model = build_model("hnerv", s["cfg"], device="cpu")
        model.load_state_dict(s["sd"])
        with precision.matmul_precision("bfloat16"):
            loss = loss_fn(model(torch.from_numpy(frames)),
                           torch.from_numpy(frames), "l2")
            loss.backward()
        assert abs(float(loss) - float(want)) <= S1_LOSS_TOL * float(want)
        names = [n for n, _ in model.named_parameters()]
        assert sorted(names) == sorted(want_g)
        prm = dict(model.named_parameters())
        assert all(prm[n].grad.dtype == torch.float32 for n in names)
        got = np.concatenate([prm[n].grad.numpy().ravel() for n in names])
        ref = np.concatenate([np.asarray(want_g[n]).ravel() for n in names])
        assert _max_rel(got, ref) <= S1_GRAD_TOL
        cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
        assert cos >= S1_COSINE

