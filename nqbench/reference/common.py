"""The plain reference of what HNeRV and NeRV share, written from the
published models (HNeRV, Chen et al., CVPR 2023; NeRV, Chen et al.,
NeurIPS 2021) and NeuroQuant's calibration, in plain PyTorch on NCHW
tensors, float32 with TF32 off. It imports nothing of the program.

- the decoder: decoder[0] (a 1x1 conv, then a (fc_h, fc_w) block-to-space
  shuffle), one NeRVBlock a stride (conv, PixelShuffle, GELU), a 3x3 head
  and tanh * 0.5 + 0.5;
- the weights' fake-quant: per output channel, asymmetric, max scales, in
  the normalised Walsh-Hadamard domain along the input channels (padded to
  a power of two); UAQ with a straight-through round, AdaRound with the
  rectified sigmoid; the rounding regulariser; jnp.clip's gradient (half
  on a bound);
- Adam with bias correction, as ``torch.optim.Adam`` defines it.

``tf32=True`` rounds every conv's and linear's operands to TF32 (10-bit
mantissa, round to nearest): the control, the nearest precision below the
configuration's float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

GAMMA, ZETA = -0.1, 1.1
EPS_DELTA = 1e-8


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN and cuBLAS inside."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def tf32_round(x):
    """x with its mantissa rounded to TF32's 10 bits (ties away from zero,
    as the tensor cores' conversion); the gradient passes unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def conv(x, w, b, stride=1, padding=0, groups=1, tf32=False):
    if tf32:
        x, w = tf32_round(x), tf32_round(w)
    return F.conv2d(x, w, b, stride, padding, groups=groups)


def linear(x, w, b, tf32=False):
    if tf32:
        x, w = tf32_round(x), tf32_round(w)
    return F.linear(x, w, b)


def block_to_space(x, rh: int, rw: int):
    """(N, C*rh*rw, H, W) -> (N, C, H*rh, W*rw), PixelShuffle's channel
    order for a non-square factor."""
    if rh == 1 and rw == 1:
        return x
    n, c, h, w = x.shape
    x = x.view(n, c // (rh * rw), rh, rw, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c // (rh * rw), h * rh, w * rw)


def decode(sd, cfg, embed, fc, tf32=False):
    """NHWC embedding -> NHWC frames. `sd`: the decoder's weights under the
    published names (decoder.0, decoder.{i}.conv.0, head_layer)."""
    if cfg["dec_norm"] != "none" or cfg["dec_acts"] != "gelu":
        raise ValueError("the reference decoder has no norm and GELU only")
    x = conv(embed.permute(0, 3, 1, 2), sd["decoder.0.weight"],
             sd["decoder.0.bias"], tf32=tf32)
    x = block_to_space(x, *fc)
    for i, (k, s) in enumerate(zip(cfg["dec_kernels"], cfg["dec_strides"])):
        x = conv(x, sd[f"decoder.{i + 1}.conv.0.weight"],
                 sd[f"decoder.{i + 1}.conv.0.bias"], padding=(k - 1) // 2,
                 tf32=tf32)
        x = F.gelu(F.pixel_shuffle(x, int(s)))
    x = conv(x, sd["head_layer.weight"], sd["head_layer.bias"], padding=1,
             tf32=tf32)
    if cfg["out_bias"] != "tanh":
        raise ValueError("the reference head is tanh")
    return (torch.tanh(x) * 0.5 + 0.5).permute(0, 2, 3, 1)


def quant_prefixes(cfg) -> list:
    """The quantized convs in calibration order: decoder[0], each block's
    conv, the head."""
    return (["decoder.0"]
            + [f"decoder.{i + 1}.conv.0" for i in range(len(cfg["dec_strides"]))]
            + ["head_layer"])


# ---------------------------------------------------------------------------
# fake-quant
# ---------------------------------------------------------------------------
def clip(x, lo: float, hi: float):
    """max then min: at a value on a bound half the gradient passes."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def hadamard(x):
    """Normalised Walsh-Hadamard transform along the last axis (a power of
    two): butterflies of width 1, 2, 4, ..., times the fp32 1/sqrt(n)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    half = 1
    while half < n:
        y = x.reshape(*lead, n // (2 * half), 2, half)
        x = torch.cat([y[..., 0, :] + y[..., 1, :],
                       y[..., 0, :] - y[..., 1, :]], -1).reshape(*lead, n)
        half *= 2
    return x * (1.0 / torch.sqrt(torch.tensor(float(n), dtype=x.dtype)))


def to_domain(w_oihw):
    """OIHW weight -> (O, H, W, Cin padded to 2^k) in the Hadamard domain."""
    x = w_oihw.permute(0, 2, 3, 1)
    n = 1 << max(0, (x.shape[-1] - 1).bit_length())
    if n != x.shape[-1]:
        x = F.pad(x, (0, n - x.shape[-1]))
    return hadamard(x)


def from_domain(x, cin: int):
    return hadamard(x)[..., :cin].permute(0, 3, 1, 2)


def _scale(x_min, x_max, bits: int):
    delta = torch.clamp((x_max - x_min) * (1.0 / (2 ** bits - 1)),
                        min=EPS_DELTA)
    return delta, torch.round(-x_min / delta)


def init_scales(w_oihw, b, bits: int):
    """Max scales: the weight's per output channel in the Hadamard domain
    (shape (O, 1, 1, 1)), the bias's over the whole bias (0-d)."""
    x = to_domain(w_oihw).reshape(w_oihw.shape[0], -1)
    zero = x.new_zeros(())
    wd, wz = _scale(torch.minimum(x.amin(1), zero),
                    torch.maximum(x.amax(1), zero), bits)
    bd, bz = _scale(torch.minimum(b.amin(), zero),
                    torch.maximum(b.amax(), zero), bits)
    return {"w_delta": wd.view(-1, 1, 1, 1), "w_zp": wz.view(-1, 1, 1, 1),
            "b_delta": bd, "b_zp": bz}


def round_ste(x):
    return x + (torch.round(x) - x).detach()


def uaq(x, delta, zp, bits: int):
    return (clip(round_ste(x / delta) + zp, 0.0, 2.0 ** bits - 1) - zp) \
        * delta


def soft_h(alpha):
    return clip(torch.sigmoid(alpha) * (ZETA - GAMMA) + GAMMA, 0.0, 1.0)


def adaround(x, delta, zp, alpha, bits: int):
    return (clip(torch.floor(x / delta) + soft_h(alpha) + zp, 0.0,
                 2.0 ** bits - 1) - zp) * delta


def init_alpha(x, delta):
    rest = x / delta - torch.floor(x / delta)
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


def f16_delta(d):
    """delta through float16 and back; one that rounds to 0 keeps its sign
    at float16's smallest subnormal."""
    r = d.to(torch.float16).to(torch.float32)
    return torch.where(r == 0, torch.copysign(torch.full_like(r, 2.0 ** -24),
                                              d), r)


def fake_quant(w_oihw, b, s, bits: int, mode: str):
    """(weight, bias) of one layer fake-quantized from its state `s`."""
    x = to_domain(w_oihw)
    if mode == "uaq":
        xq = uaq(x, s["w_delta"], s["w_zp"], bits)
        bq = uaq(b, s["b_delta"], s["b_zp"], bits)
    else:
        xq = adaround(x, s["w_delta"], s["w_zp"], s["w_alpha"], bits)
        bq = adaround(b, s["b_delta"], s["b_zp"], s["b_alpha"], bits)
    return from_domain(xq, w_oihw.shape[1]), bq


def round_reg(alphas, b: float, weight: float):
    total = 0.0
    for a in alphas:
        total = total + (1.0 - torch.abs(2.0 * soft_h(a) - 1.0) ** b).sum()
    return weight * total


def temp_b(count: int, t_max: int, warmup: float, b_start: int,
           b_end: int) -> float:
    """The regulariser's exponent: b_start until warmup * t_max, then
    linear to b_end at t_max, in float32."""
    import numpy as np

    start = warmup * t_max
    if start >= t_max or count < start:
        return float(b_start)
    f = np.float32
    rel = (f(count) - f(start)) / f(t_max - start)
    return float(f(f(b_end) + f(b_start - b_end) * max(f(0.0), f(1) - rel)))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------
class Adam:
    """``torch.optim.Adam`` (betas 0.9, 0.999, eps 1e-8, no decay) over a
    list of leaves, in plain tensor ops."""

    def __init__(self, leaves, lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.leaves = leaves
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr=None):
        lr = self.lr if lr is None else lr
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))


def lr_cosine(lr_type: str, base: float, step: int, total: int,
              eta_min: float = 0.05) -> float:
    """``cosine_<up>_<pow>_<min>``: a warm-up from min to 1 over the first
    `up` of training, then a half cosine floored at eta_min; at progress
    step / total."""
    kind, up, pw, lo = lr_type.split("_")
    if kind != "cosine":
        raise ValueError(lr_type)
    up, pw, lo = float(up), float(pw), float(lo)
    t = step / total
    if t < up:
        return base * (lo + (1.0 - lo) * (t / up) ** pw)
    c = 0.5 * (math.cos(math.pi * (t - up) / (1 - up)) + 1.0)
    return base * max(c, eta_min)
