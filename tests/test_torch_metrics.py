"""The port's quality metrics against the JAX package's on the same seeded
frames: SSIM, MS-SSIM (above the 5-level pyramid's minimum side, square and
with odd sides, so the average pooling pads at every level), the per-image
metric functions the evaluation calls, and the small-frame guard.

Tolerance 1e-5 absolute: both compute in fp32, the JAX Gaussian filter as
a convolution at HIGHEST precision and the port's as a sum of shifted
slices, so only the summation order differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroquant_tpu import metrics as jax_metrics
from neuroquant_tpu.ops import msssim as jax_msssim
from neuroquant_tpu_torch import metrics
from neuroquant_tpu_torch.ops import msssim

SHAPES = {"square": (2, 192, 192, 3), "odd": (1, 177, 203, 3)}


def _frames(shape, seed, noise=0.08):
    """A smooth image and a noisy copy of it, both in [0, 1]."""
    rng = np.random.RandomState(seed)
    n, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([0.5 + 0.4 * np.sin(xx / (7 + 3 * k) + yy / (11 + k))
                     for k in range(c)], -1)
    gt = np.clip(base[None] + 0.05 * rng.randn(n, h, w, c), 0, 1)
    out = np.clip(gt + noise * rng.randn(n, h, w, c), 0, 1)
    return out.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("size_average", [True, False])
def test_ms_ssim_matches_jax(shape, size_average):
    out, gt = _frames(shape, 0)
    want = np.asarray(jax_msssim.ms_ssim(jnp.asarray(out), jnp.asarray(gt),
                                         size_average=size_average))
    got = msssim.ms_ssim(torch.from_numpy(out), torch.from_numpy(gt),
                         size_average=size_average).numpy()
    assert got.shape == want.shape
    assert np.all((want > 0.1) & (want < 0.99))      # not a degenerate case
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), SHAPES["odd"]],
                         ids=["small", "odd"])
def test_ssim_matches_jax(shape):
    out, gt = _frames(shape, 1)
    want = np.asarray(jax_msssim.ssim(jnp.asarray(out), jnp.asarray(gt),
                                      size_average=False))
    got = msssim.ssim(torch.from_numpy(out), torch.from_numpy(gt),
                      size_average=False).numpy()
    assert np.all((want > 0.1) & (want < 0.99))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [SHAPES["square"], SHAPES["odd"],
                                   (2, 80, 160, 3)],
                         ids=["square", "odd", "below_guard"])
def test_per_image_metrics_match_jax(shape):
    out, gt = _frames(shape, 2, noise=0.03)
    jo, jg = jnp.asarray(out), jnp.asarray(gt)
    to, tg = torch.from_numpy(out), torch.from_numpy(gt)
    np.testing.assert_allclose(metrics.psnr_fn_single(to, tg).numpy(),
                               np.asarray(jax_metrics.psnr_fn_single(jo, jg)),
                               atol=1e-4, rtol=0)
    want = np.asarray(jax_metrics.msssim_fn_single(jo, jg))
    got = metrics.msssim_fn_single(to, tg).numpy()
    assert got.shape == want.shape == (shape[0],)
    if min(shape[1:3]) <= 160:
        assert np.all(got == 0) and np.all(want == 0)
    else:
        assert np.all(want > 0.5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_ms_ssim_refuses_small_frames():
    x = torch.zeros((1, 160, 200, 3))
    with pytest.raises(AssertionError, match="too small"):
        msssim.ms_ssim(x, x)
