"""Port parity of the image metrics: repro_torch.core.metrics against
repro.core.metrics on images made from a numpy seed (PSNR, SSIM and D-SSIM
rtol 1e-5 with atol 1e-6; the D-SSIM gradient against jax.grad, max-abs
within 1e-5 of its largest magnitude)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jm
from repro_torch.core import metrics as tm

RTOL = 1e-5
# SSIM of two unrelated images is about 0.01, a mean of terms that cancel
# (E[x^2] - mu^2 and so on); the two convolutions sum their 121 products in
# other orders, which moves it by a few 1e-7 absolute.
ATOL = 1e-6
GRAD_TOL = 1e-5   # max-abs difference over the largest magnitude


def _pair(h, w, seed, related):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    if related:  # a noisy copy: SSIM well away from 0
        ref = np.clip(img + 0.1 * rng.standard_normal((h, w, 3)), 0.0, 1.0)
    else:
        ref = rng.uniform(0.0, 1.0, (h, w, 3))
    return img, ref.astype(np.float32)


SHAPES = [(32, 32), (48, 80), (96, 64)]


@pytest.mark.parametrize("related", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["psnr", "ssim", "dssim"])
def test_metric_matches_reference(name, shape, related):
    img, ref = _pair(*shape, seed=sum(shape), related=related)
    want = float(getattr(jm, name)(jnp.asarray(img), jnp.asarray(ref)))
    got = float(getattr(tm, name)(torch.from_numpy(img), torch.from_numpy(ref)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gaussian_window_matches_reference():
    got = tm._gaussian_kernel().numpy()
    np.testing.assert_allclose(got, np.asarray(jm._gaussian_kernel()), rtol=RTOL, atol=0)
    assert got.shape == (11, 11)


@pytest.mark.parametrize("shape", [(32, 32), (48, 80)])
def test_dssim_gradient_matches_jax_grad(shape):
    img, ref = _pair(*shape, seed=7, related=True)
    want = np.asarray(jax.grad(jm.dssim)(jnp.asarray(img), jnp.asarray(ref)))
    x = torch.from_numpy(img).requires_grad_(True)
    tm.dssim(x, torch.from_numpy(ref)).backward()
    got = x.grad.numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= GRAD_TOL * scale
