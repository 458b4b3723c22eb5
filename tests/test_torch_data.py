"""The port's synthetic data (repro_torch.data) against the JAX package's
(repro.data), on the CPU: token batches bitwise equal for the three
frontends, at several steps and seeds, and for row slices of the global
batch; the scenes and orbit cameras of ``synthetic_scene_and_views``: the
cameras equal, the scene of the same distribution (the port draws from a
``torch.Generator``, not ``jax.random``, so the numbers differ): the same
fields, shapes and dtypes, every value inside its distribution's support,
and each field's mean and standard deviation within SIGMAS = 6 standard
errors of the JAX scene's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import TokenStream as JStream, make_batch as j_make_batch
from repro.data import synthetic_scene_and_views as j_scene_and_views
from repro_torch.data import TokenStream, make_batch, synthetic_scene_and_views


@pytest.mark.parametrize("frontend", ["text", "vision_stub", "audio_stub"])
def test_make_batch_is_bitwise_the_reference(frontend):
    for vocab, batch, seq, seed, step in ((517, 4, 64, 1, 0), (49155, 2, 33, 7, 12345),
                                          (100, 3, 32, 2, 1)):
        mine, theirs = (TokenStream(vocab, batch, seq, seed), JStream(vocab, batch, seq, seed))
        a = make_batch(mine, step, frontend, n_frontend_tokens=8, d_model=16)
        b = j_make_batch(theirs, step, frontend, n_frontend_tokens=8, d_model=16)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


def test_row_slices_are_bitwise_the_reference():
    mine, theirs = TokenStream(1000, 16, 16, seed=3), JStream(1000, 16, 16, seed=3)
    full = mine.batch_at(4)
    np.testing.assert_array_equal(full, theirs.batch_at(4))
    for lo, hi in ((0, 16), (4, 9), (15, 16), (7, 7)):
        part = mine.batch_at(4, lo=lo, hi=hi)
        np.testing.assert_array_equal(part, theirs.batch_at(4, lo=lo, hi=hi))
        np.testing.assert_array_equal(part, full[lo:hi])
    assert (full != mine.batch_at(5)).any()
    assert full.min() >= 0 and full.max() < 1000


SIGMAS = 6


def _moments_agree(a, b, n, what):
    """Mean and standard deviation of two samples of one distribution, each
    of ``n`` independent draws: their differences within SIGMAS standard
    errors (a mean's sqrt(var / n), a deviation's about sqrt(var / 2n))."""
    var = a.var() + b.var()
    assert abs(a.mean() - b.mean()) <= SIGMAS * np.sqrt(var / n), (what, a.mean(), b.mean())
    assert abs(a.std() - b.std()) <= SIGMAS * np.sqrt(var / (2 * n)), (what, a.std(), b.std())


def test_scene_and_views():
    N, extent = 4096, 2.5
    scene, cams = synthetic_scene_and_views(5, N, 64, 48, n_views=3, extent=extent,
                                            device="cpu")
    jscene, jcams = j_scene_and_views(5, N, 64, 48, n_views=3, extent=extent)
    assert scene.means3d.device.type == "cpu" and scene.num_gaussians == N
    again, _ = synthetic_scene_and_views(5, N, 64, 48, n_views=3, extent=extent, device="cpu")
    other, _ = synthetic_scene_and_views(6, N, 64, 48, n_views=3, extent=extent, device="cpu")
    assert torch.equal(scene.means3d, again.means3d)
    assert not torch.equal(scene.means3d, other.means3d)
    mine = {f.name: getattr(scene, f.name).numpy() for f in dataclasses.fields(scene)}
    theirs = {f.name: np.asarray(getattr(jscene, f.name)) for f in dataclasses.fields(jscene)}
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].shape == theirs[k].shape and mine[k].dtype == theirs[k].dtype, k
    sh0 = lambda rgb: (rgb - 0.5) / 0.28209479177387814   # rgb_to_sh0
    support = {"log_scales": (-4.6, -1.9), "opacity": (-4.5, 3.5),
               "sh": (sh0(0.05), sh0(0.95)),
               # cluster centres in [-extent, extent], N(0, 0.08 extent) jitter
               "means3d": (-extent * (1 + SIGMAS * 0.08), extent * (1 + SIGMAS * 0.08))}
    for k, (lo, hi) in support.items():
        for name, x in (("port", mine[k]), ("jax", theirs[k])):
            assert lo - 1e-5 <= x.min() and x.max() <= hi + 1e-5, (k, name, x.min(), x.max())
    assert np.isfinite(mine["quats"]).all()
    n_clusters = N // 64   # the means' spread is their 64 centres' draws
    for axis in range(3):
        _moments_agree(mine["means3d"][:, axis], theirs["means3d"][:, axis], n_clusters,
                       f"means3d[{axis}]")
    for k in ("log_scales", "quats", "opacity", "sh"):
        _moments_agree(mine[k].ravel(), theirs[k].ravel(), mine[k].size, k)
    assert len(cams) == len(jcams) == 3
    for c, j in zip(cams, jcams):
        for f in dataclasses.fields(c):
            np.testing.assert_allclose(np.asarray(getattr(c, f.name)),
                                       np.asarray(getattr(j, f.name)), rtol=1e-6, atol=1e-6)
