"""Port parity: scene, camera and projection (repro_torch.core vs repro.core)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import make_camera, random_scene
from repro.core import boundary as jboundary
from repro.core.projection import project as jproject
from repro_torch.core import boundary, camera, gaussians
from repro_torch.core.projection import Projected, eigen2x2, project
from torch_parity import n, t

CAM = dict(eye=(0.0, 1.0, 4.5), target=(0.0, 0.0, 0.0), width=96, height=96)


def _scene(seed, sh_degree=0, num=400, extent=3.0):
    return random_scene(jax.random.key(seed), num, extent=extent, sh_degree=sh_degree)


def test_camera_is_a_copy():
    want = make_camera(**CAM, fov_x_deg=62.0)
    got = camera.make_camera(**CAM, fov_x_deg=62.0)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))
    xyz = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(camera.world_to_cam(t(got.R), t(got.t), t(xyz))),
        np.asarray(xyz @ want.R.T + want.t), rtol=1e-6, atol=1e-6,
    )


def test_scene_roundtrip_and_covariance():
    scene = _scene(3, sh_degree=1, num=64)
    port = gaussians.scene_from_numpy(scene, "cpu")
    back = gaussians.scene_to_numpy(port)
    for f in gaussians.SCENE_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(scene, f)))
    assert port.num_gaussians == 64 and port.sh_degree == 1
    from repro.core.gaussians import covariance3d as jcov

    np.testing.assert_allclose(
        n(gaussians.covariance3d(port.log_scales, port.quats)),
        np.asarray(jcov(scene.log_scales, scene.quats)), rtol=1e-5, atol=1e-7,
    )


def test_random_scene_generator_is_explicit():
    g = torch.Generator().manual_seed(7)
    a = gaussians.random_scene(300, extent=2.0, sh_degree=1, generator=g)
    b = gaussians.random_scene(300, extent=2.0, sh_degree=1,
                               generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in gaussians.SCENE_FIELDS)
    assert a.sh.shape == (300, 4, 3) and a.means3d.dtype == torch.float32
    rgb = gaussians.sh0_to_rgb(a.sh[:, 0])
    assert float(rgb.min()) >= 0.05 - 1e-6 and float(rgb.max()) <= 0.95 + 1e-6


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_project_matches_reference(sh_degree):
    """Every field within rtol 1e-5 / atol 1e-5, ``valid`` identical.

    The one exception is ``eigvec``: where |b| of the 2D covariance is tiny
    its direction is ill-conditioned, and the matmul drift between XLA and
    torch (a few ulps of (a, b, c)) moves it by up to ~2e-4. It is held to
    1e-3 here and to 1e-5 by ``test_eigen2x2_on_reference_covariance``,
    which feeds the reference's own covariance."""
    scene = _scene(11 + sh_degree, sh_degree=sh_degree)
    cam = make_camera(**CAM)
    want = jproject(scene, cam)
    got = project(gaussians.scene_from_numpy(scene, "cpu"), camera.make_camera(**CAM))
    np.testing.assert_array_equal(n(got.valid), np.asarray(want.valid))
    for f in dataclasses.fields(Projected):
        tol = 1e-3 if f.name == "eigvec" else 1e-5
        np.testing.assert_allclose(
            n(getattr(got, f.name)), np.asarray(getattr(want, f.name)),
            rtol=1e-5, atol=tol, err_msg=f.name,
        )


def test_eigen2x2_on_reference_covariance():
    """Stage by stage: the eigen-decomposition of the reference's cov2d
    gives the reference's eigval/eigvec."""
    want = jproject(_scene(12, sh_degree=1), make_camera(**CAM))
    valid = np.asarray(want.valid)
    a, b, c = (t(np.asarray(want.cov2d)[valid, i]) for i in range(3))
    lam1, lam2, eigvec = eigen2x2(a, b, c, a * c - b * b)
    np.testing.assert_allclose(n(torch.stack([lam1, lam2], -1)),
                               np.asarray(want.eigval)[valid], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(eigvec), np.asarray(want.eigvec)[valid],
                               rtol=1e-5, atol=1e-5)


def test_culled_defaults_exact():
    """Culled gaussians carry the JAX package's cleanup values bit for bit:
    mean 0, radius 0, identity conic/cov, depth +inf, eigvec (1,0), eigval 1."""
    scene = _scene(5)
    cam = camera.make_camera(**CAM)
    got = project(gaussians.scene_from_numpy(scene, "cpu"), cam)
    want = jproject(scene, make_camera(**CAM))
    culled = ~n(got.valid)
    assert culled.sum() > 10  # the scene extends behind and beside the camera
    defaults = {
        "mean2d": [0.0, 0.0], "cov2d": [1.0, 0.0, 1.0], "conic": [1.0, 0.0, 1.0],
        "depth": np.inf, "radius": 0.0, "axis_radius": [0.0, 0.0],
        "eigvec": [1.0, 0.0], "eigval": [1.0, 1.0], "rgb": [0.0, 0.0, 0.0], "alpha": 0.0,
    }
    for name, value in defaults.items():
        port = n(getattr(got, name))[culled]
        np.testing.assert_array_equal(port, np.broadcast_to(value, port.shape), err_msg=name)
        np.testing.assert_array_equal(port, np.asarray(getattr(want, name))[culled])


@pytest.mark.parametrize("method", ["aabb", "obb", "ellipse", "ellipse_opacity"])
def test_boundary_tests_bit_exact(method):
    """Same float32 inputs -> same hits, including points on rect edges."""
    proj = jproject(_scene(2), make_camera(**CAM))
    rng = np.random.default_rng(0)
    x0 = rng.integers(0, 6, size=(1, 8)).astype(np.float32) * 16
    y0 = rng.integers(0, 6, size=(1, 8)).astype(np.float32) * 16
    rect = (x0, y0, x0 + 16, y0 + 16)

    class Lift:
        def __init__(self, p, lib):
            self.p, self.lib = p, lib

        def __getattr__(self, name):
            v = getattr(self.p, name)
            return v[:, None] if self.lib == "jax" else t(v)[:, None]

    want = jboundary.boundary_test(method, Lift(proj, "jax"), rect)
    got = boundary.boundary_test(method, Lift(proj, "torch"), tuple(map(t, rect)))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert np.asarray(want).any() and not np.asarray(want).all()
