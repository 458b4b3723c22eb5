"""Scene sharding on the port (repro_torch.sharding, the sharded frontend of
repro_torch.core.pipeline, engine.open(scene_shards=D)) against the port's
own D = 1 render, bit for bit, and against the JAX package's sharded render
(the in-process cases of tests/test_sharding.py).

Inputs: a 200-gaussian scene made from a seed with numpy
(_numpy_scene), one 128x128 camera, D in {1, 2, 3} (200 is not a
multiple of 3: the last shard carries a padding row). Tolerances: within
the port, image and every counter bitwise equal on both backends (the
``cuda`` backend runs its kernels' plain versions on CPU tensors); port
against JAX, counters identical and images within atol 5e-6, rtol 1e-5
(projection drifts by ulps between XLA and torch).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GaussianScene as JScene
from repro.core import make_camera as jax_make_camera
from repro.core.pipeline import RenderConfig as JConfig
from repro.core.projection import ShardedProjected as JShardedProjected
from repro.core.projection import proj_take as jax_proj_take
from repro.core.projection import project as jax_project
from repro.sharding.scene import shard_scene as jax_shard_scene
from repro.sharding.scene import shard_scene_host as jax_shard_scene_host
from repro_torch import engine
from repro_torch.core import camera, pipeline
from repro_torch.core.gaussians import SCENE_FIELDS, scene_from_numpy
from repro_torch.core.projection import (
    Projected,
    ShardedProjected,
    proj_take,
    proj_valid_count,
    project,
)
from repro_torch.sharding import (
    ShardedScene,
    scene_flat,
    shard_scene,
    shard_scene_host,
    unshard_scene,
)
from repro_torch.sharding.scene import PAD_OPACITY
from torch_parity import assert_counters_equal, n, t

CAM = dict(eye=(0.0, 1.0, 4.0), target=(0.0, 0.0, 0.0), width=128, height=128)
MODES = ("gstg", "tile_baseline", "group_baseline")
BACKENDS = ("reference", "cuda")
JAX_IMAGE_TOL = dict(atol=5e-6, rtol=1e-5)


def _numpy_scene(seed: int, n: int, extent: float = 2.5) -> dict:
    """A clustered scene as float32 numpy arrays in the JAX field layout,
    made from ``seed`` with numpy (the distribution of ``random_scene``):
    feed it to ``repro.core.GaussianScene`` and to ``scene_from_numpy``."""
    rng = np.random.default_rng(seed)
    n_clusters = max(1, n // 64)
    centers = rng.uniform(-extent, extent, (n_clusters, 3))
    means = centers[rng.integers(0, n_clusters, n)] + rng.normal(size=(n, 3)) * extent * 0.08
    rgb = rng.uniform(0.05, 0.95, (n, 3))
    arrays = dict(
        means3d=means,
        log_scales=rng.uniform(-4.6, -1.9, (n, 3)),
        quats=rng.normal(size=(n, 4)),
        opacity=rng.uniform(-4.5, 3.5, n),
        sh=((rgb - 0.5) / 0.28209479177387814)[:, None, :],
    )
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _cfg(**kw) -> pipeline.RenderConfig:
    return pipeline.RenderConfig(**{**dict(tile=16, group=64, group_capacity=256,
                                           tile_capacity=256), **kw})


@pytest.fixture(scope="module")
def arrays():
    return _numpy_scene(seed=11, n=200)


@pytest.fixture(scope="module")
def scene(arrays):
    return scene_from_numpy(arrays, "cpu")


@pytest.fixture(scope="module")
def jax_scene(arrays):
    return JScene(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def cam():
    return camera.make_camera(**CAM)


_ONE_SHARD = {}


def _one_shard(scene, cam, mode, backend):
    """The port's D = 1 render of the plain scene, once per (mode, backend)."""
    key = (id(scene), mode, backend)
    if key not in _ONE_SHARD:
        _ONE_SHARD[key] = pipeline.render(scene, cam, _cfg(mode=mode, backend=backend))
    return _ONE_SHARD[key]


def _assert_bitwise(a, b, what):
    assert torch.equal(a.image, b.image), f"image diverges {what}"
    for f in dataclasses.fields(a.stats):
        assert torch.equal(getattr(a.stats, f.name), getattr(b.stats, f.name)), (
            f"counter {f.name} diverges {what}")


def test_shard_scene_canonical_layout(arrays, scene, jax_scene, cam):
    """Pad/shard/flatten round trip: the contiguous layout, bitwise real
    rows, padding rows culled; shard_scene and shard_scene_host build the
    JAX package's layout on the same arrays, bit for bit."""
    n_real = scene.num_gaussians                    # 200
    sharded = shard_scene(scene, 3)                 # ragged: 200 -> 3 x 67
    assert (sharded.num_shards, sharded.shard_size) == (3, 67)
    assert (sharded.num_real, sharded.num_gaussians, sharded.padded_size) == (200, 200, 201)
    want = jax_shard_scene(jax_scene, 3)
    hosted = shard_scene_host(scene, 3)
    want_host = jax_shard_scene_host(jax_scene, 3)
    for f in SCENE_FIELDS:
        got = getattr(sharded.shards, f)
        assert torch.equal(got, t(getattr(want.shards, f))), f
        assert torch.equal(getattr(hosted.shards, f), t(getattr(want_host.shards, f))), f
        assert getattr(hosted.shards, f).device.type == "cpu"
        assert torch.equal(getattr(scene_flat(sharded), f)[:n_real], getattr(scene, f)), f
        assert torch.equal(getattr(unshard_scene(sharded), f), getattr(scene, f)), f
    assert torch.equal(sharded.shards.opacity[-1, -1], torch.tensor(PAD_OPACITY))
    # Padding rows are culled by projection (alpha < 1/255).
    proj = project(scene_flat(sharded), cam)
    assert not proj.valid[n_real:].any()
    moved = sharded.to("cpu")
    assert isinstance(moved, ShardedScene) and moved.num_real == n_real
    assert torch.equal(moved.shard(2).means3d, sharded.shards.means3d[2])
    for bad in (0, -1):
        with pytest.raises(ValueError, match="num_shards"):
            shard_scene(scene, bad)
        with pytest.raises(ValueError, match="num_shards"):
            shard_scene_host(scene, bad)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("gather", ["index", "psum", "flat"])
@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_scene_sharded_render_parity(scene, cam, mode, shards, gather, backend):
    """The invariant: the sharded render is bitwise the D = 1 render (image
    and every counter), in every mode, on both backends, under every
    feature-gather strategy, for the degenerate one-shard layout and the
    ragged three-shard one. The ShardedScene is passed in, as a handle
    commits it."""
    want = _one_shard(scene, cam, mode, backend)
    cfg = _cfg(mode=mode, backend=backend, scene_shards=shards, feature_gather=gather)
    got = pipeline.render(shard_scene(scene, shards), cam, cfg)
    _assert_bitwise(got, want, f"(mode={mode}, D={shards}, gather={gather}, {backend})")
    assert got.stats.as_dict()["n_visible"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_plain_scene_shards_inside_render(scene, cam, backend):
    """A plain scene with cfg.scene_shards = D is sharded inside render, and
    render_frontend/render_backend compose to the same bits; the frontend
    hands on a ShardedProjected (index, psum) or the flat padded view."""
    want = _one_shard(scene, cam, "gstg", backend)
    for gather, kind in (("auto", ShardedProjected), ("psum", ShardedProjected),
                         ("flat", Projected)):
        cfg = _cfg(backend=backend, scene_shards=3, feature_gather=gather)
        _assert_bitwise(pipeline.render(scene, cam, cfg), want, f"({gather}, plain scene)")
        front = pipeline.render_frontend(scene, cam, cfg)
        assert type(front.proj) is kind
        if kind is ShardedProjected:
            assert front.proj.gather == pipeline.resolve_feature_gather(cfg)
            assert (front.proj.num_shards, front.proj.shard_size) == (3, 67)
        _assert_bitwise(pipeline.render_backend(front, cam, cfg), want, f"({gather}, halves)")
    assert pipeline.resolve_feature_gather(_cfg()) == "index"


def test_feature_gather_unknown_strategy_raises(scene, jax_scene, cam):
    """Both packages refuse an unknown strategy on a sharded config with the
    same ValueError."""
    from repro.core.pipeline import render as jax_render

    with pytest.raises(ValueError, match="feature_gather") as want:
        jax_render(jax_scene, jax_make_camera(**CAM),
                   JConfig(tile=16, group=64, scene_shards=2, feature_gather="bogus"))
    with pytest.raises(ValueError, match="feature_gather") as got:
        pipeline.render(scene, cam, _cfg(scene_shards=2, feature_gather="bogus"))
    assert str(got.value) == str(want.value)


def _jax_projected_shards(jax_scene, shards):
    jcam = jax_make_camera(**CAM)
    return jax.vmap(lambda s: jax_project(s, jcam))(jax_shard_scene(jax_scene, shards).shards)


def test_sharded_proj_take_matches_flat_gather(scene, jax_scene, cam):
    """proj_take on a ShardedProjected: both strategies give the flat gather
    bit for bit for every field, on the port's per-shard projection; and on
    the JAX package's per-shard projection they give JAX's proj_take bit
    for bit. The visible count equals the flat one."""
    D = 3
    sharded = shard_scene(scene, D)
    proj_s = Projected(**{
        f.name: torch.stack([getattr(project(sharded.shard(d), cam), f.name) for d in range(D)])
        for f in dataclasses.fields(Projected)
    })
    flat = Projected(**{f.name: getattr(proj_s, f.name).flatten(0, 1)
                        for f in dataclasses.fields(Projected)})
    # Bits the psum gather must carry verbatim: signed zero and a NaN payload.
    proj_s.mean2d[0, 0, 0] = -0.0
    proj_s.conic[1, 1, 0] = torch.tensor(0x7FC00123, dtype=torch.int32).view(torch.float32)
    rng = np.random.default_rng(0)
    idx_np = rng.integers(0, sharded.padded_size, size=(7, 13)).astype(np.int32)
    idx_np[0, :2] = [0, 67 + 1]                  # the two special entries
    idx = torch.from_numpy(idx_np)

    jproj_s = _jax_projected_shards(jax_scene, D)
    jproj_t = Projected(**{f.name: t(getattr(jproj_s, f.name))
                           for f in dataclasses.fields(Projected)})
    for gather in ("index", "psum"):
        sp = ShardedProjected(shards=proj_s, gather=gather)
        jsp = ShardedProjected(shards=jproj_t, gather=gather)
        want_sp = JShardedProjected(shards=jproj_s, gather=gather)
        for f in dataclasses.fields(Projected):
            want = getattr(flat, f.name)[idx.long()]
            got = proj_take(sp, f.name, idx)
            assert got.dtype == want.dtype and torch.equal(
                got.view(torch.uint8), want.view(torch.uint8)), f"{gather}/{f.name} vs flat"
            jwant = np.asarray(jax_proj_take(want_sp, f.name, jnp.asarray(idx_np)))
            jgot = n(proj_take(jsp, f.name, idx))
            assert jgot.dtype == jwant.dtype and (
                jgot.view(np.uint8) == jwant.view(np.uint8)).all(), f"{gather}/{f.name} vs JAX"
        assert int(proj_valid_count(sp)) == int(proj_valid_count(flat))
    assert int(proj_valid_count(jsp)) == int(np.asarray(proj_valid_count(flat)))


def test_psum_gather_refuses_to_record_a_gradient(scene, cam):
    """'psum' is inference-only: with autograd recording and a field that
    requires grad it raises; 'index' differentiates through index_select."""
    sharded = shard_scene(scene, 2)
    proj_s = Projected(**{
        f.name: torch.stack([getattr(project(sharded.shard(d), cam), f.name) for d in range(2)])
        for f in dataclasses.fields(Projected)
    })
    proj_s.depth.requires_grad_(True)
    idx = torch.tensor([[0, 101, 150]])
    with pytest.raises(RuntimeError, match="inference-only"):
        proj_take(ShardedProjected(shards=proj_s, gather="psum"), "depth", idx)
    with torch.no_grad():
        got = proj_take(ShardedProjected(shards=proj_s, gather="psum"), "depth", idx)
    taken = proj_take(ShardedProjected(shards=proj_s, gather="index"), "depth", idx)
    assert taken.requires_grad and torch.equal(taken.detach(), got)


def test_gradients_through_the_sharded_index_path(arrays, cam):
    """A loss through the reference backend at D = 3 ('index') gives the
    D = 1 loss and gradients bit for bit: the padding rows receive none."""
    grads = {}
    for shards in (1, 3):
        leaves = scene_from_numpy(arrays, "cpu")
        for f in SCENE_FIELDS:
            getattr(leaves, f).requires_grad_(True)
        out = pipeline.render(leaves, cam, _cfg(scene_shards=shards))
        loss = (out.image * torch.linspace(0.5, 1.5, 3)).sum()
        grads[shards] = (loss.detach(), torch.autograd.grad(
            loss, [getattr(leaves, f) for f in SCENE_FIELDS]))
    assert torch.equal(grads[1][0], grads[3][0])
    for f, g1, g3 in zip(SCENE_FIELDS, grads[1][1], grads[3][1]):
        assert torch.equal(g1, g3), f
    assert any(bool(g.abs().max() > 0) for g in grads[1][1])


def test_feature_budget_model_scales_inverse_d(scene, jax_scene):
    """The device-budget model: per-camera feature bytes divide by D only
    when psum gathers run over physical shards; logical shards and 'flat'
    count full N. The port's numbers are the JAX handle's."""
    from repro.engine import Renderer as JRenderer

    from repro_torch.engine import Renderer

    for shards in (1, 2, 3, 4):
        assert Renderer._feature_mb(scene, shards) == JRenderer._feature_mb(jax_scene, shards)
    assert Renderer._feature_mb(shard_scene(scene, 3), 3) == JRenderer._feature_mb(
        jax_shard_scene(jax_scene, 3), 3)
    for gather in ("auto", "index", "psum", "flat"):
        for shards, phys in ((1, 1), (4, 1), (4, 4), (2, 2)):
            cfg = _cfg(scene_shards=shards, feature_gather=gather)
            jcfg = JConfig(scene_shards=shards, feature_gather=gather)
            assert Renderer._feature_div(cfg, shards, phys) == JRenderer._feature_div(
                jcfg, shards, phys), (gather, shards, phys)
            assert Renderer._resolved_gather(cfg, shards, phys) == JRenderer._resolved_gather(
                jcfg, shards, phys), (gather, shards, phys)
    cfg = _cfg(scene_shards=4)
    assert Renderer._feature_div(cfg, 4, 4) == 4          # physical + auto (-> psum)
    assert Renderer._feature_div(cfg, 4, 1) == 1          # logical shard axis


@pytest.mark.parametrize("bg,bt", [("aabb", "aabb"), ("obb", "ellipse")])
def test_scene_sharded_lossless_combos(scene, cam, bg, bt):
    """Sharding composes with the losslessness combos on the reference
    backend: gstg at D = 2 == gstg at D = 1 (image and counters) ==
    tile_baseline at D = 1 and at D = 2 (images), with no list cut."""
    cfg = _cfg(mode="gstg", boundary_group=bg, boundary_tile=bt)
    one = pipeline.render(scene, cam, cfg)
    two = pipeline.render(scene, cam, dataclasses.replace(cfg, scene_shards=2))
    _assert_bitwise(two, one, f"({bg},{bt})")
    for shards in (1, 2):
        base = pipeline.render(scene, cam, _cfg(mode="tile_baseline", boundary_tile=bt,
                                                scene_shards=shards))
        assert torch.equal(two.image, base.image), (bg, bt, shards)
    stats = one.stats.as_dict()
    assert stats["overflow"] == 0 and stats["span_overflow"] == 0


def test_scene_shards_config_mismatch_raises(scene, jax_scene, cam):
    with pytest.raises(ValueError, match="scene_shards"):
        pipeline.render(shard_scene(scene, 2), cam, _cfg(scene_shards=3))
    with pytest.raises(ValueError, match="scene_shards"):
        pipeline.render_batch(shard_scene(scene, 2), [cam], _cfg(scene_shards=3))
    with pytest.raises(ValueError, match="pre-sharded"):
        engine.open(shard_scene(scene, 2), _cfg(), device="cpu", scene_shards=3)
    for bad in (0, -2):
        with pytest.raises(ValueError, match="scene_shards must be >= 1"):
            pipeline.render(scene, cam, _cfg(scene_shards=bad))
        with pytest.raises(ValueError, match="scene_shards must be >= 1"):
            engine.open(scene, _cfg(), device="cpu", scene_shards=bad)


def test_scene_sharded_batch_ragged_cameras(scene):
    """Gaussian sharding x ragged camera padding: a B = 3 batch through a
    D = 2 handle with pad_to=4 equals the replicated render_batch lane for
    lane, bit for bit (both axes' padding is dropped)."""
    cams = camera.orbit_cameras(3, 4.5, 128, 128)
    cfg = _cfg()
    want = pipeline.render_batch(scene, cams, cfg)
    with engine.open(scene, cfg, device="cpu", scene_shards=2) as r:
        got = r.render_batch(cams, pad_to=4)
        assert r.stats()["padded_lanes"] == 0          # counted by submit only
    _assert_bitwise(got, want, "(ragged batch)")
    assert got.image.shape[0] == 3


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_render_matches_jax(jit_render_fn, arrays, jax_scene, mode, backend):
    """The port's D = 3 render against the JAX package's D = 3 render of
    the same arrays: counters identical, images within atol 5e-6, rtol
    1e-5."""
    jcfg = JConfig(tile=16, group=64, group_capacity=256, tile_capacity=256, mode=mode,
                   scene_shards=3)
    want = jit_render_fn(jax_shard_scene(jax_scene, 3), jax_make_camera(**CAM), jcfg)
    got = pipeline.render(shard_scene(scene_from_numpy(arrays, "cpu"), 3),
                          camera.make_camera(**CAM),
                          _cfg(mode=mode, backend=backend, scene_shards=3))
    np.testing.assert_allclose(n(got.image), np.asarray(want.image), **JAX_IMAGE_TOL)
    assert_counters_equal(got.stats.as_dict(), want.stats)


def test_render_mesh_shards_matches_jax():
    from repro.launch.mesh import render_mesh_shards as jax_render_mesh_shards

    from repro_torch.launch.mesh import render_mesh_shards

    for n_dev in (1, 2, 3, 4, 8):
        for shards in (1, 2, 3, 4, 7, 8):
            assert render_mesh_shards(n_dev, shards) == jax_render_mesh_shards(n_dev, shards)
