"""The port's engine handle (repro_torch.engine) against the JAX package's
handle contract (tests/test_engine_handle.py), on the CPU with a tiny scene
at 64x64:

  * render_batch lanes against JAX ``repro.core.pipeline.render_batch``
    (images at torch_parity.IMAGE_TOL, integer counters equal);
  * within the port, render, render_batch and submit bitwise equal;
  * per-handle caches, the render-cache registry, close(), the budget;
  * the futures contract: a failing request resolves its own future and the
    next submit is bitwise equal to render; cancelled futures, worker
    crashes and close() terminate every future;
  * the once-unported options work: residency, streams, tile-parameter
    autotune, and devices=/mesh= over virtual CPU devices;
  * the serving queue and bucketing scheduler the handle is built on.

Every partial bucket is forced out with flush(); no test waits out
max_wait, and every future result has a timeout.
"""
from __future__ import annotations

import dataclasses
import gc
import weakref
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import orbit_cameras as jax_orbit_cameras
from repro.core import random_scene as jax_random_scene
from repro.core.pipeline import RenderConfig as JConfig
from repro.core.pipeline import render_batch as jax_render_batch
from repro_torch import engine
from repro_torch.core import camera, pipeline
from repro_torch.core.gaussians import scene_from_numpy
from repro_torch.core.pipeline import (
    CameraBatch,
    RenderConfig,
    render_batch,
    render_cache_clear,
    render_cache_info,
)
from repro_torch.obs import get_registry
from repro_torch.serving import (
    BucketingScheduler,
    QueueFull,
    RenderRequest,
    RequestQueue,
    pad_camera_batch,
    pad_indices,
    pad_indices_to,
    padded_size,
)
from torch_parity import IMAGE_TOL, assert_counters_equal, n, single_thread  # noqa: F401

INT_COUNTERS = [f.name for f in dataclasses.fields(pipeline.RenderStats)]
CFG_KW = dict(tile=16, group=64, group_capacity=256, tile_capacity=256)
RESULT_TIMEOUT = 60


@pytest.fixture(scope="module")
def jax_scene():
    return jax_random_scene(jax.random.key(1), 200, extent=2.5)


@pytest.fixture(scope="module")
def scene(jax_scene):
    return scene_from_numpy(jax_scene, "cpu")


@pytest.fixture()
def cfg():
    return RenderConfig(**CFG_KW)


def _cam(eye=(0.0, 1.0, 4.5)):
    return camera.make_camera(eye, (0, 0, 0), 64, 64)


def _open(scene, cfg, **kw):
    return engine.open(scene, cfg, device="cpu", **kw)


def _assert_bitwise(a, b, what):
    assert torch.equal(a.image, b.image), f"{what}: image diverges"
    for name in INT_COUNTERS:
        assert torch.equal(getattr(a.stats, name), getattr(b.stats, name)), (
            f"{what}: counter {name} diverges"
        )


def _lane(out, i):
    return out.map(lambda x: x[i])


# -- against the JAX package ----------------------------------------------------


def test_render_batch_matches_jax(jax_scene, scene):
    cams = camera.orbit_cameras(3, 4.5, 64, 64)
    jcams = jax_orbit_cameras(3, 4.5, 64, 64)
    assert all(np.array_equal(a.R, b.R) and a.fx == b.fx for a, b in zip(cams, jcams))
    want = jax_render_batch(jax_scene, jcams, JConfig(**CFG_KW))
    with _open(scene, RenderConfig(**CFG_KW)) as r:
        got = r.render_batch(cams, pad_to=4)
    assert got.image.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(n(got.image), np.asarray(want.image), **IMAGE_TOL)
    for i in range(3):
        port = {k: int(getattr(got.stats, k)[i]) for k in INT_COUNTERS}
        assert_counters_equal(port, SimpleNamespace(**{
            k: np.asarray(getattr(want.stats, k))[i] for k in INT_COUNTERS
        }))
    assert int(got.stats.overflow.sum()) == 0


# -- within the port: one path, bit for bit ---------------------------------------


@pytest.mark.parametrize("mode,backend", [
    ("gstg", "reference"), ("gstg", "cuda"), ("tile_baseline", "reference"),
])
def test_render_batch_and_submit_bitwise_equal_render(scene, mode, backend):
    """The ``cuda`` backend runs its kernels' plain versions on the CPU."""
    cfg = RenderConfig(mode=mode, backend=backend, **CFG_KW)
    cams = camera.orbit_cameras(3, 4.5, 64, 64)
    with _open(scene, cfg, max_batch=3, max_wait=30.0) as r:
        singles = [r.render(c) for c in cams]
        out_b = r.render_batch(cams, pad_to=3)
        free = render_batch(scene, cams, cfg)
        before = r.cache_info()
        futs = [r.submit(c) for c in cams]
        results = [f.result(timeout=RESULT_TIMEOUT) for f in futs]
        assert r.cache_info()["misses"] == before["misses"], "submit built a renderer"
        stats = r.stats()
    for i, one in enumerate(singles):
        _assert_bitwise(_lane(out_b, i), one, f"render_batch lane {i}")
        _assert_bitwise(_lane(free, i), one, f"free render_batch lane {i}")
        _assert_bitwise(results[i], one, f"submit {i}")
        assert results[i].image.device.type == "cpu"
    assert (stats["submitted"], stats["completed"], stats["batches"],
            stats["padded_lanes"]) == (3, 3, 1, 0)


def test_ragged_batch_pads_with_the_last_camera(scene, cfg):
    cams = camera.orbit_cameras(2, 4.5, 64, 64)
    batch = CameraBatch.from_cameras(cams)
    padded = pad_camera_batch(batch, 4)
    assert len(padded) == 4 and pad_camera_batch(batch, 2) is batch
    assert torch.equal(padded.R[3], batch.R[1]) and torch.equal(padded.fx[2:], batch.fx[1:].repeat(2))
    with _open(scene, cfg, max_batch=4, max_wait=30.0) as r:
        out = r.render_batch(cams, pad_to=4)
        assert out.image.shape[0] == 2
        _assert_bitwise(_lane(out, 1), r.render(cams[1]), "padded batch lane 1")
        fut = r.submit(cams[0])
        r.flush(timeout=RESULT_TIMEOUT)      # forces the partial bucket out
        _assert_bitwise(fut.result(timeout=RESULT_TIMEOUT), r.render(cams[0]), "flushed submit")
        assert r.stats()["padded_lanes"] == 3


def test_camera_batch_round_trips_each_camera():
    cams = camera.orbit_cameras(3, 4.5, 64, 48)
    batch = CameraBatch.from_cameras(cams)
    for i, c in enumerate(cams):
        back = batch.camera(i)
        assert np.array_equal(back.R, c.R) and np.array_equal(back.t, c.t)
        assert (back.fx, back.fy, back.cx, back.cy) == (c.fx, c.fy, c.cx, c.cy)
        assert pipeline.batch_signature(RenderConfig(), back) == pipeline.batch_signature(
            RenderConfig(), batch)
    with pytest.raises(ValueError, match="share"):
        CameraBatch.from_cameras([cams[0], camera.make_camera((0, 1, 4), (0, 0, 0), 32, 32)])
    with pytest.raises(ValueError, match="empty"):
        CameraBatch.from_cameras([])


def test_frontend_backend_halves_compose_to_render(scene, cfg):
    cam = _cam()
    with _open(scene, cfg) as r:
        whole = r.render(cam)
        split = r.render_backend(r.render_frontend(cam), cam)
        _assert_bitwise(split, whole, "frontend + backend")
        bg = [0.25, 0.5, 0.0]
        assert torch.equal(r.render(cam, background=bg).image,
                           pipeline.render(scene, cam, cfg, torch.tensor(bg)).image)


# -- caches, registry, lifecycle, budget ------------------------------------------


def test_handle_cache_hits_across_calls(scene, cfg):
    """One miss per (kind, geometry), hits afterwards — also across distinct
    cameras of the same resolution (the dicts of the JAX test)."""
    cam_a = _cam()
    cam_b = _cam((1.5, 0.8, 4.0))
    with _open(scene, cfg) as r:
        r.render(cam_a)
        assert r.cache_info()["misses"] == 1
        r.render(cam_b)                        # same geometry: hit
        assert r.cache_info() == {"hits": 1, "misses": 1, "currsize": 1, "maxsize": 64}
        r.render_batch([cam_a, cam_b])         # batch kind: new miss
        r.render_batch([cam_b, cam_a])
        info = r.cache_info()
        assert (info["hits"], info["misses"], info["currsize"]) == (2, 2, 2)
        assert render_cache_info()[r.cache_name] == info


def test_handle_close_empties_registry(scene, cfg):
    render_cache_clear()
    cam = _cam()
    r = _open(scene, cfg)
    r.render(cam)
    r.stats()
    name = r.cache_name
    assert render_cache_info()[name]["currsize"] == 1
    assert any(k.startswith(f"engine.{name}.") for k in get_registry().snapshot()["gauges"])
    r.close()
    info = render_cache_info()
    assert name not in info, "closed handle left its cache registered"
    assert sum(k["currsize"] for k in info.values()) == 0, info
    assert not any(k.startswith(f"engine.{name}.") for k in get_registry().snapshot()["gauges"])
    with pytest.raises(RuntimeError, match="closed"):
        r.render(cam)
    with pytest.raises(RuntimeError, match="closed"):
        r.submit(cam)
    r.close()                                   # idempotent


def test_render_cache_clear_resets_every_cache(scene, cfg):
    with _open(scene, cfg) as r:
        r.render(_cam())
        render_batch(scene, [_cam()], cfg)
        assert render_cache_info()["batch"]["currsize"] >= 1
        render_cache_clear()
        info = render_cache_info()
        assert info[r.cache_name] == {"hits": 0, "misses": 0, "currsize": 0, "maxsize": 64}
        assert info["batch"]["currsize"] == 0
        assert get_registry().snapshot()["gauges"][f"render_cache.{r.cache_name}.currsize"] == 0
    with pytest.raises(ValueError, match="reserved"):
        pipeline.register_render_cache("batch", info=dict, clear=lambda: None)


def test_open_enforces_device_budget(scene, cfg):
    with pytest.raises(ValueError, match="budget"):
        _open(scene, cfg, device_budget_mb=1e-6)
    with _open(scene, cfg, device_budget_mb=64.0) as r:
        stats = r.stats()
        assert 0 < stats["scene_mb_per_device"] <= 64.0
        n_g = scene.num_gaussians
        assert stats["feature_mb_per_device"] == n_g * (20 * 4 + 1) / 2**20  # 20 float32 + 1 bool
        assert (stats["scene_shards"], stats["physical_shards"]) == (1, 1)


def test_dropped_handle_is_not_pinned_by_registry(scene, cfg):
    r = _open(scene, cfg)
    name = r.cache_name
    ref = weakref.ref(r)
    assert name in render_cache_info()
    del r
    gc.collect()
    assert ref() is None, "registry pinned a dropped handle"
    assert name not in render_cache_info()


# -- scene sharding: logical shards on one device, the scene-layout cache ----------


def test_open_scene_shards_commits_logical_shards(jax_scene, scene, cfg):
    """open(scene_shards=2), once an unported option, commits two logical
    shards: render, the two halves, render_batch and submit bitwise equal
    the D = 1 handle's render; a pre-sharded ShardedScene commits the same;
    stats() and the handle properties report what the JAX handle reports
    for the same commit."""
    from repro import engine as jax_engine
    from repro.core.pipeline import RenderConfig as JRenderConfig

    from repro_torch.sharding import shard_scene

    cam, cams = _cam(), camera.orbit_cameras(2, 4.5, 64, 64)
    with _open(scene, cfg) as one:
        want, want_b = one.render(cam), [one.render(c) for c in cams]
    with _open(scene, cfg, scene_shards=2, max_batch=2, max_wait=30.0) as r, \
            _open(shard_scene(scene, 2), cfg) as pre:
        _assert_bitwise(r.render(cam), want, "D=2 render")
        _assert_bitwise(pre.render(cam), want, "pre-sharded render")
        _assert_bitwise(r.render_backend(r.render_frontend(cam), cam), want, "D=2 halves")
        batch = r.render_batch(cams, pad_to=2)
        futs = [r.submit(c) for c in cams]
        for i, c in enumerate(cams):
            _assert_bitwise(_lane(batch, i), want_b[i], f"D=2 batch lane {i}")
            _assert_bitwise(futs[i].result(timeout=RESULT_TIMEOUT),
                            want_b[i].map(torch.Tensor.cpu), f"D=2 submit {i}")
        stats, pre_stats = r.stats(), pre.stats()
        assert (r.scene_shards, pre.scene_shards, r.cfg.feature_gather) == (2, 2, "index")
        assert pre_stats["scene_shards"] == 2 and pre_stats["feature_gather"] == "index"
    jr = jax_engine.open(jax_scene, JRenderConfig(**CFG_KW), scene_shards=2)
    try:
        jstats = jr.stats()
        assert (r.scene_shards, r.tile_params) == (jr.scene_shards, jr.tile_params)
        for key in ("scene_shards", "physical_shards", "feature_gather", "tile_params",
                    "scene_mb_per_device", "feature_mb_per_device"):
            assert stats[key] == jstats[key], key
    finally:
        jr.close()


@pytest.mark.parametrize("shards", [1, 3])
def test_handle_properties_match_jax(jax_scene, scene, shards):
    """scene_shards and tile_params: the committed shard count and
    (tile, group, tile_capacity), as the JAX handle reports them."""
    from repro import engine as jax_engine
    from repro.core.pipeline import RenderConfig as JRenderConfig

    kw = dict(CFG_KW, tile=8, group=32, tile_capacity=128)
    jr = jax_engine.open(jax_scene, JRenderConfig(**kw), scene_shards=shards)
    try:
        with _open(scene, RenderConfig(**kw), scene_shards=shards) as r:
            assert (r.scene_shards, r.tile_params) == (jr.scene_shards, jr.tile_params)
            assert r.tile_params == (8, 32, 128) and r.scene_shards == shards
            assert r.stats()["tile_params"] == jr.stats()["tile_params"]
    finally:
        jr.close()


def test_render_cache_covers_scene_layout(scene):
    """render_cache_clear()/render_cache_info() cover the scene-layout
    cache: hits and misses per (scene, D), and a clear drops it."""
    from repro_torch.serving.sharded import shard_scene_cached

    render_cache_clear()
    info = render_cache_info()
    assert (info["scene_layout"]["hits"], info["scene_layout"]["misses"]) == (0, 0)
    a = shard_scene_cached(scene, 2)
    b = shard_scene_cached(scene, 2)    # hit: same scene, same layout
    shard_scene_cached(scene, 4)        # miss: another shard count
    assert a is b and a.shards.means3d.device.type == "cpu"
    info = render_cache_info()["scene_layout"]
    assert (info["hits"], info["misses"], info["currsize"]) == (1, 2, 2)
    render_cache_clear()
    info = render_cache_info()["scene_layout"]
    assert (info["hits"], info["misses"], info["currsize"]) == (0, 0, 0)


def test_sharded_handle_close_empties_registry(scene, cfg):
    """A D = 2 handle stages one host layout; close() releases it with the
    handle's renderer cache, so the registry is empty afterwards."""
    render_cache_clear()
    cam = _cam()
    r = _open(scene, dataclasses.replace(cfg, scene_shards=2))
    r.render(cam)
    name = r.cache_name
    info = render_cache_info()
    assert info[name]["currsize"] == 1 and info["scene_layout"]["currsize"] == 1
    r.close()
    info = render_cache_info()
    assert name not in info
    assert sum(k["currsize"] for k in info.values()) == 0, info
    with pytest.raises(RuntimeError, match="closed"):
        r.render(cam)
    r.close()                           # idempotent


def test_close_releases_only_own_layout(scene, cfg):
    """close() releases exactly the handle's own (scene, D) reference; an
    unreferenced layout of the same scene stays until it is evicted."""
    from repro_torch.serving.sharded import evict_scene_layouts, shard_scene_cached

    render_cache_clear()
    r = _open(scene, cfg, scene_shards=2)
    shard_scene_cached(scene, 3)        # a second, unreferenced layout
    assert evict_scene_layouts(scene) == 1          # the handle's survives
    shard_scene_cached(scene, 3)
    assert render_cache_info()["scene_layout"]["currsize"] == 2
    r.close()
    assert render_cache_info()["scene_layout"]["currsize"] == 1
    assert evict_scene_layouts(scene) == 1
    assert render_cache_info()["scene_layout"]["currsize"] == 0


def test_close_keeps_layout_shared_with_other_open_handle(scene, cfg):
    """Two handles on one scene share one layout: closing one keeps it for
    the other, which still renders; the last close drops it."""
    render_cache_clear()
    cam = _cam()
    a = _open(scene, cfg, scene_shards=2)
    b = _open(scene, cfg, scene_shards=2)
    assert render_cache_info()["scene_layout"] == {
        "hits": 1, "misses": 1, "currsize": 1, "maxsize": 16}
    a.close()
    assert render_cache_info()["scene_layout"]["currsize"] == 1
    _assert_bitwise(b.render(cam), pipeline.render(scene, cam, cfg), "survivor")
    b.close()
    assert render_cache_info()["scene_layout"]["currsize"] == 0


def test_layout_cache_fifo_skips_referenced_and_follows_scene_gc(scene, cfg):
    """Past its 16 layouts the cache drops the oldest unreferenced entries
    first and keeps a layout an open handle holds; a scene that is garbage
    collected takes its layouts with it."""
    from repro_torch.serving import sharded

    render_cache_clear()
    with _open(scene, cfg, scene_shards=2):
        scenes = [dataclasses.replace(scene) for _ in range(sharded._LAYOUT_CACHE_MAX)]
        for s in scenes:
            sharded.shard_scene_cached(s, 2)
        info = render_cache_info()["scene_layout"]
        assert info["currsize"] == sharded._LAYOUT_CACHE_MAX
        assert (id(scene), 2) in sharded._layout_cache           # referenced: kept
        assert (id(scenes[0]), 2) not in sharded._layout_cache   # oldest free: dropped
        del s, scenes
        gc.collect()
        assert list(sharded._layout_cache) == [(id(scene), 2)]
    assert render_cache_info()["scene_layout"]["currsize"] == 0


# -- the futures contract --------------------------------------------------------


def test_submit_failure_resolves_future_exception(scene, cfg):
    """A request the dispatch cannot render resolves ITS future with the
    exception; the worker lives on, and the next submit is bitwise equal to
    render (the check that the JAX package's vmapped batch fails)."""
    bad_cam = SimpleNamespace(
        width=64, height=64, znear=0.2, zfar=1000.0,
        R=np.zeros((2, 2), np.float32), t=np.zeros((3,), np.float32),
        fx=60.0, fy=60.0, cx=32.0, cy=32.0,
    )
    good_cam = _cam()
    with _open(scene, cfg, max_batch=1, max_wait=0.0) as r:
        bad = r.submit(bad_cam)
        with pytest.raises(Exception):
            bad.result(timeout=RESULT_TIMEOUT)
        good = r.submit(good_cam)
        expect = r.render(good_cam)
        _assert_bitwise(good.result(timeout=RESULT_TIMEOUT), expect, "submit after a failure")
        assert r.stats()["completed"] == 1


def test_cancelled_future_does_not_kill_worker(scene, cfg):
    cams = camera.orbit_cameras(3, 4.5, 64, 64)
    with _open(scene, cfg, max_batch=3, max_wait=30.0) as r:
        futs = [r.submit(c) for c in cams[:2]]
        cancelled = futs[0].cancel()     # still pending in the scheduler
        r.submit(cams[2])                # fills the bucket -> dispatch
        sibling = futs[1].result(timeout=RESULT_TIMEOUT)
        assert cancelled and futs[0].cancelled()
        assert torch.equal(sibling.image, r.render(cams[1]).image)
        fut = r.submit(cams[0])
        r.flush(timeout=RESULT_TIMEOUT)
        assert fut.result(timeout=RESULT_TIMEOUT) is not None


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_crash_fails_outstanding_futures(scene, cfg):
    with _open(scene, cfg, max_batch=2, max_wait=30.0) as r:
        def bad_add(req):
            raise RuntimeError("scheduler exploded")

        r._scheduler.add = bad_add
        fut = r.submit(_cam())
        with pytest.raises(RuntimeError, match="scheduler exploded"):
            fut.result(timeout=RESULT_TIMEOUT)


def test_close_fails_futures_the_worker_never_resolved(scene, cfg):
    r = _open(scene, cfg, max_batch=2, max_wait=30.0)
    r._ensure_worker = lambda: None        # a worker that never runs
    fut = r.submit(_cam())
    r.close()
    with pytest.raises(RuntimeError, match="closed before the request"):
        fut.result(timeout=RESULT_TIMEOUT)


# -- what is not ported yet --------------------------------------------------------


@pytest.mark.parametrize("option,item", [
    pytest.param(dict(devices=["cpu", "cpu"]), None, id="option0-ported"),
    pytest.param(dict(mesh=(1, 2)), None, id="option1-ported"),
    pytest.param(dict(tile_params="auto"), None, id="option2-ported"),
    pytest.param(dict(autotune_opts={}), None, id="option3-ported"),
    pytest.param(dict(residency="shared"), None, id="option4-ported"),
])
def test_unported_open_options_raise(scene, cfg, option, item, tmp_path, monkeypatch):
    """Every open() option of the JAX handle is ported. ``devices=`` and
    ``mesh=`` (once unported, item 8) commit over a mesh of virtual CPU
    devices: two data rows, or a (1, 2) mesh with two physical shards under
    the psum gather, each rendering bitwise like one device; ``devices=2``
    names cards, so without CUDA it raises, and ``device`` with ``mesh``
    raises. ``tile_params='auto'`` (once unported, item 11) tunes at the
    first render and renders bitwise like an open with the tuned triple
    fixed; ``autotune_opts`` alone changes nothing. ``residency=`` (once
    unported, item 11) commits through the shared manager: two handles over
    one scene share one entry and one device copy, and render bitwise like
    a private handle."""
    assert item is None
    if "devices" in option or "mesh" in option:
        from repro_torch.launch.mesh import make_render_mesh

        cams = [_cam(), _cam((1.5, 0.8, 4.0)), _cam((-1.0, 1.2, 4.2))]
        with _open(scene, cfg) as one:
            want = one.render_batch(cams)
        if "mesh" in option:
            data, model = option["mesh"]
            mesh = make_render_mesh(["cpu"] * (data * model), scene_shards=model)
            r = engine.open(scene, cfg, mesh=mesh, scene_shards=model)
            with pytest.raises(ValueError, match="not more than one"):
                engine.open(scene, cfg, device="cpu", mesh=mesh)
        else:
            r = engine.open(scene, cfg, **option)
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="CUDA"):
                    engine.open(scene, cfg, devices=2)
        with r:
            _assert_bitwise(r.render_batch(cams), want, f"mesh {r.stats()['mesh']}")
            _assert_bitwise(r.render(cams[1]), _lane(want, 1), "mesh render")
            phys = r.stats()["physical_shards"]
            assert r.stats()["feature_gather"] == ("psum" if phys > 1 else "flat")
        return
    if "residency" not in option:
        from repro_torch.autotune import cache as at_cache

        monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
        at_cache._clear()
        opts = dict(tiles=(16,), group_factors=(2, 4), capacities=(256,),
                    top_k=1, warmup=1, reps=1)
        cam = _cam()
        with _open(scene, cfg, **dict(option, autotune_opts=opts)) as r:
            out = r.render(cam)
            tuned = r.tile_params
        if "tile_params" in option:
            assert tuned in ((16, 32, 256), (16, 64, 256))
        else:
            assert tuned == (cfg.tile, cfg.group, cfg.tile_capacity)
        with _open(scene, cfg, tile_params=tuned) as fixed:
            _assert_bitwise(out, fixed.render(cam), "tuned vs fixed")
        at_cache._clear()
        return
    from repro_torch.residency import ResidencyManager

    mgr = ResidencyManager()
    cam = _cam()
    base = dataclasses.replace(cfg, mode="tile_baseline")
    with _open(scene, cfg, residency=mgr) as a, _open(scene, base, residency=mgr) as b, \
            _open(scene, cfg) as private:
        assert a._res_entry is b._res_entry and mgr.stats()["entries"] == 1
        assert a.committed_scene.means3d is b.committed_scene.means3d
        _assert_bitwise(a.render(cam), private.render(cam), "shared manager")
    assert mgr.stats()["entries"] == 0


def test_unported_entry_points_raise(scene, cfg, default_handles):
    """open_stream (once unported, item 11) opens a stream whose frames are
    bitwise the handle's render. The default handle and the shim over a
    mesh (once unported, item 8) commit over it: a (2, 2) mesh of virtual
    CPU devices renders bitwise like the one-device handle."""
    from repro_torch.launch.mesh import make_render_mesh
    from repro_torch.serving.sharded import render_batch_sharded

    cam = _cam()
    with _open(scene, cfg) as r:
        with r.open_stream(speculate=False) as s:
            _assert_bitwise(s.render(cam), r.render(cam), "stream frame")
            _assert_bitwise(s.render(cam), r.render(cam), "stream hit")
            assert (s.stats()["hits"], s.stats()["misses"]) == (1, 1)
        want = r.render_batch([cam, _cam((1.5, 0.8, 4.0))])
    mesh = make_render_mesh(["cpu"] * 4, scene_shards=2)
    two = dataclasses.replace(cfg, scene_shards=2)
    handle = engine.default_renderer(scene, two, mesh=mesh)
    assert engine.default_renderer(scene, two, mesh=mesh) is handle
    assert handle.mesh == mesh and handle.stats()["physical_shards"] == 2
    _assert_bitwise(_lane(handle.render_batch([cam]), 0), _lane(want, 0), "default handle")
    with pytest.warns(DeprecationWarning, match="render_batch_sharded"):
        out = render_batch_sharded(scene, [cam, _cam((1.5, 0.8, 4.0))], cfg, mesh=mesh,
                                   scene_shards=2)
    _assert_bitwise(out, want, "render_batch_sharded(mesh=)")
    with pytest.raises(TypeError, match="unexpected"):
        _open(scene, cfg, max_batchh=2)


# -- the deprecated free functions and the module-default handles -----------------


@pytest.fixture()
def default_handles():
    """Both packages' module-default handles closed after the test."""
    from repro import engine as jax_engine

    yield
    engine.close_default_renderers()
    jax_engine.close_default_renderers()


def _shim_calls(scene, cam, cfg, pkg):
    """(name, call) for each deprecated free function of ``pkg``'s modules;
    each call returns a RenderResult-like (image, stats) pair."""
    pipe, sharded = pkg
    return [
        ("render_jit", lambda: pipe.render_jit(scene, cam, cfg)),
        ("render_image", lambda: SimpleNamespace(image=pipe.render_image(scene, cam, cfg),
                                                 stats=None)),
        ("render_batch_sharded", lambda: sharded.render_batch_sharded(
            scene, [cam], cfg, pad_to=2)),
    ]


@pytest.mark.filterwarnings("always::DeprecationWarning")
def test_shims_warn_once_and_match_jax_shims(jax_scene, scene, cfg, default_handles,
                                            single_thread):
    """Each shim warns exactly once per call, attributed to its caller
    (stacklevel 2), and matches the JAX package's shim: images within
    tolerance, counters identical."""
    import warnings

    import repro.core.pipeline as jax_pipeline
    import repro.serving.sharded as jax_sharded
    from repro.core import make_camera as jax_make_camera
    from repro_torch.serving import sharded

    jcfg = JConfig(**CFG_KW)
    jcam = jax_make_camera((0.0, 1.0, 4.5), (0, 0, 0), 64, 64)
    port = _shim_calls(scene, _cam(), cfg, (pipeline, sharded))
    ref = _shim_calls(jax_scene, jcam, jcfg, (jax_pipeline, jax_sharded))
    for (name, call), (_, jax_call) in zip(port, ref):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = call()
        deps = [w for w in caught if issubclass(w.category, DeprecationWarning)]
        assert len(deps) == 1 and name in str(deps[0].message), [str(w.message) for w in deps]
        assert deps[0].filename == __file__
        with pytest.warns(DeprecationWarning, match=name):
            want = jax_call()
        image = got.image[0] if name == "render_batch_sharded" else got.image
        np.testing.assert_allclose(
            n(image), np.asarray(want.image[0] if name == "render_batch_sharded"
                                 else want.image), **IMAGE_TOL)
        if got.stats is not None:
            if name == "render_batch_sharded":
                assert got.image.shape[0] == 1
                port_stats = {k: int(getattr(got.stats, k)[0]) for k in INT_COUNTERS}
                want_stats = SimpleNamespace(**{k: np.asarray(getattr(want.stats, k))[0]
                                                for k in INT_COUNTERS})
            else:
                port_stats, want_stats = got.stats.as_dict(), want.stats
            assert_counters_equal(port_stats, want_stats)


def test_internal_shim_callers_error_under_suite_filters(scene, cfg, default_handles,
                                                         single_thread):
    """The suite's ``error::DeprecationWarning:repro`` filter also matches
    ``repro_torch``: a shim call attributed to a module of the port raises,
    so no module of the port can come to call a shim."""
    import textwrap
    import types

    mod = types.ModuleType("repro_torch._filter_selftest")
    exec(compile(textwrap.dedent("""
        def call(scene, cam, cfg):
            from repro_torch.core.pipeline import render_jit
            return render_jit(scene, cam, cfg)
    """), "repro_torch/_filter_selftest.py", "exec"), mod.__dict__)
    with pytest.raises(DeprecationWarning, match="render_jit"):
        mod.call(scene, _cam(), cfg)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_shims_share_one_default_handle(scene, cfg, default_handles, single_thread):
    """Repeated shim calls with one (scene, cfg) ride one default handle,
    committed on the scene's device: the second camera of a resolution is a
    cache hit. close_default_renderers closes it."""
    from repro_torch.serving.sharded import render_batch_sharded

    cams = [_cam(), _cam((1.5, 0.8, 4.0))]
    pipeline.render_jit(scene, cams[0], cfg)
    handle = engine.default_renderer(scene, cfg)
    assert handle.stats()["device"] == "cpu"
    before = handle.cache_info()
    out = pipeline.render_jit(scene, cams[1], cfg)
    image = pipeline.render_image(scene, cams[1], cfg)
    assert engine.default_renderer(scene, cfg) is handle
    after = handle.cache_info()
    assert (after["hits"], after["misses"]) == (before["hits"] + 2, before["misses"])
    want = pipeline.render(scene, cams[1], cfg)
    assert torch.equal(out.image, want.image) and torch.equal(image, want.image)
    assert out.stats.as_dict() == want.stats.as_dict()
    batch = render_batch_sharded(scene, cams, cfg)
    assert engine.default_renderer(scene, cfg) is handle
    _assert_bitwise(_lane(batch, 1), want, "render_batch_sharded lane")
    engine.close_default_renderers()
    assert handle.closed
    assert engine.default_renderer(scene, cfg) is not handle


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_render_batch_sharded_logical_shards(scene, cfg, default_handles, single_thread):
    """scene_shards=3 on one device (the JAX package's logical fallback):
    the lanes equal the replicated render_batch bit for bit, the default
    handle commits 3 shards, and a pre-sharded scene keeps its own D."""
    from repro_torch.serving.sharded import render_batch_sharded
    from repro_torch.sharding import shard_scene_host

    cams = camera.orbit_cameras(2, 4.5, 64, 64)
    rep = render_batch(scene, cams, cfg)
    out = render_batch_sharded(scene, cams, dataclasses.replace(cfg, scene_shards=3))
    _assert_bitwise(out, rep, "scene_shards=3")
    assert engine.default_renderer(scene, dataclasses.replace(cfg, scene_shards=3)
                                   ).scene_shards == 3
    out = render_batch_sharded(scene, cams, cfg, scene_shards=2, pad_to=4)
    _assert_bitwise(out, rep, "scene_shards=2 pad_to=4")
    hosted = shard_scene_host(scene, 3)
    _assert_bitwise(render_batch_sharded(hosted, cams, cfg), rep, "pre-sharded")
    assert engine.default_renderer(hosted, dataclasses.replace(cfg, scene_shards=3)
                                   ).scene_shards == 3


def test_default_handles_fifo_and_finalizer(scene, cfg, default_handles, single_thread):
    """At most 32 default handles: the oldest is evicted and closed; a
    handle whose scene is collected is dropped and closed."""
    from repro_torch.engine import handle as handle_mod

    handles = [engine.default_renderer(scene, dataclasses.replace(cfg, span=4 + i))
               for i in range(handle_mod._DEFAULT_MAX)]
    assert not any(h.closed for h in handles)
    extra = engine.default_renderer(scene, dataclasses.replace(cfg, span=100))
    assert handles[0].closed and not any(h.closed for h in handles[1:]) and not extra.closed
    assert len(handle_mod._default_handles) == handle_mod._DEFAULT_MAX
    engine.close_default_renderers()
    assert all(h.closed for h in handles + [extra]) and not handle_mod._default_handles
    temp = dataclasses.replace(scene)      # same tensors, a new scene object
    h = engine.default_renderer(temp, cfg)
    assert len(handle_mod._default_handles) == 1
    del temp
    gc.collect()
    assert h.closed and not handle_mod._default_handles


# -- the serving primitives (the pure cases of tests/test_serving.py) -------------


def _req(i, w=128, cfg="cfg-a", scene_id="scene-a"):
    return RenderRequest(i, scene_id, SimpleNamespace(width=w, height=128, znear=0.2,
                                                      zfar=1000.0), cfg)


def test_queue_fifo_depth_and_backpressure():
    before = get_registry().counter("queue.rejected_total").value
    q = RequestQueue(maxsize=2, clock=lambda: 42.0)
    q.put_nowait(_req(0))
    q.put_nowait(_req(1))
    with pytest.raises(QueueFull):
        q.put_nowait(_req(2))
    assert not q.try_put(_req(2))
    assert not q.put(_req(2), timeout=0.0)
    assert (q.accepted, q.rejected) == (2, 3)
    assert get_registry().counter("queue.rejected_total").value == before + 3
    got = q.drain()
    assert [r.request_id for r in got] == [0, 1] and got[0].enqueue_time == 42.0
    assert q.get_batch(timeout=0.0) == []


def test_bucketing_flush_on_max_batch_and_max_wait():
    sched = BucketingScheduler(max_batch=3, max_wait=10.0, clock=lambda: 0.0)
    assert sched.add(_req(0)) == [] and sched.add(_req(1)) == []
    (bucket,) = sched.add(_req(2))
    assert [r.request_id for r in bucket.requests] == [0, 1, 2] and sched.pending == 0
    sched = BucketingScheduler(max_batch=100, max_wait=0.05)
    sched.add(_req(0), now=1.0)
    sched.add(_req(1), now=1.03)
    assert sched.poll(now=1.04) == []
    (bucket,) = sched.poll(now=1.05)
    assert len(bucket) == 2


def test_bucketing_signature_isolation():
    sched = BucketingScheduler(max_batch=2, max_wait=10.0, clock=lambda: 0.0)
    sched.add(_req(0, w=128))
    sched.add(_req(1, w=256))
    sched.add(_req(2, cfg="cfg-b"))
    sched.add(_req(3, scene_id="scene-b"))
    assert sched.pending == 4
    (bucket,) = sched.add(_req(4, w=256))
    assert {r.request_id for r in bucket.requests} == {1, 4}
    assert sorted(len(b) for b in sched.flush_all()) == [1, 1, 1]


def test_padding_round_trip():
    assert [padded_size(1, 4), padded_size(4, 4), padded_size(5, 4)] == [4, 4, 8]
    for k, m in [(1, 1), (3, 2), (5, 4), (9, 8)]:
        idx = pad_indices(k, m)
        assert len(idx) % m == 0 and idx[:k] == list(range(k))
        assert all(i == k - 1 for i in idx[k:])
    assert pad_indices_to(3, 8)[3:] == [2] * 5
    with pytest.raises(ValueError):
        pad_indices_to(5, 3)


def test_pure_layers_import_without_torch():
    """obs, the queue and the bucketing scheduler are pure Python: the
    admission layer imports anywhere without a device stack."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import repro_torch.obs, repro_torch.serving.queue, repro_torch.serving.bucketing\n"
        "bad = [m for m in ('torch', 'jax', 'repro') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    subprocess.run([sys.executable, "-c", code], check=True, env={"PYTHONPATH": str(src)},
                   timeout=60)
