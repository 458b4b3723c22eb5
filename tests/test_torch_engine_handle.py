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
  * the unported options raise, naming their ROADMAP item;
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
from torch_parity import IMAGE_TOL, assert_counters_equal, n

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
    (dict(devices=2), "item 8"), (dict(mesh=object()), "item 8"),
    (dict(scene_shards=2), "item 8"), (dict(tile_params="auto"), "item 11"),
    (dict(autotune_opts={}), "item 11"), (dict(residency=object()), "item 11"),
])
def test_unported_open_options_raise(scene, cfg, option, item):
    with pytest.raises(NotImplementedError, match=item):
        _open(scene, cfg, **option)


def test_unported_entry_points_raise(scene, cfg):
    from repro_torch.serving.sharded import render_batch_sharded

    cam = _cam()
    with _open(scene, cfg) as r:
        with pytest.raises(NotImplementedError, match="item 11"):
            r.open_stream()
    for fn, args in [
        (engine.default_renderer, (scene, cfg)), (engine.close_default_renderers, ()),
        (pipeline.render_jit, (scene, cam, cfg)), (pipeline.render_image, (scene, cam, cfg)),
        (render_batch_sharded, (scene, [cam], cfg)),
    ]:
        with pytest.raises(NotImplementedError, match="item 6"):
            fn(*args)
    with pytest.raises(TypeError, match="unexpected"):
        _open(scene, cfg, max_batchh=2)


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
