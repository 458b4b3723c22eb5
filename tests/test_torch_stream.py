"""The port's stream sessions (repro_torch.engine.stream) against the JAX
package's (tests/test_stream.py), on the CPU with a tiny scene at 64x64:

  * pose_key bytes equal the JAX key's for float32 and float64 cameras,
    and predict_next_camera is bitwise the JAX one;
  * a stream lapping an orbit returns every frame bitwise like the handle's
    render (both backends, one and two shards), and within IMAGE_TOL of the
    JAX stream's frames with equal counters;
  * pose_key is injective and stable; a mid-stream resolution bump
    invalidates the cache; the speculation queue is bounded and a
    float32-exact dolly gives speculative hits, bitwise;
  * close() stops the worker and empties the render-cache registry, also
    when the handle closes first.

Every wait on the speculation worker has a timeout.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import engine as jax_engine
from repro.core import make_camera as jax_make_camera
from repro.core import orbit_cameras as jax_orbit_cameras
from repro.core import random_scene as jax_random_scene
from repro.core.pipeline import RenderConfig as JConfig
from repro.engine.stream import pose_key as jax_pose_key
from repro.engine.stream import predict_next_camera as jax_predict_next_camera
from repro_torch import engine
from repro_torch.core.camera import make_camera, orbit_cameras
from repro_torch.core.gaussians import scene_from_numpy
from repro_torch.core.pipeline import (
    RenderConfig,
    render,
    render_backend,
    render_cache_clear,
    render_cache_info,
    render_frontend,
)
from repro_torch.engine import pose_key, predict_next_camera
from repro_torch.obs import get_registry
from torch_parity import IMAGE_TOL, n, single_thread  # noqa: F401

CFG_KW = dict(tile=16, group=64, group_capacity=256, tile_capacity=256)
SPEC_TIMEOUT = 120.0


@pytest.fixture(scope="module")
def jax_scene():
    return jax_random_scene(jax.random.key(1), 200, extent=2.5)


@pytest.fixture(scope="module")
def scene(jax_scene):
    return scene_from_numpy(jax_scene, "cpu")


@pytest.fixture()
def cfg():
    return RenderConfig(**CFG_KW)


def _open(scene, cfg, **kw):
    return engine.open(scene, cfg, device="cpu", **kw)


def _assert_bitwise(a, b, what):
    assert torch.equal(a.image, b.image), f"{what}: image diverges"


def _dolly_cameras(n, step=0.25, w=64, h=64, make=make_camera):
    """A constant-rotation dolly whose translation steps are exactly
    representable in float32: the path the constant-velocity predictor must
    extrapolate bit-exactly."""
    base = make((0.0, 1.0, 4.5), (0, 0, 0), w, h)
    out = []
    for i in range(n):
        t = base.t.astype(np.float32) + np.float32(i) * np.array([0.0, 0.0, step], np.float32)
        out.append(dataclasses.replace(base, t=t))
    return out


# -- split parity ----------------------------------------------------------------


def test_core_split_matches_fused_render(scene, cfg, single_thread):
    cam = make_camera((0.0, 1.0, 4.5), (0, 0, 0), 64, 64)
    fused = render(scene, cam, cfg)
    split = render_backend(render_frontend(scene, cam, cfg), cam, cfg)
    assert torch.equal(split.image, fused.image)
    assert split.stats.as_dict() == fused.stats.as_dict()


# -- against the JAX package --------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pose_key_bytes_equal_jax(dtype):
    """The same camera, with float32 or float64 pose arrays, gives the JAX
    package's key bytes (both collapse float64 to float32)."""
    for eye in ((0.0, 1.0, 4.5), (1.3, -0.7, 3.1), (-2.0, 0.4, 5.5)):
        ours = make_camera(eye, (0, 0, 0), 64, 48)
        theirs = jax_make_camera(eye, (0, 0, 0), 64, 48)
        ours = dataclasses.replace(ours, R=ours.R.astype(dtype), t=ours.t.astype(dtype))
        theirs = dataclasses.replace(theirs, R=np.asarray(theirs.R, dtype),
                                     t=np.asarray(theirs.t, dtype))
        assert pose_key(ours) == jax_pose_key(theirs)


def test_predict_next_camera_bitwise_equal_jax():
    """Dolly, orbit and intrinsics-changing transitions: every field of the
    port's prediction is bitwise the JAX package's."""
    ours = orbit_cameras(3, 4.5, 64, 64) + _dolly_cameras(3)
    theirs = jax_orbit_cameras(3, 4.5, 64, 64) + _dolly_cameras(3, make=jax_make_camera)
    zoom = [dataclasses.replace(c, fx=c.fx * 1.1, cx=c.cx + 0.5) for c in (ours[0], theirs[0])]
    pairs = [(0, 1), (1, 2), (3, 4), (4, 5), (0, 3)]
    cases = [(ours[a], ours[b], theirs[a], theirs[b]) for a, b in pairs]
    cases.append((ours[1], zoom[0], theirs[1], zoom[1]))
    for o0, o1, t0, t1 in cases:
        po, pt = predict_next_camera(o0, o1), jax_predict_next_camera(t0, t1)
        assert np.asarray(po.R).tobytes() == np.asarray(pt.R).tobytes()
        assert np.asarray(po.t).tobytes() == np.asarray(pt.t).tobytes()
        for f in ("fx", "fy", "cx", "cy"):
            assert np.float32(getattr(po, f)).tobytes() == np.float32(getattr(pt, f)).tobytes()
        assert pose_key(po) == jax_pose_key(pt)


def test_stream_frames_match_jax_stream(jax_scene, scene, single_thread):
    """The same two laps of a 4-pose orbit through a port stream and a JAX
    stream (no speculation): frames within IMAGE_TOL, the render counters
    and the stream counters equal."""
    cams = orbit_cameras(4, 4.5, 64, 64)
    jcams = jax_orbit_cameras(4, 4.5, 64, 64)
    with jax_engine.open(jax_scene, JConfig(**CFG_KW)) as jr, \
            jr.open_stream(speculate=False) as js:
        want = [js.render(c) for c in jcams + jcams]
        jstats = js.stats()
    with _open(scene, RenderConfig(**CFG_KW)) as r, r.open_stream(speculate=False) as s:
        got = [s.render(c) for c in cams + cams]
        stats = s.stats()
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(n(a.image), np.asarray(b.image), **IMAGE_TOL,
                                   err_msg=f"frame {i}")
        for name, value in a.stats.as_dict().items():
            assert value == int(np.asarray(getattr(b.stats, name))), (i, name)
    for k in ("frames", "hits", "misses", "spec_runs", "invalidations"):
        assert stats[k] == jstats[k], k
    assert (stats["hits"], stats["misses"]) == (4, 4)


# -- within the port --------------------------------------------------------------


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("shards", [1, 2])
def test_stream_bitwise_vs_stateless(scene, backend, shards, single_thread):
    """A stream lapping a 4-pose orbit twice returns every frame bitwise like
    the handle's render; lap 2 comes from the exact-reuse cache. The cuda
    backend runs its kernels' plain versions on the CPU."""
    cfg = RenderConfig(backend=backend, scene_shards=shards, **CFG_KW)
    cams = orbit_cameras(4, 4.5, 64, 64)
    with _open(scene, cfg) as r, r.open_stream() as s:
        for lap in range(2):
            for i, cam in enumerate(cams):
                _assert_bitwise(s.render(cam), r.render(cam),
                                f"lap {lap} frame {i} ({backend}, D={shards})")
        assert s.wait_spec_idle(timeout=SPEC_TIMEOUT)
        stats = s.stats()
    assert stats["frames"] == 8
    assert stats["hits"] == 4, f"lap 2 should be all hits: {stats}"
    assert stats["misses"] == 4


def test_mid_stream_resolution_bump_invalidates(scene, cfg, single_thread):
    cam_lo = make_camera((0.0, 1.0, 4.5), (0, 0, 0), 64, 64)
    cam_hi = make_camera((0.0, 1.0, 4.5), (0, 0, 0), 96, 96)
    with _open(scene, cfg) as r, r.open_stream() as s:
        s.render(cam_lo)
        s.render(cam_lo)
        info = s.cache_info()
        assert (info["hits"], info["misses"], info["currsize"]) == (1, 1, 1)
        out_hi = s.render(cam_hi)
        assert s.stats()["invalidations"] == 1
        assert s.cache_info()["currsize"] == 1
        _assert_bitwise(out_hi, r.render(cam_hi), "post-bump frame")
        s.render(cam_lo)
        assert s.stats()["invalidations"] == 2
        assert s.cache_info()["misses"] == 3
        assert s.wait_spec_idle(timeout=SPEC_TIMEOUT)


finite = st.floats(min_value=-8.0, max_value=8.0, allow_nan=False, width=32)


@settings(max_examples=50, deadline=None)
@given(
    eye_a=st.tuples(finite, finite, st.floats(min_value=2.0, max_value=8.0, width=32)),
    eye_b=st.tuples(finite, finite, st.floats(min_value=2.0, max_value=8.0, width=32)),
    fx=st.floats(min_value=10.0, max_value=500.0, width=32),
    w=st.sampled_from([32, 64, 96]),
)
def test_pose_key_property(eye_a, eye_b, fx, w):
    """Stable on rebuilt bit-identical cameras, injective on distinct
    float32 poses, and the JAX key's bytes throughout."""
    def cam(eye, make=make_camera):
        return dataclasses.replace(make(eye, (0, 0, 0), w, w), fx=float(np.float32(fx)))

    a, a2, b = cam(eye_a), cam(eye_a), cam(eye_b)
    assert pose_key(a) == pose_key(a2) == jax_pose_key(cam(eye_a, jax_make_camera))
    same_bits = (np.asarray(a.R, np.float32).tobytes() == np.asarray(b.R, np.float32).tobytes()
                 and np.asarray(a.t, np.float32).tobytes() == np.asarray(b.t, np.float32).tobytes())
    if not same_bits:
        assert pose_key(a) != pose_key(b), "injectivity on distinct poses"


def test_pose_key_randomized():
    """500 distinct float32 poses -> 500 distinct keys, a rebuilt camera maps
    to the same key, and swapped fx/fy or width/height never alias."""
    rng = np.random.default_rng(0)
    keys = set()
    for _ in range(500):
        eye = tuple(float(v) for v in rng.uniform(-5, 5, 3))
        cam = make_camera((eye[0], eye[1], abs(eye[2]) + 2.0), (0, 0, 0), 64, 64)
        k = pose_key(cam)
        assert pose_key(dataclasses.replace(cam)) == k
        keys.add(k)
    assert len(keys) == 500, "distinct poses collided"
    base = dataclasses.replace(make_camera((0.0, 1.0, 4.5), (0, 0, 0), 64, 96), fx=50.0, fy=70.0)
    assert pose_key(base) != pose_key(dataclasses.replace(base, fx=70.0, fy=50.0))
    assert pose_key(base) != pose_key(make_camera((0.0, 1.0, 4.5), (0, 0, 0), 96, 64))


def test_predict_next_camera_constant_components():
    c0, c1, c2 = _dolly_cameras(3)
    pred = predict_next_camera(c0, c1)
    assert pose_key(pred) == pose_key(c2), "dolly extrapolation not exact"
    assert np.asarray(pred.R).tobytes() == np.asarray(c1.R).tobytes()
    assert predict_next_camera(c0, dataclasses.replace(c1, width=96, height=96)) is None


def test_spec_queue_bounded_drop_oldest(scene, cfg, single_thread):
    """With the worker parked, the queue never grows past spec_depth and
    each overflow counts one spec_dropped (metric included)."""
    dropped_before = get_registry().counter("spec.dropped_total").value
    with _open(scene, cfg) as r, r.open_stream(spec_depth=2) as s:
        s._ensure_spec_worker = lambda: None   # park the worker
        for cam in _dolly_cameras(8):
            s.render(cam)
            assert len(s._spec_queue) <= s.spec_depth
        stats = s.stats()
    assert stats["spec_dropped"] >= 3, stats
    assert stats["spec_runs"] == 0
    assert get_registry().counter("spec.dropped_total").value - dropped_before >= \
        stats["spec_dropped"]


def test_dolly_speculative_hit_bitwise(scene, cfg, single_thread):
    """On a float32-exact dolly the predictor pre-runs the next pose's
    frontend: frames 2+ arrive as speculative hits, bitwise the render."""
    with _open(scene, cfg) as r, r.open_stream() as s:
        for i, cam in enumerate(_dolly_cameras(6)):
            assert s.wait_spec_idle(timeout=SPEC_TIMEOUT)
            _assert_bitwise(s.render(cam), r.render(cam), f"dolly frame {i}")
        assert s.wait_spec_idle(timeout=SPEC_TIMEOUT)
        stats = s.stats()
    assert stats["spec_hits"] == 4, stats
    assert stats["hits"] == 4 and stats["misses"] == 2, stats
    assert stats["spec_runs"] >= stats["spec_hits"]


def test_speculate_false_runs_nothing(scene, cfg, single_thread):
    with _open(scene, cfg) as r, r.open_stream(speculate=False) as s:
        for cam in _dolly_cameras(4):
            s.render(cam)
        stats = s.stats()
    assert stats["spec_runs"] == 0 and stats["spec_hits"] == 0
    assert stats["misses"] == 4


def test_cache_frames_evicts_lru(scene, cfg, single_thread):
    cams = orbit_cameras(6, 4.5, 64, 64)
    with _open(scene, cfg) as r, r.open_stream(cache_frames=4, speculate=False) as s:
        for cam in cams:
            s.render(cam)
        assert s.cache_info()["currsize"] == 4
        s.render(cams[0])                       # evicted -> miss
        assert s.stats()["misses"] == 7
        s.render(cams[-1])                      # still cached -> hit
        assert s.stats()["hits"] == 1


# -- lifecycle ----------------------------------------------------------------------


def test_stream_close_empties_registry(scene, cfg, single_thread):
    render_cache_clear()
    engine.close_default_renderers()
    cam = make_camera((0.0, 1.0, 4.5), (0, 0, 0), 64, 64)
    r = _open(scene, cfg)
    s = r.open_stream(speculate=False)
    s.render(cam)
    assert render_cache_info()[s.name]["currsize"] == 1
    render_cache_clear()                        # the global clear reaches it
    assert render_cache_info()[s.name]["currsize"] == 0
    s.render(cam)
    s.close()
    assert s.name not in render_cache_info(), "closed stream left its cache registered"
    with pytest.raises(RuntimeError, match="closed"):
        s.render(cam)
    s.close()                                   # idempotent
    r.close()
    info = render_cache_info()
    assert r.cache_name not in info
    assert sum(k["currsize"] for k in info.values()) == 0, info


def test_handle_close_closes_streams(scene, cfg, single_thread):
    """Closing the handle closes every open stream first: no orphaned
    speculation worker, no stale registry entry."""
    r = _open(scene, cfg)
    s1 = r.open_stream()
    s2 = r.open_stream(speculate=False)
    for cam in _dolly_cameras(3):
        s1.render(cam)
    r.close()
    assert s1.closed and s2.closed
    assert s1._spec_thread is None or not s1._spec_thread.is_alive()
    info = render_cache_info()
    assert s1.name not in info and s2.name not in info
    assert sum(k["currsize"] for k in info.values()) == 0


def test_stream_discard_accounting(scene, cfg, single_thread):
    """Unused speculative entries count as discarded when dropped."""
    with _open(scene, cfg) as r, r.open_stream() as s:
        for cam in _dolly_cameras(3):
            s.render(cam)
        assert s.wait_spec_idle(timeout=SPEC_TIMEOUT)
        # the worker pre-ran the frame-3 pose, which is never rendered
        assert s.cache_info()["currsize"] == 4
        s.cache_clear()
        assert s.stats()["spec_discarded"] == 1


@pytest.mark.parametrize("bad", [dict(cache_frames=0), dict(spec_depth=-1)])
def test_stream_rejects_bad_params(scene, cfg, bad):
    with _open(scene, cfg) as r:
        with pytest.raises(ValueError):
            r.open_stream(**bad)


def test_closed_handle_refuses_open_stream(scene, cfg):
    r = _open(scene, cfg)
    r.close()
    with pytest.raises(RuntimeError, match="closed"):
        r.open_stream()
