"""The port's serving tier (repro_torch.serving: stats, RenderServer,
poisson_arrivals, the serve CLI) against the JAX package's
(tests/test_serving.py), on the CPU with a tiny scene at 64x64:

  * ServingStats summaries and poisson_arrivals equal the JAX package's on
    the same inputs; percentiles, cache deltas, the bounded latency memory
    and thread-safe folds;
  * a realtime=False server run: bucket signatures, dispatch count, batch
    sizes and padded lanes equal the JAX server's; images within IMAGE_TOL
    of the JAX server's and bitwise equal to the port's Renderer.render;
  * scene-sharded requests, committed-scene sharing across configs,
    backpressure, admission screening, the close-against-commit race;
  * mesh= raises naming its ROADMAP item, autotune= serves the tuned
    triple; importing
    repro_torch.serving imports no torch and starts no CUDA context;
  * the CLI in process on the CPU with --parity-check and a trace that
    passes the port's cross-checks.

Every thread a test starts is joined with a timeout.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import make_camera as jax_make_camera
from repro.core import random_scene as jax_random_scene
from repro.core.pipeline import RenderConfig as JConfig
from repro.serving.queue import RenderRequest as JRequest
from repro.serving.server import RenderServer as JServer
from repro.serving.server import poisson_arrivals as jax_poisson_arrivals
from repro.serving.stats import ServingStats as JServingStats
from repro_torch import engine
from repro_torch.core.camera import make_camera
from repro_torch.core.gaussians import scene_from_numpy
from repro_torch.core.pipeline import RenderConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import (
    RenderRequest,
    RenderServer,
    ServingStats,
    cache_delta,
    percentile,
    poisson_arrivals,
)
from repro_torch.serving.stats import LATENCY_RESERVOIR
from torch_parity import IMAGE_TOL, n, single_thread  # noqa: F401

SRC = str(Path(__file__).resolve().parents[1] / "src")
CFG_KW = dict(tile=16, group=64, group_capacity=256, tile_capacity=256)
JOIN_TIMEOUT = 60


@pytest.fixture(scope="module")
def jax_scene():
    return jax_random_scene(jax.random.key(1), 200, extent=2.5)


@pytest.fixture(scope="module")
def scene(jax_scene):
    return scene_from_numpy(jax_scene, "cpu")


@pytest.fixture()
def cfg():
    return RenderConfig(**CFG_KW)


def _server(scenes, **kw):
    return RenderServer(scenes, device="cpu", **kw)


def _eye(i):
    return (1.5 - 0.2 * i, 1.0, 4.0)


# -- the pure layer: stats and arrivals ------------------------------------------


def _fold(stats):
    stats.record_dispatch(("sig-a",), 3, 4, 0.1, [0.01, 0.02, 0.03],
                          cache_before={"batch": dict(hits=1, misses=2)},
                          cache_after={"batch": dict(hits=3, misses=2), "e0": dict(hits=1)})
    stats.record_dispatch(("sig-a",), 2, 2, 0.1, [0.02, 0.04])
    stats.record_dispatch(("sig-b",), 1, 1, 0.1, [0.05])
    stats.count_rejected()
    stats.count_deadline_miss()
    stats.wall_s = 0.5


def test_stats_summary_equals_jax():
    """The same folds give the JAX ServingStats' summary, bucket dicts and
    formatted text."""
    from repro.obs import MetricsRegistry as JRegistry

    ours, theirs = ServingStats(registry=MetricsRegistry()), JServingStats(registry=JRegistry())
    _fold(ours)
    _fold(theirs)
    assert ours.summary() == theirs.summary()
    assert ours.format() == theirs.format()
    assert json.loads(ours.to_json(x=1)) == json.loads(theirs.to_json(x=1))


def test_poisson_arrivals_equal_jax():
    for n_req, rate, seed in ((16, 8.0, 0), (9, 60.0, 3), (1, 1.0, 7)):
        assert poisson_arrivals(n_req, rate, seed=seed) == jax_poisson_arrivals(
            n_req, rate, seed=seed)


def test_stats_percentiles_and_aggregation():
    assert percentile([], 50) != percentile([], 50)      # nan
    assert percentile([5.0], 99) == 5.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == pytest.approx(2.5)
    stats = ServingStats(registry=MetricsRegistry())
    _fold(stats)
    s = stats.summary()
    assert s["completed"] == 6 and s["batches"] == 3 and s["padded"] == 1
    assert s["fps"] == pytest.approx(12.0)
    assert stats.bucket(("sig-a",)).mean_batch == pytest.approx(2.5)
    assert s["p99_ms"] <= 50.0 + 1e-6
    assert "sig-a" in stats.format()


def test_stats_cache_delta():
    before = {"single": dict(hits=1, misses=2), "batch": dict(hits=0, misses=1)}
    after = {"single": dict(hits=1, misses=2), "batch": dict(hits=3, misses=2)}
    assert cache_delta(before, after) == {"hits": 3, "misses": 1}


def test_stats_latency_memory_is_bounded():
    stats = ServingStats(registry=MetricsRegistry())
    n_req = LATENCY_RESERVOIR + 500
    for _ in range(n_req // 10):
        stats.record_dispatch(("sig",), 10, 10, 0.01, [0.01 * (j + 1) for j in range(10)])
    b = stats.bucket(("sig",))
    assert b.latency.count == b.requests == (n_req // 10) * 10
    assert len(b.latencies_s) == LATENCY_RESERVOIR
    assert len(stats.all_latencies()) == LATENCY_RESERVOIR
    d = b.to_dict()
    assert d["latency_count"] == b.requests and d["latency_sampled"]
    assert 0.01 <= d["p99_ms"] / 1e3 <= 0.1


def test_stats_record_dispatch_thread_safe():
    reg = MetricsRegistry()
    stats = ServingStats(registry=reg)
    threads, per_thread, batch = 8, 50, 4
    barrier = threading.Barrier(threads)

    def fold(k):
        barrier.wait(timeout=JOIN_TIMEOUT)
        for _ in range(per_thread):
            stats.record_dispatch((f"sig-{k % 2}",), batch, batch + 1, 0.001, [0.01] * batch)
            stats.count_rejected()
            stats.count_deadline_miss()

    ts = [threading.Thread(target=fold, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_TIMEOUT)
        assert not t.is_alive()
    total = threads * per_thread
    s = stats.summary()
    assert (s["completed"], s["batches"], s["padded"]) == (total * batch, total, total)
    assert (s["rejected"], s["deadline_misses"]) == (total, total)
    snap = reg.snapshot()
    assert snap["counters"]["serving.requests_total"] == total * batch
    assert snap["histograms"]["serving.latency_s"]["count"] == total * batch


def test_import_touches_no_device():
    """Importing repro_torch.serving imports no torch; importing the server
    and the CLI initialises no CUDA context."""
    code = (
        "import sys\n"
        "import repro_torch.serving, repro_torch.serving.stats\n"
        "assert 'torch' not in sys.modules, 'repro_torch.serving imported torch'\n"
        "import torch, repro_torch.serving.server, repro_torch.launch.render_serve\n"
        "import repro_torch.residency, repro_torch.engine.stream\n"
        "from repro_torch.serving import RenderServer\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"}, timeout=120)


# -- the server against the JAX server ------------------------------------------------


def test_server_no_realtime_matches_jax_server(jax_scene, scene, single_thread):
    """Nine requests at two resolutions through realtime=False: the port's
    buckets (scene, geometry), dispatches, batch sizes and padded lanes equal
    the JAX server's, its images are within IMAGE_TOL of the JAX server's
    and bitwise equal to the port's Renderer.render."""
    res = [(96, 64), (64, 64)]
    jcfg, cfg = JConfig(**CFG_KW), RenderConfig(**CFG_KW)
    jreqs = [JRequest(i, "scene", jax_make_camera(_eye(i), (0, 0, 0), *res[i % 2]), jcfg)
             for i in range(9)]
    reqs = [RenderRequest(i, "scene", make_camera(_eye(i), (0, 0, 0), *res[i % 2]), cfg)
            for i in range(9)]
    jserver = JServer({"scene": jax_scene}, max_batch=3, max_wait=0.0, queue_depth=16)
    try:
        jres = jserver.run([(0.0, r) for r in jreqs], realtime=False)
        jsum = jserver.stats.summary()
        jbuckets = jserver.stats.buckets
    finally:
        jserver.close()
    with _server({"scene": scene}, max_batch=3, max_wait=0.0, queue_depth=16) as server:
        got = server.run([(0.0, r) for r in reqs], realtime=False)
        s = server.stats.summary()
        buckets = server.stats.buckets
        with engine.open(scene, cfg, device="cpu") as h:
            for r in reqs:
                assert torch.equal(got[r.request_id].image, h.render(r.camera).image)

    def geometry(sig):
        return (sig[0],) + tuple(sig[2:])       # all but the package's own config

    def per_bucket(bs):
        return [(geometry(sig), b.requests, b.batches, b.padded) for sig, b in bs.items()]

    assert sorted(got) == sorted(jres) == list(range(9))
    for k in ("completed", "rejected", "batches", "padded"):
        assert s[k] == jsum[k], k
    assert per_bucket(buckets) == per_bucket(jbuckets)
    for i in range(9):
        assert got[i].batch_size == jres[i].batch_size
        assert geometry(got[i].signature) == geometry(jres[i].signature)
        assert got[i].image.device.type == "cpu"
        np.testing.assert_allclose(n(got[i].image), np.asarray(jres[i].image), **IMAGE_TOL)
    assert s["cache_hits"] > 0                  # repeated signatures reused renderers


def test_server_end_to_end_bitwise_render(scene, cfg, single_thread):
    """Mixed resolutions through queue -> bucket -> dispatch with max_wait:
    every request completes bitwise like the handle's render, buckets never
    mix signatures, and the renderer caches see the reuse."""
    res = [(96, 64), (64, 64)]
    reqs = [RenderRequest(i, "scene", make_camera(_eye(i), (0, 0, 0), *res[i % 2]), cfg)
            for i in range(9)]
    with _server({"scene": scene}, max_batch=3, max_wait=0.0, queue_depth=16) as server:
        results = server.run([(0.0, r) for r in reqs], realtime=False)
        assert server.stats.rejected == 0
        with engine.open(scene, cfg, device="cpu") as h:
            for r in reqs:
                got = results[r.request_id]
                assert got.signature == r.signature()
                assert torch.equal(got.image, h.render(r.camera).image)
        s = server.stats.summary()
    assert s["completed"] == 9 and len(server.stats.buckets) == 2
    assert s["cache_hits"] > 0 and np.isfinite(s["p99_ms"]) and s["fps"] > 0


def test_server_scene_sharded_end_to_end(scene, cfg, single_thread):
    """Scene-sharded (logical) and one-shard requests of one scene ride in
    separate buckets and render bitwise alike."""
    cfg_sh = dataclasses.replace(cfg, scene_shards=2)
    cams = [make_camera((1.5 - 0.3 * i, 1.0, 4.0), (0, 0, 0), 64, 64) for i in range(4)]
    reqs = [RenderRequest(i, "scene", c, cfg_sh if i % 2 else cfg) for i, c in enumerate(cams)]
    with _server({"scene": scene}, max_batch=2, max_wait=0.0, queue_depth=16,
                 scene_shards=2) as server:
        results = server.run([(0.0, r) for r in reqs], realtime=False)
        assert sorted(results) == [0, 1, 2, 3]
        assert len(server.stats.buckets) == 2
        with engine.open(scene, cfg, device="cpu") as h:
            for r in reqs:
                assert torch.equal(results[r.request_id].image, h.render(r.camera).image)


def test_server_streams_bitwise_and_padded_lanes(scene, cfg, single_thread):
    """Stream requests go through the stream session one frame per dispatch
    (no padded lanes) and stay bitwise the render; a stateless request in
    the same load pads to max_batch."""
    cams = [make_camera(_eye(i % 3), (0, 0, 0), 64, 64) for i in range(6)]
    load = [(0.0, RenderRequest(i, "scene", c, cfg, stream_id="s0")) for i, c in enumerate(cams)]
    load.append((0.0, RenderRequest(6, "scene", cams[0], cfg)))
    with _server({"scene": scene}, max_batch=4, max_wait=0.0, speculate=False) as server:
        results = server.run(load, realtime=False)
        st = server.stream_stats()
        with engine.open(scene, cfg, device="cpu") as h:
            for _, r in load:
                assert torch.equal(results[r.request_id].image, h.render(r.camera).image)
        s = server.stats.summary()
    (stream,) = st.values()
    assert (stream["frames"], stream["hits"], stream["misses"]) == (6, 3, 3)
    assert s["padded"] == 3 and s["completed"] == 7


def test_server_shares_committed_scene_across_configs(scene, cfg):
    with _server({"scene": scene}) as server:
        a = server.commit("scene", cfg)
        b = server.commit("scene", dataclasses.replace(cfg, mode="tile_baseline"))
        assert a is not b
        assert a.committed_scene.means3d is b.committed_scene.means3d
        assert server.residency.stats()["entries"] == 1


def test_server_backpressure_and_unknown_scene(scene, cfg):
    cam = make_camera((0, 1, 4), (0, 0, 0), 64, 64)
    server = _server({"scene": scene}, queue_depth=1)
    assert server.submit(RenderRequest(0, "scene", cam, cfg))
    assert not server.submit(RenderRequest(1, "scene", cam, cfg))
    assert server.stats.rejected == 1
    with pytest.raises(KeyError):
        server.submit(RenderRequest(2, "nope", cam, cfg))
    server.close()


def test_server_rejects_unservable_scene_shards(scene, cfg, single_thread):
    cam = make_camera((0, 1, 4), (0, 0, 0), 64, 64)
    bad = dataclasses.replace(cfg, scene_shards=4)
    with _server({"scene": scene}, scene_shards=2) as server:
        with pytest.raises(ValueError, match="scene_shards"):
            server.submit(RenderRequest(0, "scene", cam, bad))
        results = server.run([(0.0, RenderRequest(1, "scene", cam, bad)),
                              (0.0, RenderRequest(2, "scene", cam, cfg))], realtime=False)
        assert sorted(results) == [2]
        assert server.stats.rejected == 1


def test_server_unported_options_raise(scene, cfg, tmp_path, monkeypatch):
    """mesh= (once unported, item 8) serves over a mesh of virtual CPU
    devices: a (2, 1) mesh pads each dispatch to the data extent and every
    served image is bitwise the one-device render; device= with mesh=
    raises. autotune= (once unported, item 11) opens the handle with
    tile_params='auto', and the served image is bitwise the render at the
    tuned triple."""
    from repro_torch.launch.mesh import make_render_mesh

    mesh = make_render_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="not both"):
        RenderServer({"scene": scene}, device="cpu", mesh=mesh)
    cams = [make_camera((0, 1, 4), (0, 0, 0), 64, 64), make_camera(_eye(1), (0, 0, 0), 64, 64),
            make_camera(_eye(2), (0, 0, 0), 64, 64)]
    with RenderServer({"scene": scene}, mesh=mesh, max_batch=3) as server:
        served = server.run([(0.0, RenderRequest(i, "scene", c, cfg)) for i, c in enumerate(cams)],
                            realtime=False)
        assert server.mesh is mesh and server.device == torch.device("cpu")
        assert server.stats.summary()["padded"] == 1   # 3 requests, 4 lanes
    with engine.open(scene, cfg, device="cpu") as r:
        for i, c in enumerate(cams):
            assert torch.equal(served[i].image, r.render(c).image)
    from repro_torch.autotune import cache as at_cache

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    at_cache._clear()
    cam = make_camera((0, 1, 4), (0, 0, 0), 64, 64)
    opts = dict(tiles=(16,), group_factors=(2, 4), capacities=(256,), top_k=1,
                warmup=1, reps=1)
    with RenderServer({"scene": scene}, device="cpu", autotune=True,
                      autotune_opts=opts) as server:
        results = server.run([(0.0, RenderRequest(0, "scene", cam, cfg))], realtime=False)
        tuned = server.commit("scene", cfg).tile_params
    at_cache._clear()
    assert isinstance(tuned, tuple)
    with engine.open(scene, cfg, device="cpu", tile_params=tuned) as r:
        assert torch.equal(results[0].image, r.render(cam).image)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            RenderServer({"scene": scene})


def test_server_close_vs_commit_race_leaves_registry_empty(scene, cfg):
    """close() racing commit() never leaks a handle: a commit that wins the
    lock opens a handle close() then closes; one that loses raises."""
    for _attempt in range(3):
        server = _server({"scene": scene})
        handles, barrier = [], threading.Barrier(3)

        def committer():
            barrier.wait(timeout=JOIN_TIMEOUT)
            try:
                handles.append(server.commit("scene", cfg))
            except RuntimeError:
                pass                     # lost the race: commit after close

        threads = [threading.Thread(target=committer) for _ in range(2)]
        for t in threads:
            t.start()
        barrier.wait(timeout=JOIN_TIMEOUT)
        server.close()
        for t in threads:
            t.join(timeout=JOIN_TIMEOUT)
            assert not t.is_alive()
        assert server._renderers == {}, "close() left a handle registered"
        assert all(h.closed for h in handles), "a raced commit leaked"
        assert server.residency.stats()["entries"] == 0
        with pytest.raises(RuntimeError, match="closed"):
            server.commit("scene", cfg)


# -- the CLI -------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    pytest.param(["--requests", "6", "--device-budget-mb", "0.1"], id="stateless-budget"),
    pytest.param(["--streams", "1", "--stream-frames", "18"], id="stream"),
])
def test_render_serve_cli_in_process(tmp_path, capsys, extra, single_thread):
    """python -m repro_torch.launch.render_serve --device cpu --parity-check
    in process: exit 0, every image bitwise the one-shard render, and a
    trace that passes the schema and the residency and stream cross-checks
    against its metrics snapshot."""
    from repro_torch.launch.render_serve import main
    from repro_torch.obs import (
        Tracer,
        set_tracer,
        validate_chrome_trace,
        validate_residency_trace,
        validate_stream_trace,
    )
    from repro_torch.obs.metrics import get_registry

    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    prev = set_tracer(Tracer())
    before = get_registry().snapshot()["counters"]
    try:
        rc = main(["--device", "cpu", "--gaussians", "400", "--resolutions", "64x64",
                   "--max-batch", "3", "--no-realtime", "--parity-check",
                   "--trace-json", str(trace), "--metrics-json", str(metrics), *extra])
    finally:
        set_tracer(prev)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "render_serve: OK" in out and "parity_failures=0" in out
    doc, snap = json.loads(trace.read_text()), json.loads(metrics.read_text())
    # The registry is the process's: hold this run's spans to this run's
    # counter increments.
    counters = {k: v - before.get(k, 0) for k, v in snap["counters"].items()}
    assert validate_chrome_trace(doc) == []
    assert validate_residency_trace(doc, counters) == []
    assert validate_stream_trace(doc, counters) == []
    summary = doc["summary"]
    assert summary["completed"] == len(summary["requests"]) > 0
    if "--streams" in extra:
        assert counters["stream.frames_total"] == 18
        assert counters["stream.hits_total"] >= 2
    else:
        assert counters["residency.evictions_total"] > 0


def test_render_serve_cli_autotune_raises(tmp_path, capsys, monkeypatch, single_thread):
    """--autotune (once unported, item 11): every handle tunes at its first
    dispatch, the CLI names the tuned triples, and --parity-check holds
    each image bitwise to a render at its scene's tuned triple."""
    from repro_torch.autotune import cache as at_cache
    from repro_torch.launch.render_serve import main

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    at_cache._clear()
    try:
        rc = main(["--device", "cpu", "--autotune", "--gaussians", "300",
                   "--resolutions", "64x64", "--requests", "4", "--max-batch", "2",
                   "--no-realtime", "--parity-check"])
    finally:
        at_cache._clear()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert re.search(r"autotuned 'train': tile_params=\(\d+, \d+, \d+\)", out), out
    assert "parity-check: 4/4 bitwise equal" in out
