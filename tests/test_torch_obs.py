"""The port's observability layer and timed-stage rendering (the port of
tests/test_obs.py), on the CPU.

  * The pure layer: ``repro_torch.obs`` imports neither torch nor jax;
    tracer, lanes, ``trace_span``, the validator, request spans, counters,
    gauges, histograms, ``percentile``, the registry and its collectors.
    Where the output is data (the Chrome trace document, the snapshot, the
    Prometheus text) it is held against ``repro.obs`` on the same inputs
    with a manual clock.
  * ``RenderConfig(timing=True)``: image and every counter bitwise those of
    an untimed render (``torch.equal``, ``as_dict()``) on both backends (the
    ``cuda`` backend runs its kernels' plain versions on CPU tensors), in
    every mode, at D = 1, 2 and 3 under each gather, through ``render``,
    the two halves, ``render_batch``, the handle and ``submit``; every
    stage records a ``stage/<name>`` span that ``validate_chrome_trace``
    accepts. Against the JAX package's timed render: counters equal, images
    within atol 5e-6 / rtol 1e-5, the same stage span names.
  * A timed training step gives bitwise the untimed loss and gradients.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.core import make_camera as jax_make_camera
from repro.core import random_scene as jax_random_scene
from repro.core.pipeline import RenderConfig as JConfig
from repro_torch import engine
from repro_torch.core import camera, pipeline
from repro_torch.core.gaussians import SCENE_FIELDS, scene_from_numpy
from repro_torch.core.stages import TimedBackend, get_backend, timed_backend
from repro_torch.obs import (
    REQUEST_PHASES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Tracer,
    emit_request_spans,
    get_tracer,
    percentile,
    set_tracer,
    trace_span,
    validate_chrome_trace,
)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from torch_parity import assert_counters_equal, n, single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")
SRC = str(Path(__file__).resolve().parents[1] / "src")
CFG_KW = dict(tile=16, group=64, group_capacity=256, tile_capacity=256)
STAGES = {"stage/project", "stage/identify", "stage/bin", "stage/bitmask",
          "stage/compact", "stage/rasterize", "stage/render"}
RESULT_TIMEOUT = 60
# The parity contract of the timed render against the JAX package's.
PARITY_TOL = dict(atol=5e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# pure layer
# ---------------------------------------------------------------------------


def test_obs_imports_without_torch_or_jax():
    code = (
        "import sys\n"
        "import repro_torch.obs, repro_torch.obs.trace, repro_torch.obs.metrics\n"
        "bad = [m for m in ('torch', 'jax', 'repro') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": SRC},
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def _manual_clock(start=0.0):
    state = {"t": start}

    def clock():
        return state["t"]

    def advance(dt):
        state["t"] += dt

    clock.advance = advance
    return clock


def _record_nested(tracer_cls):
    """outer(10 ms, inner 5 ms, 1 ms) + a forced span on a lane, on a tracer
    of ``tracer_cls`` with a manual clock; returns the tracer."""
    clock = _manual_clock(100.0)
    tr = tracer_cls(clock=clock, enabled=True)
    with tr.span("outer", category="test", args={"k": 1}):
        clock.advance(0.010)
        with tr.span("inner", category="test"):
            clock.advance(0.005)
        clock.advance(0.001)
    tr.complete("lane-span", 100.002, 100.004, tid=tr.lane_tid("x", "lane x"), force=True)
    return tr


def test_tracer_records_and_exports_chrome():
    tr = _record_nested(Tracer)
    evs = tr.events()
    assert [e.name for e in evs] == ["inner", "outer", "lane-span"]   # completion order
    assert evs[1].duration_s == pytest.approx(0.016)
    doc = tr.chrome_trace()
    assert doc["schema"] == obs_trace.SCHEMA and doc["dropped"] == 0
    assert validate_chrome_trace(doc) == []
    outer = next(e for e in doc["traceEvents"] if e["name"] == "outer")
    assert outer["dur"] == pytest.approx(16000.0)        # us
    assert outer["args"] == {"k": 1}
    mnames = {e["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {"process_name", "thread_name"} <= mnames


def test_chrome_trace_document_matches_jax_package():
    assert _record_nested(Tracer).chrome_trace() == _record_nested(jobs.Tracer).chrome_trace()


def test_tracer_ring_is_bounded():
    tr = Tracer(capacity=4, clock=_manual_clock(), enabled=True)
    for i in range(10):
        tr.complete(f"s{i}", 0.0, 1.0)
    assert len(tr.events()) == 4 and tr.dropped == 6
    assert [e.name for e in tr.events()] == ["s6", "s7", "s8", "s9"]
    assert tr.chrome_trace()["dropped"] == 6
    tr.clear()
    assert tr.events() == [] and tr.dropped == 0


def test_tracer_disabled_records_nothing_unless_forced():
    tr = Tracer(clock=_manual_clock(), enabled=False)
    with tr.span("ambient"):
        pass
    tr.complete("plain", 0.0, 1.0)
    assert tr.events() == []
    tr.complete("forced", 0.0, 1.0, force=True)   # the timed-stage opt-in
    assert [e.name for e in tr.events()] == ["forced"]


def test_trace_span_decorator_resolves_tracer_at_call_time():
    @trace_span("decorated", category="test")
    def f(x):
        return x + 1

    prev = set_tracer(Tracer(clock=_manual_clock(), enabled=True))
    try:
        assert f(1) == 2
        assert [e.name for e in get_tracer().events()] == ["decorated"]
    finally:
        set_tracer(prev)


def test_tracer_thread_lanes():
    """Spans from different threads land on different tids."""
    tr = Tracer(enabled=True)
    barrier = threading.Barrier(4)

    def work():
        barrier.wait(timeout=10)
        with tr.span("t-span"):
            pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    with tr.span("main-span"):
        pass
    assert len({e.tid for e in tr.events()}) == 5
    assert validate_chrome_trace(tr.chrome_trace()) == []


BAD_DOCUMENTS = [
    [],
    {"traceEvents": "nope"},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "ts": 0.0}]},
    {"traceEvents": [{"name": "a", "ph": "B", "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": -1.0}]},
    {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 5.0, "dur": 10.0},
    ]},
]


@pytest.mark.parametrize("doc", BAD_DOCUMENTS)
def test_validate_chrome_trace_catches_bad_documents(doc):
    errs = validate_chrome_trace(doc)
    assert errs and errs == jobs.validate_chrome_trace(doc)


def test_validate_chrome_trace_lanes_are_independent():
    bad = BAD_DOCUMENTS[-1]
    assert any("partially overlaps" in e for e in validate_chrome_trace(bad))
    ok = {"traceEvents": [dict(e, tid=i) for i, e in enumerate(bad["traceEvents"])]}
    assert validate_chrome_trace(ok) == []


def test_emit_request_spans_tiles_the_lifecycle():
    tr = Tracer(clock=_manual_clock(), enabled=True)
    stamps = {"enqueue": 1.0, "batch_form": 1.2, "dispatch": 1.5,
              "device_done": 2.5, "resolve": 2.6}
    emit_request_spans(tr, 7, stamps, args={"scene_id": "train"})
    by_name = {e.name: e for e in tr.events()}
    assert set(by_name) == {"request"} | {name for _, _, name in REQUEST_PHASES}
    assert by_name["request"].duration_s == pytest.approx(1.6)
    assert by_name["request/device"].duration_s == pytest.approx(1.0)
    assert by_name["request"].args["request_id"] == 7
    assert len({e.tid for e in tr.events()}) == 1
    assert validate_chrome_trace(tr.chrome_trace()) == []
    tr.clear()
    emit_request_spans(tr, 8, {"dispatch": 1.0, "device_done": 2.0})
    assert [e.name for e in tr.events()] == ["request/device"]
    off = Tracer(clock=_manual_clock(), enabled=False)
    emit_request_spans(off, 9, stamps)
    assert off.events() == []


def test_counter_and_gauge():
    c = Counter()
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = Gauge()
    g.set(2.5)
    g.set(1.5)
    assert g.value == 1.5


def test_histogram_exact_below_cap():
    h = Histogram(cap=100)
    h.observe_many(float(i) for i in range(1, 11))
    assert h.count == 10 and h.sum == 55.0
    assert (h.min, h.max) == (1.0, 10.0)
    assert not h.sampled
    assert h.percentile(50) == pytest.approx(5.5)
    snap = h.snapshot()
    assert snap["mean"] == pytest.approx(5.5)
    assert snap["reservoir"] == 10 and not snap["sampled"]


def test_histogram_reservoir_matches_jax_package():
    """Bounded memory, exact count/sum/min/max, and the same seeded
    reservoir as the JAX package's on the same stream."""
    h, j = Histogram(cap=64, seed=0), jobs.Histogram(cap=64, seed=0)
    for i in range(10_000):
        h.observe(float(i))
        j.observe(float(i))
    assert len(h.values()) == 64 and h.count == 10_000
    assert h.sum == pytest.approx(sum(range(10_000)))
    assert (h.min, h.max) == (0.0, 9999.0) and h.sampled
    assert h.values() == j.values() and h.snapshot() == j.snapshot()


@pytest.mark.parametrize("values,q", [([], 99), ([1.0, 2.0, 3.0], 50), ([5.0, 1.0], 90),
                                      ([0.5] * 7 + [9.0], 99)])
def test_percentile_matches_jax_package(values, q):
    assert percentile(values, q) == jobs.percentile(values, q)
    if not values:
        assert percentile(values, q) == 0.0


def _registry_session(registry_cls):
    reg = registry_cls()
    reg.counter("serving.requests_total").inc(3)
    reg.gauge("b.level").set(0.5)
    reg.histogram("serving.latency_s").observe_many([0.1, 0.2, 0.5])
    reg.register_collector("t", lambda r: r.gauge("scraped.v").set(2.0))
    return reg


def test_registry_instruments_and_snapshot():
    reg = _registry_session(MetricsRegistry)
    with pytest.raises(TypeError):
        reg.gauge("serving.requests_total")        # kind mismatch
    assert reg.counter("serving.requests_total").value == 3
    snap = reg.snapshot()
    assert snap["schema"] == obs_metrics.SCHEMA
    assert snap["counters"] == {"serving.requests_total": 3}
    assert snap["gauges"] == {"b.level": 0.5, "scraped.v": 2.0}
    assert snap["histograms"]["serving.latency_s"]["count"] == 3
    json.dumps(snap)
    assert reg.drop("b.") == 1
    assert "b.level" not in reg.snapshot()["gauges"]


def test_snapshot_and_prometheus_text_match_jax_package():
    port, ref = _registry_session(MetricsRegistry), _registry_session(jobs.MetricsRegistry)
    a, b = port.snapshot(), ref.snapshot()
    a.pop("time_s"), b.pop("time_s")
    assert a == b
    text = port.prometheus_text()
    assert text == ref.prometheus_text()
    assert "# TYPE serving_requests_total counter" in text
    assert "serving_latency_s_count 3" in text


def test_registry_collectors_run_at_snapshot():
    reg = MetricsRegistry()
    state = {"v": 1.0}
    reg.register_collector("t", lambda r: r.gauge("scraped.v").set(state["v"]))
    assert reg.snapshot()["gauges"]["scraped.v"] == 1.0
    state["v"] = 2.0
    assert reg.snapshot()["gauges"]["scraped.v"] == 2.0
    reg.unregister_collector("t")
    state["v"] = 3.0
    assert reg.snapshot()["gauges"]["scraped.v"] == 2.0


# ---------------------------------------------------------------------------
# timed per-stage rendering: bitwise to untimed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_scene():
    return jax_random_scene(jax.random.key(1), 200, extent=2.5)


@pytest.fixture(scope="module")
def scene(jax_scene):
    return scene_from_numpy(jax_scene, "cpu")


@pytest.fixture()
def tracer():
    prev = set_tracer(Tracer(enabled=True))
    try:
        yield get_tracer()
    finally:
        set_tracer(prev)


def _cam(eye=(0.0, 1.0, 4.5)):
    return camera.make_camera(eye, (0, 0, 0), 64, 64)


def _assert_bitwise(a, b):
    assert torch.equal(a.image, b.image)
    assert a.stats.as_dict() == b.stats.as_dict()


def _stage_names(tracer):
    return [e.name for e in tracer.events() if e.category == "stage"]


SHARDINGS = [(1, "auto"), (2, "index"), (2, "psum"), (2, "flat"),
             (3, "index"), (3, "psum"), (3, "flat")]


@pytest.mark.parametrize("shards,gather", SHARDINGS)
@pytest.mark.parametrize("mode", ["gstg", "tile_baseline", "group_baseline"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_timed_render_and_halves_bitwise(scene, tracer, backend, mode, shards, gather):
    """render and render_frontend -> render_backend with timing on equal the
    untimed render bit for bit; one span per stage call (D per frontend
    stage and one merge when sharded), nested under one umbrella."""
    cfg = pipeline.RenderConfig(backend=backend, mode=mode, scene_shards=shards,
                                feature_gather=gather, **CFG_KW)
    timed = dataclasses.replace(cfg, timing=True)
    cam = _cam()
    want = pipeline.render(scene, cam, cfg)
    assert tracer.events() == []                   # untimed records nothing
    _assert_bitwise(pipeline.render(scene, cam, timed), want)
    names = _stage_names(tracer)
    back = ["stage/bitmask", "stage/compact"] if mode == "gstg" else []
    front = ["stage/project", "stage/identify", "stage/bin"] * shards
    merge = ["stage/merge"] if shards > 1 else []
    assert sorted(names) == sorted(front + merge + back + ["stage/rasterize", "stage/render"])
    umbrella = [e for e in tracer.events() if e.name == "stage/render"]
    assert umbrella[0].args == {"mode": mode, "backend": backend}
    assert all(e.args == {"backend": backend} for e in tracer.events()
               if e.name != "stage/render")
    assert validate_chrome_trace(tracer.chrome_trace()) == []
    tracer.clear()
    _assert_bitwise(pipeline.render_backend(pipeline.render_frontend(scene, cam, timed), cam,
                                            timed), want)
    assert sorted(_stage_names(tracer)) == sorted(front + merge + back + ["stage/rasterize"])


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_timed_batch_handle_and_submit_bitwise(scene, tracer, backend, shards):
    """render_batch, the handle's render, render_batch, halves and submit
    with timing on equal the untimed renders bit for bit; every lane
    records its own umbrella."""
    cfg = pipeline.RenderConfig(backend=backend, scene_shards=shards, **CFG_KW)
    timed = dataclasses.replace(cfg, timing=True)
    cams = camera.orbit_cameras(3, 4.5, 64, 64)
    want = [pipeline.render(scene, c, cfg) for c in cams]
    batch = pipeline.render_batch(scene, cams, timed)
    for i, w in enumerate(want):
        _assert_bitwise(batch.map(lambda x, i=i: x[i]), w)
    assert _stage_names(tracer).count("stage/render") == len(cams)
    with engine.open(scene, timed, device="cpu", max_batch=len(cams), max_wait=60.0) as r:
        _assert_bitwise(r.render(cams[0]), want[0])
        _assert_bitwise(r.render_backend(r.render_frontend(cams[1]), cams[1]), want[1])
        lanes = r.render_batch(cams)
        futs = [r.submit(c) for c in cams]
        results = [f.result(timeout=RESULT_TIMEOUT) for f in futs]
    for i, w in enumerate(want):
        _assert_bitwise(lanes.map(lambda x, i=i: x[i]), w)
        _assert_bitwise(results[i], w)
    assert validate_chrome_trace(tracer.chrome_trace()) == []


def test_timed_submits_nest_under_the_dispatch_span(scene, tracer):
    """Three timed submits: the stage spans land on the worker's lane inside
    its engine/dispatch span, each request has its own lifecycle lane, and
    the whole trace validates."""
    timed = pipeline.RenderConfig(timing=True, **CFG_KW)
    with engine.open(scene, timed, device="cpu", max_batch=3, max_wait=60.0) as r:
        futs = [r.submit(_cam()) for _ in range(3)]
        for f in futs:
            f.result(timeout=RESULT_TIMEOUT)
    evs = tracer.events()
    (dispatch,) = [e for e in evs if e.name == "engine/dispatch"]
    stages = [e for e in evs if e.category == "stage"]
    assert {e.name for e in stages} == STAGES
    assert [e.name for e in stages].count("stage/render") == 3
    assert all(e.tid == dispatch.tid and dispatch.t0 <= e.t0 <= e.t1 <= dispatch.t1
               for e in stages)
    assert validate_chrome_trace(tracer.chrome_trace()) == []


def test_engine_submit_emits_request_spans(scene):
    """The engine futures path stamps and emits the lifecycle spans."""
    prev = set_tracer(Tracer(enabled=True))
    try:
        with engine.open(scene, pipeline.RenderConfig(**CFG_KW), device="cpu") as r:
            futs = [r.submit(_cam()) for _ in range(3)]
            for f in futs:
                f.result(timeout=RESULT_TIMEOUT)
        evs = get_tracer().events()
        req = [e for e in evs if e.name == "request"]
        assert len(req) == 3
        ids = {e.args["request_id"] for e in req}
        assert len(ids) == 3 and all("#" in rid for rid in ids)
        assert any(e.name == "engine/dispatch" for e in evs)
        assert validate_chrome_trace(get_tracer().chrome_trace()) == []
    finally:
        set_tracer(prev)


def test_timed_stage_cache_registered():
    """"timed_stage" is in render_cache_info() as in the JAX package; its
    wrappers are cached per inner backend, with true hits and misses."""
    from repro.core.pipeline import render_cache_info as jax_render_cache_info

    info = pipeline.render_cache_info()
    assert "timed_stage" in info and "timed_stage" in jax_render_cache_info()
    pipeline.render_cache_clear()
    assert pipeline.render_cache_info()["timed_stage"] == {
        "hits": 0, "misses": 0, "currsize": 0, "maxsize": 128}
    inner = get_backend("reference")
    first = timed_backend(inner)
    assert isinstance(first, TimedBackend) and first.name == "timed:reference"
    assert timed_backend(inner) is first
    assert pipeline.render_cache_info()["timed_stage"]["hits"] == 1
    assert pipeline.render_cache_info()["timed_stage"]["misses"] == 1


def test_timed_render_matches_jax_package(jax_scene, scene, tracer):
    """The port's timed render against the JAX package's on the same arrays:
    counters equal, images within the parity contract, the same set of stage
    span names."""
    from repro import engine as jax_engine

    jcfg = JConfig(timing=True, **CFG_KW)
    jprev = jobs.set_tracer(jobs.Tracer(enabled=True))
    try:
        with jax_engine.open(jax_scene, jcfg) as r:
            want = r.render(jax_make_camera((0.0, 1.0, 4.5), (0, 0, 0), 64, 64))
        jnames = {e.name for e in jobs.get_tracer().events() if e.category == "stage"}
    finally:
        jobs.set_tracer(jprev)
    with engine.open(scene, pipeline.RenderConfig(timing=True, **CFG_KW), device="cpu") as r:
        got = r.render(_cam())
    np.testing.assert_allclose(n(got.image), np.asarray(want.image), **PARITY_TOL)
    assert_counters_equal(got.stats.as_dict(), want.stats)
    assert set(_stage_names(tracer)) == jnames == STAGES


def test_timed_training_step_bitwise(scene):
    """On the reference backend TimedBackend calls each stage as it is: a
    timed step's loss, image and gradients are bitwise the untimed ones."""
    from repro_torch.core.train import SceneTrainConfig, scene_loss, trainable

    cam = _cam()
    cfg = pipeline.RenderConfig(**CFG_KW)
    with torch.no_grad():
        target = pipeline.render(scene, _cam((0.3, 1.0, 4.4)), cfg).image
    outs = []
    for timing in (False, True):
        leaves = trainable(scene)
        loss, img = scene_loss(leaves, cam, target, dataclasses.replace(cfg, timing=timing),
                               SceneTrainConfig().lambda_dssim)
        grads = torch.autograd.grad(loss, [getattr(leaves, f) for f in SCENE_FIELDS])
        outs.append((loss.detach(), img.detach(), grads))
    (l0, i0, g0), (l1, i1, g1) = outs
    assert torch.equal(l0, l1) and torch.equal(i0, i1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert any(float(g.abs().max()) > 0 for g in g1)
