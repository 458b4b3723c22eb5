"""The port's gateway tier (repro_torch.gateway, the gateway CLI) against the
JAX package's (tests/test_gateway.py), on the CPU:

  * the stub-worker cases of tests/test_gateway.py on the port's gateway:
    admission, routing, health, bounded retries, no silent drop;
  * the same stub scenarios through both packages' gateways, with a frozen
    clock and dispatches held until every request is routed: equal counts,
    summaries, and worker and attempts per request;
  * an in-process failover on the reference backend, made deterministic
    (dispatches held until all 12 requests are routed, w0 killed right
    after its first dispatch returns): bitwise equal to a direct worker,
    within the cross-backend tolerance of the JAX package's InprocWorker
    over the same scene arrays, spans equal to counters; stream frames
    through an InprocWorker, whose lock is not the stream path's;
  * the wire: arrays and cameras encoded by either package decode bit for
    bit in the other, and the reader takes a line of several MB in 64 KiB
    pieces; one SubprocessWorker child on the CPU (round trip, bitwise
    lanes, SIGKILL -> WorkerDied, shutdown twice);
  * the gateway CLI in process, and the item-8 raises.

Every thread a test starts is joined with a timeout.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.gateway as jax_gateway
from repro.serving.queue import RenderRequest as JRequest
from repro_torch.gateway import (
    NoWorkerAvailable,
    RenderGateway,
    WorkerDied,
    plan_fleet,
)
from repro_torch.obs import get_registry
from repro_torch.serving.queue import RenderRequest
from torch_parity import single_thread  # noqa: F401

SRC = str(Path(__file__).resolve().parents[1] / "src")
JOIN_TIMEOUT = 60
GATE_TIMEOUT = 60


class _Res:
    def __init__(self, image, batch_size=1):
        self.image = image
        self.batch_size = batch_size


class StubWorker:
    """Pure-Python fleet member implementing the worker contract;
    ``fail_dispatches=n`` makes the first n dispatches raise and kill the
    worker. ``gate`` (a callable) holds every dispatch until it returns
    True. It raises RuntimeError, so both packages' gateways take it."""

    def __init__(self, worker_id, scene_ids, *, max_batch=4, committed=(),
                 fail_dispatches=0, dispatch_sleep=0.0, gate=None):
        self.worker_id = worker_id
        self.scene_ids = frozenset(scene_ids)
        self.max_batch = max_batch
        self._committed = set(committed)
        self._alive = True
        self._fail_left = fail_dispatches
        self._sleep = dispatch_sleep
        self.gate = gate
        self.dispatched = []

    def alive(self):
        return self._alive

    def ping(self):
        if not self._alive:
            raise WorkerDied(f"{self.worker_id} is dead")

    def committed_scene_ids(self):
        return set(self._committed)

    def commit(self, scene_id, cfg=None):
        self.ping()
        self._committed.add(scene_id)

    def dispatch(self, requests):
        _hold(self.gate)
        self.ping()
        if self._fail_left > 0:
            self._fail_left -= 1
            self._alive = False
            raise WorkerDied(f"{self.worker_id} died mid-dispatch")
        if self._sleep:
            time.sleep(self._sleep)
        self.dispatched.append([r.request_id for r in requests])
        out = {}
        for r in requests:
            self._committed.add(r.scene_id)     # lazy commit, like the server
            out[r.request_id] = _Res(("img", self.worker_id, r.request_id))
        return out

    def kill(self):
        self._alive = False

    def shutdown(self):
        self._alive = False


def _hold(gate):
    deadline = time.monotonic() + GATE_TIMEOUT
    while gate is not None and not gate() and time.monotonic() < deadline:
        time.sleep(0.001)


def _req(rid, scene="a", stream_id=None):
    return RenderRequest(rid, scene, object(), "cfg", stream_id=stream_id)


def _load(n, scenes=("a",), base=0):
    return [(0.0, _req(base + i, scenes[i % len(scenes)])) for i in range(n)]


# -- admission ----------------------------------------------------------------


def test_admission_unknown_scene_raises():
    gw = RenderGateway([StubWorker("w0", ["a"])])
    with pytest.raises(KeyError):
        gw.submit(_req(1, scene="nope"))
    gw.close()


def test_admission_backpressure_counts_rejected():
    before = get_registry().counter("gateway.rejected_total").value
    gw = RenderGateway([StubWorker("w0", ["a"])], queue_depth=2)
    assert gw.submit(_req(1)) and gw.submit(_req(2))
    assert not gw.submit(_req(3))
    assert gw.counts["rejected"] == 1
    assert gw.counts["submitted"] == 3
    assert get_registry().counter("gateway.rejected_total").value == before + 1
    gw.close()


def test_close_fails_pending_requests():
    gw = RenderGateway([StubWorker("w0", ["a"])], queue_depth=8)
    gw.submit(_req(1))
    gw.submit(_req(2))
    gw.close()
    assert set(gw.failed) == {1, 2}
    assert all(isinstance(e, RuntimeError) for e in gw.failed.values())
    gw.close()                               # idempotent


# -- routing policy (no dispatcher threads: pick/route inspected directly) ----


def test_route_prefers_affine_worker():
    w0 = StubWorker("w0", ["a", "b"])
    w1 = StubWorker("w1", ["a", "b"], committed=["a"])
    gw = RenderGateway([w0, w1])
    assert gw._pick_worker(_req(1, "a")) == "w1"
    assert gw._pick_worker(_req(2, "b")) == "w0"
    gw.close()


def test_route_least_loaded_among_affine():
    w0 = StubWorker("w0", ["a"], committed=["a"])
    w1 = StubWorker("w1", ["a"], committed=["a"])
    gw = RenderGateway([w0, w1])
    gw._inbox["w0"].append(_req(99))
    assert gw._pick_worker(_req(1)) == "w1"
    gw.close()


def test_route_spills_past_load_threshold():
    w0 = StubWorker("w0", ["a"], committed=["a"])
    w1 = StubWorker("w1", ["a"])
    gw = RenderGateway([w0, w1], spill_load=2)
    assert gw._pick_worker(_req(1)) == "w0"
    gw._inbox["w0"].extend([_req(98), _req(99)])
    assert gw._pick_worker(_req(2)) == "w1"
    gw.close()


def test_route_straggler_deprioritized_not_excluded():
    w0 = StubWorker("w0", ["a"], committed=["a"])
    w1 = StubWorker("w1", ["a"])
    gw = RenderGateway([w0, w1])
    gw._stragglers = {"w0"}
    assert gw._pick_worker(_req(1)) == "w1"
    gw._routable = {"w0"}
    assert gw._pick_worker(_req(2)) == "w0"
    gw.close()


def test_stream_sticky_routing_and_repin_after_death():
    w0 = StubWorker("w0", ["a"], committed=["a"])
    w1 = StubWorker("w1", ["a"], committed=["a"])
    gw = RenderGateway([w0, w1])
    gw._route(_req(1, stream_id="s0"), 0.0)
    assert gw._stream_route["s0"] == "w0"
    gw._inbox["w0"].append(_req(99))
    assert gw._pick_worker(_req(2, stream_id="s0")) == "w0"
    gw._handle_death("w0", [], WorkerDied("chaos"), 0.0)
    assert "s0" not in gw._stream_route
    assert gw._pick_worker(_req(3, stream_id="s0")) == "w1"
    gw.close()


def test_route_counts_lazy_recommit():
    gw = RenderGateway([StubWorker("w0", ["a"])])
    gw._route(_req(1), 0.0)
    assert gw.counts["recommits"] == 1
    assert gw.counts["routed"] == 1
    gw.close()


class ResidencyStub(StubWorker):
    def __init__(self, worker_id, scene_ids, *, committed=(), resident=(), **kw):
        super().__init__(worker_id, scene_ids, committed=committed, **kw)
        self._resident = set(resident)

    def resident_scene_ids(self):
        return set(self._resident)


def test_route_prefers_resident_over_merely_committed():
    w0 = ResidencyStub("w0", ["a"], committed=["a"], resident=[])
    w1 = ResidencyStub("w1", ["a"], committed=["a"], resident=["a"])
    gw = RenderGateway([w0, w1], spill_load=2)
    assert gw._pick_worker(_req(1, "a")) == "w1"
    gw._inbox["w1"].extend([_req(98), _req(99)])
    assert gw._pick_worker(_req(2, "a")) == "w0"
    gw.close()


def test_route_without_resident_signal_falls_back_to_affinity():
    w0 = StubWorker("w0", ["a"])
    w1 = StubWorker("w1", ["a"], committed=["a"])
    gw = RenderGateway([w0, w1])
    assert gw._pick_worker(_req(1, "a")) == "w1"
    gw.close()


# -- health -------------------------------------------------------------------


def test_heartbeat_timeout_declares_worker_dead():
    gw = RenderGateway([StubWorker("w0", ["a"]), StubWorker("w1", ["a"])],
                       heartbeat_timeout_s=5.0)
    gw._started = True                       # police without real dispatchers
    now = gw._clock()
    gw._started_at = now - 6.0
    gw.monitor.report(1, 0, 0.0, now)        # w1 reported; w0 never seen
    gw.step(now)
    assert gw.healthy_workers == ["w1"]
    assert gw.counts["failovers"] == 1
    assert gw.plan.mesh_shape == (1, 1)
    gw.close()


def test_failover_replans_fleet_and_empty_fleet_has_no_plan():
    gw = RenderGateway([StubWorker(f"w{i}", ["a"]) for i in range(3)],
                       devices_per_worker=2)
    assert gw.plan.mesh_shape == (3, 2)
    gw._handle_death("w1", [], WorkerDied("x"), 0.0)
    assert gw.plan.mesh_shape == (2, 2)
    assert gw.plan.routable == ("w0", "w2")
    gw._handle_death("w0", [], WorkerDied("x"), 0.0)
    gw._handle_death("w2", [], WorkerDied("x"), 0.0)
    assert gw.plan is None and plan_fleet([]) is None
    gw.close()


def test_duplicate_result_is_dropped():
    gw = RenderGateway([StubWorker("w0", ["a"])])
    req = _req(5)
    gw._attempts[5] = 1
    gw._resolve("w0", req, _Res("first"), 0.0, 0.0)
    gw._resolve("w0", req, _Res("late-duplicate"), 0.0, 0.0)
    assert gw.results[5].image == "first"
    assert gw.counts["duplicates"] == 1
    assert gw.counts["completed"] == 1
    gw.close()


# -- end-to-end over stubs (real dispatcher threads) --------------------------


def test_run_completes_all_requests_healthy():
    gw = RenderGateway([StubWorker("w0", ["a", "b"]), StubWorker("w1", ["a", "b"])],
                       retry_backoff_s=0.001)
    res = gw.run(_load(16, scenes=("a", "b")))
    assert len(res) == 16 and not gw.failed
    assert all(r.attempts == 1 for r in res.values())
    s = gw.summary()
    assert s["gateway"] is True and s["completed"] == 16
    assert "gateway: 16/16 completed" in gw.format()
    gw.close()


def test_failover_retries_complete_on_survivor():
    w0 = StubWorker("w0", ["a"], committed=["a"], fail_dispatches=1)
    w1 = StubWorker("w1", ["a"])
    gw = RenderGateway([w0, w1], retry_backoff_s=0.001)
    res = gw.run(_load(6))
    assert len(res) == 6 and not gw.failed
    assert all(r.worker_id == "w1" for r in res.values())
    assert any(r.attempts > 1 for r in res.values())
    assert gw.counts["failovers"] == 1
    assert gw.counts["retries"] >= 1
    assert gw.counts["recommits"] >= 1
    assert gw.healthy_workers == ["w1"]
    gw.close()


def test_total_fleet_death_fails_requests_without_hanging():
    ws = [StubWorker("w0", ["a"], fail_dispatches=1),
          StubWorker("w1", ["a"], fail_dispatches=1)]
    gw = RenderGateway(ws, retry_backoff_s=0.001, max_retries=2)
    res = gw.run(_load(4))
    assert res == {} and set(gw.failed) == {0, 1, 2, 3}
    assert all(isinstance(e, (NoWorkerAvailable, WorkerDied)) for e in gw.failed.values())
    assert gw.counts["failovers"] == 2
    assert gw.outstanding() == 0
    assert gw.healthy_workers == []
    gw.close()


def test_kill_hook_induces_failover_on_next_dispatch():
    ws = [StubWorker("w0", ["a"]), StubWorker("w1", ["a"])]
    gw = RenderGateway(ws, retry_backoff_s=0.001)
    assert len(gw.run(_load(4))) == 4
    gw.kill_worker("w0")
    assert not ws[0].alive() and ws[1].alive()
    res = gw.run(_load(16, base=100))
    assert len(res) == 20 and not gw.failed
    assert gw.counts["failovers"] == 1
    assert all(res[rid].worker_id == "w1" for rid in range(100, 116))
    gw.close()


def test_submit_step_drive_from_producer_thread():
    gw = RenderGateway([StubWorker("w0", ["a"])], retry_backoff_s=0.001)

    def produce():
        for i in range(8):
            while not gw.submit(_req(i)):
                time.sleep(0.001)

    t = threading.Thread(target=produce)
    t.start()
    deadline = time.monotonic() + 30
    while len(gw.results) < 8:
        gw.step()
        assert time.monotonic() < deadline, "gateway stalled"
        time.sleep(0.001)
    t.join(timeout=JOIN_TIMEOUT)
    assert not t.is_alive()
    assert len(gw.results) == 8 and not gw.failed
    gw.close()


def test_import_and_stub_gateway_touch_no_device():
    """Importing repro_torch.gateway and running a gateway over stub workers
    imports no torch, so no CUDA context can start."""
    code = (
        "import sys\n"
        "import repro_torch.gateway as g\n"
        "from repro_torch.serving.queue import RenderRequest\n"
        "class W:\n"
        "    worker_id, scene_ids, max_batch = 'w0', frozenset('a'), 2\n"
        "    def alive(self): return True\n"
        "    def ping(self): pass\n"
        "    def committed_scene_ids(self): return set()\n"
        "    def dispatch(self, reqs):\n"
        "        return {r.request_id: type('R', (), {'image': 0})() for r in reqs}\n"
        "    def shutdown(self): pass\n"
        "gw = g.RenderGateway([W()])\n"
        "assert len(gw.run([(0.0, RenderRequest(i, 'a', None, 'c')) for i in range(3)])) == 3\n"
        "gw.close()\n"
        "assert 'torch' not in sys.modules, 'the gateway imported torch'\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, env={"PYTHONPATH": SRC},
                   timeout=120)


# -- the same stub scenarios through both packages' gateways -------------------


def _scenario(name):
    """(workers, [(rid, scene, stream_id)], gateway kwargs). Every worker
    takes one request a dispatch, so no batch depends on thread timing."""
    one = dict(max_batch=1)
    if name == "healthy":
        ws = [StubWorker("w0", "ab", committed="ab", **one),
              StubWorker("w1", "ab", committed="ab", **one)]
        return ws, [(i, "ab"[i % 2], None) for i in range(16)], {}
    if name == "failover":
        ws = [StubWorker("w0", "a", committed="a", fail_dispatches=1, **one),
              StubWorker("w1", "a", committed="a", **one)]
        return ws, [(i, "a", None) for i in range(6)], {}
    if name == "fleet_death":
        ws = [StubWorker("w0", "a", fail_dispatches=1, **one),
              StubWorker("w1", "a", fail_dispatches=1, **one)]
        return ws, [(i, "a", None) for i in range(4)], {"max_retries": 0}
    if name == "streams":
        ws = [StubWorker(f"w{k}", "ab", committed="ab", **one) for k in range(3)]
        return ws, [(i, "ab"[i % 2], f"s{i % 2}") for i in range(10)], {}
    if name == "spill":
        ws = [StubWorker("w0", "a", committed="a", **one),
              StubWorker("w1", "ab", **one)]
        return ws, [(i, "a", None) for i in range(12)], {"spill_load": 4}
    if name == "residency":
        ws = [ResidencyStub("w0", "ab", committed="ab", resident="a", **one),
              ResidencyStub("w1", "ab", committed="ab", resident="b", **one)]
        return ws, [(i, "ab"[(i // 3) % 2], None) for i in range(12)], {"spill_load": 3}
    raise AssertionError(name)


def _nan_free(x):
    if isinstance(x, dict):
        return {k: _nan_free(v) for k, v in x.items()}
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _drive(gateway_cls, request_cls, name):
    ws, reqs, kw = _scenario(name)
    gw = gateway_cls(ws, clock=lambda: 0.0, retry_backoff_s=0.0, **kw)
    for w in ws:
        w.gate = lambda: gw.counts["routed"] >= len(reqs)
    res = gw.run([(0.0, request_cls(rid, sid, object(), "cfg", stream_id=st))
                  for rid, sid, st in reqs])
    out = {"counts": dict(gw.counts), "summary": _nan_free(gw.summary()),
           "results": {rid: (r.worker_id, r.attempts) for rid, r in res.items()},
           "failed": {rid: type(e).__name__ for rid, e in gw.failed.items()},
           "dispatched": {w.worker_id: sorted(sum(w.dispatched, [])) for w in ws}}
    gw.close()
    return out


@pytest.mark.parametrize("name", ["healthy", "failover", "fleet_death", "streams", "spill",
                                  "residency"])
def test_same_routing_and_accounting_as_the_jax_gateway(name):
    ours = _drive(RenderGateway, RenderRequest, name)
    ref = _drive(jax_gateway.RenderGateway, JRequest, name)
    assert ours == ref
    assert set(ours["results"]) | set(ours["failed"]) == set(range(len(_scenario(name)[1])))


# -- an in-process fleet on the reference backend ------------------------------


class Gated:
    """A worker whose dispatches wait until ``ready()``; with ``die_after_first``
    it is killed as its first dispatch returns, so it still holds the rest of
    its share when it dies. Everything else is the wrapped worker's."""

    def __init__(self, worker, ready, die_after_first=False):
        self._worker = worker
        self._ready = ready
        self._die = die_after_first

    def __getattr__(self, name):
        return getattr(self._worker, name)

    def dispatch(self, requests):
        _hold(self._ready)
        out = self._worker.dispatch(requests)
        if self._die:
            self._worker.kill()
        return out


@pytest.fixture(scope="module")
def fleet_scenes():
    """train and truck at 300 gaussians from the JAX package, and the port's
    copies of the same arrays."""
    import jax

    from repro.core.gaussians import scene_like_paper
    from repro_torch.core.gaussians import scene_from_numpy

    built = {sid: scene_like_paper(jax.random.key(i), sid, 300)
             for i, sid in enumerate(("train", "truck"))}
    return built, {sid: scene_from_numpy(s, "cpu") for sid, s in built.items()}


def test_inproc_failover_bitwise_and_span_parity(fleet_scenes, single_thread):
    """Kill w0 of two in-process workers right after its first dispatch:
    every request completes, retried ones on w1; every image bitwise equal
    to a direct worker's, and within atol 5e-6 / rtol 1e-5 of the JAX
    package's InprocWorker over the same scene arrays; the gateway spans
    equal the counters."""
    from repro.core import orbit_cameras as jax_orbit_cameras
    from repro.core.pipeline import RenderConfig as JConfig
    from repro.gateway.worker import InprocWorker as JWorker
    from repro_torch.core.camera import orbit_cameras
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.gateway import InprocWorker
    from repro_torch.obs import Tracer, set_tracer, validate_gateway_trace

    jax_scenes, scenes = fleet_scenes
    sids = ["train", "truck"]
    cams = orbit_cameras(6, 4.5, 64, 64)
    cfg = RenderConfig(mode="gstg", backend="reference", span=6)
    warm_ids = iter(range(-1, -100, -1))

    def warm(w):
        for sid in sids:
            w.dispatch([RenderRequest(next(warm_ids), sid, cams[0], cfg)])
        return w

    w0 = InprocWorker("w0", scenes, device="cpu", max_batch=4)
    w1 = InprocWorker("w1", scenes, device="cpu", max_batch=4)
    w0.commit("train", cfg)
    w1.commit("truck", cfg)
    warm(w0)
    warm(w1)
    load = [(0.0, RenderRequest(i, sids[i % 2], cams[i % len(cams)], cfg)) for i in range(12)]
    gw = None
    ready = lambda: gw.counts["routed"] >= len(load)          # noqa: E731
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    before = get_registry().snapshot()["counters"]
    try:
        gw = RenderGateway([Gated(w0, ready, die_after_first=True), Gated(w1, ready)],
                           retry_backoff_s=0.005)
        res = gw.run(load)
        counters = {k: v - before.get(k, 0)
                    for k, v in get_registry().snapshot()["counters"].items()}
        doc = tracer.chrome_trace()
    finally:
        set_tracer(prev)
    summary = gw.summary()
    gw.close()
    assert sorted(res) == list(range(12)) and not gw.failed, gw.failed
    assert summary["failovers"] == 1 and summary["workers"]["w0"]["dispatches"] == 1
    retried = [r for r in res.values() if r.attempts > 1]
    assert len(retried) >= 2 and all(r.worker_id == "w1" for r in retried)
    doc["summary"] = summary
    assert validate_gateway_trace(doc, counters) == []

    direct = warm(InprocWorker("ref", scenes, device="cpu", max_batch=4))
    jw = JWorker("jax", jax_scenes, max_batch=4)
    jcams = jax_orbit_cameras(6, 4.5, 64, 64)
    jcfg = JConfig(mode="gstg", backend="reference", span=6)
    want = jw.dispatch([JRequest(1000 + i, sids[i % 2], jcams[i % 6], jcfg) for i in range(12)])
    for i, (_, req) in enumerate(load):
        got = res[req.request_id].image
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        one = direct.dispatch([dataclasses.replace(req, request_id=1000 + i)])[1000 + i]
        assert torch.equal(one.image, got), f"request {i} diverged from the direct run"
        np.testing.assert_allclose(got.numpy(), np.asarray(want[1000 + i].image),
                                   atol=5e-6, rtol=1e-5)
    direct.shutdown()
    jw.shutdown()


def test_inproc_worker_serves_stream_frames_under_its_own_lock(fleet_scenes, single_thread):
    """Stream frames through an InprocWorker: the server's stream path takes
    engine/stream.py's dispatch lock inside the worker's own, so the frames
    complete (one shared, non-reentrant lock would deadlock here), bitwise
    equal to the same cameras served statelessly."""
    from repro_torch.core.camera import orbit_cameras
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.gateway import InprocWorker

    cams = orbit_cameras(3, 4.5, 64, 64)
    cfg = RenderConfig(mode="gstg", backend="reference", span=6)
    w = InprocWorker("w0", fleet_scenes[1], device="cpu", max_batch=2)
    out = {}

    def serve():
        out["stream"] = w.dispatch([RenderRequest(i, "train", c, cfg, stream_id="s0")
                                    for i, c in enumerate(cams)])
        out["plain"] = w.dispatch([RenderRequest(10 + i, "train", c, cfg)
                                   for i, c in enumerate(cams)])

    t = threading.Thread(target=serve, daemon=True)   # a hang must not outlive the test
    t.start()
    t.join(timeout=JOIN_TIMEOUT)
    alive = t.is_alive()
    w.shutdown()
    assert not alive, "a stream dispatch through an InprocWorker hung"
    for i in range(len(cams)):
        assert torch.equal(out["stream"][i].image, out["plain"][10 + i].image)


def test_inproc_worker_mesh_raises_naming_item_8(fleet_scenes):
    from repro_torch.gateway import InprocWorker

    with pytest.raises(NotImplementedError, match="item 8"):
        InprocWorker("w0", fleet_scenes[1], device="cpu", mesh=object())


# -- the wire -----------------------------------------------------------------


def _wire_arrays():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((5, 7, 3)).astype(np.float32)
    f[0, 0] = [np.nan, np.inf, -0.0]
    f[1, 1, 0] = np.float32(1e-42)                      # a subnormal
    return {"float32": f, "int32": rng.integers(-2**31, 2**31, (4, 9), dtype=np.int32),
            "uint8": rng.integers(0, 256, (3, 3), dtype=np.uint8),
            "float64": rng.standard_normal(11), "scalar": np.float32(3.25),
            "empty": np.zeros((0, 3), np.float32)}


@pytest.mark.parametrize("kind", sorted(_wire_arrays()))
@pytest.mark.parametrize("tensor", [False, True], ids=["numpy", "tensor"])
def test_wire_arrays_round_trip_between_packages(kind, tensor):
    from repro.gateway import transport as jt
    from repro_torch.gateway import transport as tt

    a = _wire_arrays()[kind]
    sent = torch.from_numpy(np.array(a)) if tensor else a
    ours = tt.encode_array(sent)
    assert ours == jt.encode_array(np.asarray(a))
    want = np.ascontiguousarray(a)       # both packages send a scalar as shape (1,)
    for doc in (ours, jt.encode_array(np.asarray(a))):
        for back in (tt.decode_array(doc), jt.decode_array(doc)):
            assert back.dtype == want.dtype and back.shape == want.shape
            assert back.tobytes() == want.tobytes()


def test_wire_cameras_and_requests_equal_between_packages():
    from repro.core import make_camera as jax_make_camera
    from repro.gateway import transport as jt
    from repro_torch.core.camera import make_camera
    from repro_torch.gateway import transport as tt

    for eye, w, h in (((0.0, 1.0, 4.5), 64, 64), ((1.3, -0.7, 2.9), 1952, 1088)):
        cam, jcam = make_camera(eye, (0, 0, 0), w, h), jax_make_camera(eye, (0, 0, 0), w, h)
        assert json.dumps(tt.encode_camera(cam)) == json.dumps(jt.encode_camera(jcam))
        ours = tt.encode_request(RenderRequest(7, "train", cam, None, stream_id="s1"))
        ref = jt.encode_request(JRequest(7, "train", jcam, None, stream_id="s1"))
        assert json.dumps(ours) == json.dumps(ref)


class _PipeProc:
    """What the reader touches of a Popen: its pipes, poll, kill and wait."""

    def __init__(self, fd):
        self.stdout = os.fdopen(fd, "rb", buffering=0)
        self.stdin = open(os.devnull, "wb")

    def poll(self):
        return 0

    def kill(self):
        pass

    def wait(self, timeout=None):
        return 0


def test_read_line_takes_a_long_line_in_64k_pieces():
    """Two lines in one stream, the first of 8 MB, written 64 KiB at a time,
    then a partial line and EOF: both lines decode whole, and EOF raises
    WorkerDied."""
    from repro_torch.gateway.transport import SubprocessWorker

    big = {"id": 1, "ok": True, "blob": "x" * (8 << 20)}
    data = (json.dumps(big) + "\n" + json.dumps({"id": 2, "ok": True}) + "\n{\"id\": 3").encode()
    r, w = os.pipe()
    worker = SubprocessWorker.__new__(SubprocessWorker)
    worker.worker_id, worker.proc = "pipe", _PipeProc(r)
    worker._partial, worker._lines = [], deque()

    def write():
        with os.fdopen(w, "wb", buffering=0) as f:
            for i in range(0, len(data), 1 << 16):
                f.write(data[i:i + (1 << 16)])

    t = threading.Thread(target=write)
    t.start()
    try:
        first = worker._read_line(60.0)
        assert first == big and worker.last_line["bytes"] == len(json.dumps(big))
        assert worker.last_line["newline"] >= worker.last_line["first_byte"]
        assert worker._read_line(60.0) == {"id": 2, "ok": True}
        with pytest.raises(WorkerDied, match="exited"):
            worker._read_line(60.0)
    finally:
        t.join(timeout=JOIN_TIMEOUT)
        worker.proc.stdout.close()
    assert not t.is_alive()


def test_subprocess_worker_round_trip_and_sigkill():
    """One child on the CPU: ping, commit, a two-lane dispatch whose lanes
    are bitwise equal, a deterministic re-dispatch, SIGKILL -> WorkerDied,
    and shutdown twice."""
    from repro_torch.core.camera import make_camera
    from repro_torch.gateway.transport import SubprocessWorker, worker_argv

    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    cam = make_camera((0.0, 1.0, 4.5), (0, 0, 0), 64, 64)
    w = SubprocessWorker(
        "sub0", ["train"],
        worker_argv("sub0", ["train:0"], device="cpu",
                    extra=["--gaussians", "300", "--max-batch", "2"]),
        max_batch=2, env=env, ready_timeout_s=600.0, read_timeout_s=600.0,
    )
    try:
        assert w.startup_s > 0 and w.devices == 1
        w.ping()
        assert w.alive()
        w.commit("train")
        assert "train" in w.committed_scene_ids()
        out = w.dispatch([RenderRequest(i, "train", cam, None) for i in (1, 2)])
        img = out[1].image
        assert isinstance(img, torch.Tensor) and img.shape == (64, 64, 3)
        assert img.dtype == torch.float32 and torch.isfinite(img).all()
        assert torch.equal(img, out[2].image)
        again = w.dispatch([RenderRequest(3, "train", cam, None)])
        assert torch.equal(img, again[3].image)
        wire = w.wire[-1]
        assert wire["line_bytes"] > 64 * 64 * 3 * 4 and wire["requests"] == 1
        assert all(wire[k] >= 0 for k in ("reply_wait_s", "transfer_s", "parse_s", "decode_s"))
        assert wire["round_trip_s"] >= wire["reply_wait_s"] + wire["transfer_s"]
        w.kill()
        assert not w.alive()
        with pytest.raises(WorkerDied):
            w.dispatch([RenderRequest(4, "train", cam, None)])
        assert w.proc.wait(timeout=30) == -signal.SIGKILL
    finally:
        w.shutdown()
        w.shutdown()


# -- the CLI --------------------------------------------------------------------


def test_render_gateway_cli_inproc_kill_and_parity(tmp_path, capsys, single_thread):
    """python -m repro_torch.launch.render_gateway --device cpu --inproc with a
    kill and --parity-check, in process: exit 0, every image bitwise the
    direct handle's, a failover, and a trace that passes the gateway
    cross-check against this run's counters."""
    from repro_torch.launch.render_gateway import main
    from repro_torch.obs import Tracer, set_tracer, validate_gateway_trace

    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    prev = set_tracer(Tracer())
    before = get_registry().snapshot()["counters"]
    try:
        rc = main(["--device", "cpu", "--inproc", "--gaussians", "300",
                   "--resolutions", "64x64", "--requests", "12", "--max-batch", "2",
                   "--no-realtime", "--kill-worker", "auto", "--kill-after", "2",
                   "--parity-check", "--trace-json", str(trace),
                   "--metrics-json", str(metrics)])
    finally:
        set_tracer(prev)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "render_gateway: OK" in out and "parity-check: 12/12" in out
    doc, snap = json.loads(trace.read_text()), json.loads(metrics.read_text())
    counters = {k: v - before.get(k, 0) for k, v in snap["counters"].items()}
    assert validate_gateway_trace(doc, counters) == []
    assert doc["summary"]["failovers"] >= 1 and doc["summary"]["completed"] == 12


def test_render_gateway_devices_per_worker_raises_naming_item_8():
    from repro_torch.launch.render_gateway import main

    with pytest.raises(NotImplementedError, match="item 8"):
        main(["--device", "cpu", "--devices-per-worker", "2"])
