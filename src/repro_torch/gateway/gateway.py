"""Render gateway: admission, routing, health, failover over a worker fleet
(mirror of ``repro.gateway.gateway``, DESIGN.md §16).

The tier above the serving tier: one :class:`RenderGateway` fronts N workers
(:mod:`repro_torch.gateway.worker` in-process, :mod:`repro_torch.gateway.transport`
subprocess), each an owned ``RenderServer`` over its own committed scenes.
The gateway only schedules — all device work happens inside workers — so it
is pure Python on the hot path, reusing the serving tier's primitives:

  submit() --> RequestQueue --> router (step) --> per-worker inbox
   (bounded, backpressure,      scene-affinity +     (one dispatcher thread
    gateway.rejected)           stream-sticky +       per worker; per-dispatch
                                least-loaded spill)   heartbeats)

Health: every worker dispatch (and idle ping) reports into an
``ft.heartbeat.HeartbeatMonitor``; a worker silent past the miss timeout is
declared dead, a worker whose dispatch latency is a robust outlier is
flagged a straggler and drained (deprioritized for new work). Death —
flagged, heartbeat-missed, or a transport error mid-dispatch — triggers
failover: the worker's inbox and in-flight batch are re-routed to healthy
workers (bounded retries with backoff; the new worker re-commits the scene
lazily at dispatch), and the routable fleet is re-planned through
``ft.elastic.plan_elastic_mesh`` (each worker = one fixed per-host mesh, so
the fleet shrinks on the data axis). Request ids make retries idempotent at
resolve time: the first completion of an id wins, a late duplicate (a
worker declared dead that was merely slow) is counted and dropped.

Invariants (tests/test_torch_gateway.py):
  * no request is silently dropped — every admitted request terminates in
    ``results`` or ``failed`` (with the terminal exception);
  * worker responses are bitwise-identical to a direct single-server run
    with the same settings (the worker's server pads each dispatch to the
    same fixed shape, and batch lanes are independent), so failover is
    invisible in the pixels;
  * ``gateway/route|retry|failover`` spans match the ``gateway.*``
    counters one-to-one (cross-checked by ``obs.validate_gateway_trace``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.ft.elastic import plan_elastic_mesh
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.obs import emit_request_spans, get_registry, get_tracer
from repro_torch.obs.metrics import Histogram
from repro_torch.serving.queue import RenderRequest, RequestQueue
from repro_torch.serving.stats import percentile


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """The routable fleet after (re)planning — ``ft.elastic`` applied to
    workers: each worker contributes one fixed per-host mesh of
    ``devices_per_worker`` devices (the 'model'-like axis a worker cannot
    split), so elasticity happens on the worker/data axis, exactly the
    ``plan_elastic_mesh`` policy. ``global_batch`` is passed as the group
    count because render serving pads per-worker dispatches — there is no
    cross-worker batch-divisibility constraint to preserve."""

    routable: Tuple[str, ...]
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    note: str


def plan_fleet(
    worker_ids: Iterable[str], devices_per_worker: int = 1
) -> Optional[FleetPlan]:
    """Plan the routable fleet over the surviving workers; None when no
    worker survives (the caller must fail pending requests explicitly)."""
    ids = tuple(sorted(worker_ids))
    if devices_per_worker < 1:
        raise ValueError(
            f"devices_per_worker must be >= 1, got {devices_per_worker}"
        )
    plan = plan_elastic_mesh(
        available_devices=len(ids) * devices_per_worker,
        model_parallel=devices_per_worker,
        global_batch=max(len(ids), 1),
        prefer_pods=False,
    )
    if plan is None:
        return None
    return FleetPlan(
        routable=ids,
        mesh_shape=plan.mesh_shape,
        mesh_axes=plan.mesh_axes,
        note=plan.note,
    )


@dataclasses.dataclass
class GatewayResult:
    """One completed request as the gateway saw it."""

    request_id: int
    image: Any                   # (H, W, 3) CPU torch.Tensor
    latency_s: float             # resolve - gateway enqueue (queue+route+worker)
    worker_id: str
    attempts: int                # 1 = first try; >1 = failover retries
    batch_size: int = 1


class NoWorkerAvailable(RuntimeError):
    """Terminal routing failure: no routable worker hosts the scene (the
    whole fleet died, or every hosting worker did)."""


class RenderGateway:
    """Admission + routing + health + failover over a fleet of workers.

    ``workers`` is a list of objects satisfying the contract documented in
    :mod:`repro_torch.gateway.worker` (``InprocWorker``/``SubprocessWorker``, or
    pure-Python stubs in tests). Thread model: producers call ``submit``
    (bounded queue = the thread-safe boundary), ONE driver thread calls
    ``step()``/``run()`` (the router), and the gateway owns one dispatcher
    thread per worker. All router state is guarded by one lock.
    """

    def __init__(
        self,
        workers: List[Any],
        *,
        queue_depth: int = 256,
        max_retries: int = 3,
        retry_backoff_s: float = 0.02,
        heartbeat_timeout_s: float = 30.0,
        straggler_window: int = 16,
        straggler_iqr_k: float = 3.0,
        straggler_min_factor: float = 4.0,
        spill_load: Optional[int] = None,
        devices_per_worker: int = 1,
        clock=time.monotonic,
    ):
        if not workers:
            raise ValueError("gateway needs at least one worker")
        ids = [w.worker_id for w in workers]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids: {ids}")
        self.workers = list(workers)
        self._by_id = {w.worker_id: w for w in workers}
        self._index = {w.worker_id: i for i, w in enumerate(workers)}
        self._clock = clock
        self.queue = RequestQueue(queue_depth, clock=clock)
        self.monitor = HeartbeatMonitor(
            n_hosts=len(workers),
            window=straggler_window,
            iqr_k=straggler_iqr_k,
            min_factor=straggler_min_factor,
            miss_timeout_s=heartbeat_timeout_s,
        )
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.devices_per_worker = devices_per_worker
        # Spill threshold: an affine worker deeper than this many queued +
        # in-flight requests loses the scene-affinity preference and load
        # wins (FlashGS-style many-client regime: affinity is a cache
        # optimization, not a correctness pin — only streams are sticky).
        self.spill_load = (
            spill_load
            if spill_load is not None
            else 2 * max(getattr(w, "max_batch", 8) for w in workers)
        )

        self._lock = threading.Lock()
        self._conds = {
            w.worker_id: threading.Condition(self._lock) for w in workers
        }
        self._inbox: Dict[str, deque] = {w.worker_id: deque() for w in workers}
        self._inflight: Dict[str, List[RenderRequest]] = {
            w.worker_id: [] for w in workers
        }
        self._events: deque = deque()            # worker -> router handoff
        self._routable = set(ids)
        self._stragglers: set = set()
        self._assigned: Dict[int, Optional[str]] = {}   # rid -> current worker
        self._attempts: Dict[int, int] = {}
        self._retries: List[Tuple[float, int, RenderRequest]] = []  # heap
        self._retry_seq = itertools.count()
        self._stream_route: Dict[str, str] = {}
        self._steps: Dict[str, int] = {w.worker_id: 0 for w in workers}
        self._dispatches: Dict[str, int] = {w.worker_id: 0 for w in workers}
        self._completed_by: Dict[str, int] = {w.worker_id: 0 for w in workers}

        self.results: Dict[int, GatewayResult] = {}
        self.failed: Dict[int, Exception] = {}
        self.counts = {
            "submitted": 0, "rejected": 0, "routed": 0, "completed": 0,
            "retries": 0, "failovers": 0, "failed": 0, "duplicates": 0,
            "recommits": 0, "stragglers": 0,
        }
        self._latency = Histogram()
        self.wall_s: Optional[float] = None
        self.plan: Optional[FleetPlan] = plan_fleet(ids, devices_per_worker)

        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False
        self._started_at: Optional[float] = None
        self._closed = False
        # Dispatcher idle poll: bounds cond-miss latency and sets the idle
        # heartbeat (ping) cadence; keep well under the miss timeout.
        self._idle_wait = max(min(heartbeat_timeout_s / 4.0, 0.05), 0.005)

    # -- introspection -------------------------------------------------------

    @property
    def scene_ids(self) -> set:
        """Every scene SOME worker can host (admission screen)."""
        out: set = set()
        for w in self.workers:
            out |= set(w.scene_ids)
        return out

    @property
    def healthy_workers(self) -> List[str]:
        with self._lock:
            return sorted(self._routable)

    @property
    def completed(self) -> int:
        with self._lock:
            return len(self.results)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the per-worker dispatcher threads (idempotent)."""
        if self._started:
            return
        self._started = True
        self._started_at = self._clock()
        for w in self.workers:
            t = threading.Thread(
                target=self._dispatcher_loop, args=(w,),
                name=f"gw-{w.worker_id}", daemon=True,
            )
            self._threads.append(t)
            t.start()

    def close(self) -> None:
        """Stop dispatchers and shut every worker down (idempotent). Pending
        admitted requests are failed, not dropped."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self.queue.close()
        with self._lock:
            for cond in self._conds.values():
                cond.notify_all()
        for t in self._threads:
            t.join(timeout=30)
        # Terminate anything still pending so no caller waits forever.
        exc = RuntimeError("gateway closed before completion")
        with self._lock:
            pending = [r for box in self._inbox.values() for r in box]
            for box in self._inbox.values():
                box.clear()
            pending += [r for infl in self._inflight.values() for r in infl]
            pending += [r for _, _, r in self._retries]
            self._retries.clear()
        for req in self.queue.drain():
            pending.append(req)
        for req in pending:
            self._fail(req, exc)
        for w in self.workers:
            w.shutdown()

    def __enter__(self) -> "RenderGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def kill_worker(self, worker_id: str) -> None:
        """Induce a worker death (chaos hook): the worker stops responding
        and the next dispatch/ping surfaces the failure through the normal
        failover path — exactly how an uninduced death would."""
        self._by_id[worker_id].kill()

    # -- admission -----------------------------------------------------------

    def submit(self, req: RenderRequest) -> bool:
        """Non-blocking admission; False = backpressure (queue at depth;
        counted in ``gateway.rejected_total``). KeyError for a scene no
        worker hosts — a caller bug, not load."""
        if req.scene_id not in self.scene_ids:
            raise KeyError(f"no worker hosts scene {req.scene_id!r}")
        self.counts["submitted"] += 1
        get_registry().counter("gateway.submitted_total").inc()
        ok = self.queue.try_put(req)
        if not ok:
            self._count_rejected()
        return ok

    def _count_rejected(self) -> None:
        self.counts["rejected"] += 1
        get_registry().counter("gateway.rejected_total").inc()

    # -- routing -------------------------------------------------------------

    def _load(self, worker_id: str) -> int:
        # caller holds self._lock
        return len(self._inbox[worker_id]) + len(self._inflight[worker_id])

    def _pick_worker(self, req: RenderRequest) -> Optional[str]:
        """The routing policy (caller holds the lock):

        1. stream-sticky: a stream's frames keep hitting the worker that
           holds their frontend cache (re-pinned only when it dies);
        2. residency-aware placement (DESIGN.md §17): prefer the worker
           that has the scene PAGED IN right now — a committed-but-evicted
           copy still costs a page-in the resident worker skips. Workers
           that do not report residency (e.g. plain stubs) fall back to
           their committed set, collapsing this tier into the next;
        3. scene-affinity: prefer workers that already committed the scene,
           least-loaded among them — unless the best is deeper than
           ``spill_load``, in which case load wins (spill);
        4. least-loaded routable worker hosting the scene (stragglers are
           deprioritized, not excluded — a drained straggler still beats
           no worker at all).
        """
        cands = [
            w for w in self.workers
            if w.worker_id in self._routable and req.scene_id in w.scene_ids
        ]
        if not cands:
            return None
        if req.stream_id is not None:
            pinned = self._stream_route.get(req.stream_id)
            if pinned is not None and any(
                w.worker_id == pinned for w in cands
            ):
                return pinned

        def key(w):
            # (straggler?, not-resident?, not-affine?, load):
            # healthy+resident+idle first.
            affine = req.scene_id in w.committed_scene_ids()
            resident_fn = getattr(w, "resident_scene_ids", None)
            resident = (
                req.scene_id in resident_fn()
                if resident_fn is not None
                else affine
            )
            load = self._load(w.worker_id)
            if affine and load >= self.spill_load:
                affine = resident = False   # pressure: spill to least-loaded
            return (
                w.worker_id in self._stragglers,
                not resident,
                not affine,
                load,
                self._index[w.worker_id],
            )

        best = min(cands, key=key)
        return best.worker_id

    def _route(self, req: RenderRequest, now: float) -> None:
        """Assign ``req`` to a worker inbox (or fail it terminally)."""
        tracer = get_tracer()
        t0 = self._clock()
        with self._lock:
            wid = self._pick_worker(req)
            if wid is not None:
                w = self._by_id[wid]
                if req.scene_id not in w.committed_scene_ids():
                    # The worker will (re-)commit the scene lazily at
                    # dispatch; count it so failover re-commits are visible.
                    self.counts["recommits"] += 1
                    get_registry().counter("gateway.recommits_total").inc()
                if req.stream_id is not None:
                    self._stream_route[req.stream_id] = wid
                self._assigned[req.request_id] = wid
                self._attempts.setdefault(req.request_id, 1)
                self._inbox[wid].append(req)
                self._conds[wid].notify_all()
        if wid is None:
            self._fail(req, NoWorkerAvailable(
                f"no routable worker hosts scene {req.scene_id!r} "
                f"(routable: {sorted(self._routable)})"
            ))
            return
        stamps = getattr(req, "stamps", None)
        if stamps is not None:
            stamps["batch_form"] = t0     # request/batch_wait = inbox wait
        self.counts["routed"] += 1
        get_registry().counter("gateway.routed_total").inc()
        if tracer.enabled:
            tracer.complete(
                "gateway/route", t0, self._clock(), category="gateway",
                args={"request_id": req.request_id, "worker": wid,
                      "attempt": self._attempts.get(req.request_id, 1)},
            )

    # -- dispatcher threads --------------------------------------------------

    def _dispatcher_loop(self, w) -> None:
        wid = w.worker_id
        idx = self._index[wid]
        cond = self._conds[wid]
        inbox = self._inbox[wid]
        self._heartbeat(w, idx, 0.0)      # seed: alive before first dispatch
        while not self._stop.is_set():
            batch: Optional[List[RenderRequest]] = None
            with self._lock:
                if not inbox:
                    cond.wait(self._idle_wait)
                if inbox:
                    n = min(len(inbox), getattr(w, "max_batch", 8))
                    batch = [inbox.popleft() for _ in range(n)]
                    self._inflight[wid] = list(batch)
            if batch is None:
                self._heartbeat(w, idx, 0.0)
                continue
            t0 = self._clock()
            try:
                out = w.dispatch(batch)
            except Exception as exc:      # noqa: BLE001 — failover owns it
                with self._lock:
                    self._inflight[wid] = []
                    self._events.append(("death", wid, batch, exc))
                continue
            t1 = self._clock()
            self._steps[wid] += 1
            self._dispatches[wid] += 1
            self.monitor.report(idx, self._steps[wid], t1 - t0, self._clock())
            registry = get_registry()
            registry.counter("gateway.dispatches_total").inc()
            registry.histogram("gateway.dispatch_s").observe(t1 - t0)
            tracer = get_tracer()
            if tracer.enabled:
                tracer.complete(
                    "gateway/dispatch", t0, t1, category="gateway",
                    args={"worker": wid, "batch_size": len(batch)},
                )
            for req in batch:
                stamps = getattr(req, "stamps", None)
                if stamps is not None:
                    stamps["dispatch"] = t0
                    stamps["device_done"] = t1
            with self._lock:
                self._inflight[wid] = []
                self._events.append(("done", wid, batch, out, t0, t1))

    def _heartbeat(self, w, idx: int, latency_s: float) -> None:
        """Idle/seed liveness: ping and report so a quiet worker is not
        mistaken for a dead one (``dead_hosts`` keys on last-seen)."""
        try:
            w.ping()
        except Exception as exc:          # noqa: BLE001 — failover owns it
            with self._lock:
                self._events.append(("death", w.worker_id, [], exc))
            return
        self.monitor.report(
            idx, self._steps[w.worker_id], latency_s, self._clock()
        )

    # -- router --------------------------------------------------------------

    def step(self, now: Optional[float] = None) -> int:
        """One router turn (single driver thread): fold dispatcher events,
        police heartbeats, release due retries, route new admissions.
        Returns the number of requests routed or resolved this turn."""
        self.start()
        now = self._clock() if now is None else now
        n = 0

        with self._lock:
            events = list(self._events)
            self._events.clear()
        for ev in events:
            if ev[0] == "done":
                _, wid, batch, out, t0, t1 = ev
                for req in batch:
                    self._resolve(wid, req, out.get(req.request_id), t0, t1)
                    n += 1
            else:
                _, wid, batch, exc = ev
                self._handle_death(wid, batch, exc, now)

        # Heartbeat police: only after the fleet had a chance to report.
        if (
            self._started_at is not None
            and now - self._started_at > self.heartbeat_timeout_s
        ):
            for idx in self.monitor.dead_hosts(now):
                wid = self.workers[idx].worker_id
                if wid in self._routable:
                    self._handle_death(
                        wid, [],
                        WorkerTimeout(
                            f"worker {wid} missed heartbeats for "
                            f"{self.heartbeat_timeout_s}s"
                        ),
                        now,
                    )
        report = self.monitor.check(max(self._steps.values(), default=0))
        with self._lock:
            flagged = set()
            if report is not None:
                flagged = {
                    self.workers[h].worker_id for h in report.stragglers
                } & self._routable
            newly = flagged - self._stragglers
            self._stragglers = flagged
        for wid in newly:
            self.counts["stragglers"] += 1
            get_registry().counter("gateway.stragglers_total").inc()

        # Due retries route before fresh admissions (oldest work first).
        while True:
            with self._lock:
                if not self._retries or self._retries[0][0] > now:
                    break
                _, _, req = heapq.heappop(self._retries)
            self._route(req, now)
            n += 1
        for req in self.queue.drain():
            self._route(req, now)
            n += 1
        return n

    def _resolve(
        self, wid: str, req: RenderRequest, res, t0: float, t1: float
    ) -> None:
        rid = req.request_id
        self._assigned.pop(rid, None)
        if rid in self.results or rid in self.failed:
            # A worker declared dead that was merely slow may still deliver:
            # request ids make the retry idempotent — first completion won.
            self.counts["duplicates"] += 1
            get_registry().counter("gateway.duplicate_results_total").inc()
            return
        if res is None:
            self._retry(req, WorkerDiedResult(wid), self._clock())
            return
        t_res = self._clock()
        enq = req.enqueue_time if req.enqueue_time is not None else t0
        attempts = self._attempts.pop(rid, 1)
        self.results[rid] = GatewayResult(
            request_id=rid,
            image=res.image,
            latency_s=t_res - enq,
            worker_id=wid,
            attempts=attempts,
            batch_size=getattr(res, "batch_size", 1),
        )
        self._completed_by[wid] += 1
        self._latency.observe(t_res - enq)
        self.counts["completed"] += 1
        registry = get_registry()
        registry.counter("gateway.completed_total").inc()
        registry.histogram("gateway.latency_s").observe(t_res - enq)
        stamps = getattr(req, "stamps", None)
        if stamps is not None:
            stamps["resolve"] = t_res
            emit_request_spans(
                get_tracer(), rid, stamps,
                args={"worker": wid, "scene_id": req.scene_id,
                      "attempts": attempts},
            )

    def _fail(self, req: RenderRequest, exc: Exception) -> None:
        rid = req.request_id
        self._assigned.pop(rid, None)
        self._attempts.pop(rid, None)
        if rid in self.results or rid in self.failed:
            return
        self.failed[rid] = exc
        self.counts["failed"] += 1
        get_registry().counter("gateway.failed_total").inc()

    def _retry(self, req: RenderRequest, exc: Exception, now: float) -> None:
        """Schedule one bounded-backoff retry (or fail terminally)."""
        rid = req.request_id
        if rid in self.results or rid in self.failed:
            return
        attempt = self._attempts.get(rid, 1)
        if attempt > self.max_retries:
            self._fail(req, exc)
            return
        self._attempts[rid] = attempt + 1
        self._assigned[rid] = None
        t0 = self._clock()
        with self._lock:
            heapq.heappush(
                self._retries,
                (now + self.retry_backoff_s * attempt,
                 next(self._retry_seq), req),
            )
        self.counts["retries"] += 1
        get_registry().counter("gateway.retries_total").inc()
        tracer = get_tracer()
        if tracer.enabled:
            tracer.complete(
                "gateway/retry", t0, self._clock(), category="gateway",
                args={"request_id": rid, "attempt": attempt + 1,
                      "error": type(exc).__name__},
            )

    def _handle_death(
        self, wid: str, batch: List[RenderRequest], exc: Exception, now: float
    ) -> None:
        """Drain a dead worker and fail over everything it held."""
        t0 = self._clock()
        with self._lock:
            first = wid in self._routable
            self._routable.discard(wid)
            self._stragglers.discard(wid)
            drained = list(self._inbox[wid])
            self._inbox[wid].clear()
            inflight = list(self._inflight[wid])
            for sid, pinned in list(self._stream_route.items()):
                if pinned == wid:
                    del self._stream_route[sid]   # re-pin at next frame
        # Retry everything the worker held, but only requests still assigned
        # to IT — a heartbeat-death may already have re-routed the batch the
        # dispatch error is now reporting.
        for req in batch + drained + inflight:
            if self._assigned.get(req.request_id) == wid:
                self._retry(req, exc, now)
        if not first:
            return
        self.plan = plan_fleet(self._routable, self.devices_per_worker)
        self.counts["failovers"] += 1
        registry = get_registry()
        registry.counter("gateway.failovers_total").inc()
        registry.counter("gateway.worker_deaths_total").inc()
        registry.gauge("gateway.healthy_workers").set(len(self._routable))
        tracer = get_tracer()
        if tracer.enabled:
            tracer.complete(
                "gateway/failover", t0, self._clock(), category="gateway",
                args={"worker": wid, "error": type(exc).__name__,
                      "requeued": len(batch) + len(drained) + len(inflight),
                      "routable": sorted(self._routable),
                      "plan": self.plan.note if self.plan else "fleet empty"},
            )

    # -- driver --------------------------------------------------------------

    def outstanding(self) -> int:
        """Admitted requests not yet terminated (results or failed)."""
        with self._lock:
            in_boxes = sum(len(b) for b in self._inbox.values())
            in_flight = sum(len(b) for b in self._inflight.values())
            retries = len(self._retries)
            events = len(self._events)
        return len(self.queue) + in_boxes + in_flight + retries + events

    def run(
        self,
        load: Iterable[Tuple[float, RenderRequest]],
        realtime: bool = False,
        kill_worker: Optional[str] = None,
        kill_after: Optional[int] = None,
    ) -> Dict[int, GatewayResult]:
        """Serve a timed load of ``(arrival_offset_s, request)`` pairs
        (mirrors ``RenderServer.run``). ``kill_worker``/``kill_after`` is
        the chaos hook the CLI and failover tests use: once ``kill_after``
        requests completed, ``kill_worker`` dies mid-load and the run must
        still terminate every request. Returns the results map.
        """
        self.start()
        t_start = self._clock()
        killed = kill_worker is None or kill_after is None

        def maybe_kill():
            nonlocal killed
            if not killed and len(self.results) >= kill_after:
                self.kill_worker(kill_worker)
                killed = True

        for offset, req in load:
            if req.scene_id not in self.scene_ids:
                self._count_rejected()
                continue
            if realtime:
                while self._clock() - t_start < offset:
                    self.step()
                    maybe_kill()
                    gap = offset - (self._clock() - t_start)
                    if gap > 0:
                        time.sleep(min(gap, self._idle_wait))
            if not self.queue.try_put(req):
                self.step()               # service the backlog, retry once
                if not self.queue.try_put(req):
                    self._count_rejected()
                    continue
            self.counts["submitted"] += 1
            get_registry().counter("gateway.submitted_total").inc()
            self.step()
            maybe_kill()
        while self.outstanding():
            if self.step() == 0:
                time.sleep(min(self._idle_wait, 0.005))
            maybe_kill()
        self.step()                        # fold the final completions
        self.wall_s = self._clock() - t_start
        return self.results

    # -- stats ---------------------------------------------------------------

    def summary(self) -> dict:
        lat = self._latency.values()
        with self._lock:
            routable = sorted(self._routable)
            stragglers = sorted(self._stragglers)
        wall = self.wall_s
        done = len(self.results)
        return {
            "gateway": True,
            **self.counts,
            "completed": done,
            "healthy_workers": len(routable),
            "routable": routable,
            "stragglers": stragglers,
            "p50_ms": percentile(lat, 50) * 1e3,
            "p99_ms": percentile(lat, 99) * 1e3,
            "wall_s": wall,
            "fps": (done / wall) if wall else float("nan"),
            "plan": self.plan.note if self.plan is not None else "fleet empty",
            "workers": {
                w.worker_id: {
                    "alive": w.alive(),
                    "routable": w.worker_id in routable,
                    "dispatches": self._dispatches[w.worker_id],
                    "completed": self._completed_by[w.worker_id],
                }
                for w in self.workers
            },
        }

    def format(self) -> str:
        s = self.summary()
        lines = [
            f"gateway: {s['completed']}/{s['submitted']} completed "
            f"({s['rejected']} rejected, {s['failed']} failed, "
            f"{s['retries']} retries, {s['failovers']} failovers)",
            f"  latency p50={s['p50_ms']:.1f}ms p99={s['p99_ms']:.1f}ms  "
            f"fps={s['fps']:.1f}  fleet={s['healthy_workers']} healthy "
            f"({s['plan']})",
        ]
        for wid, st in sorted(s["workers"].items()):
            state = "routable" if st["routable"] else (
                "alive" if st["alive"] else "dead")
            lines.append(
                f"  worker {wid}: {st['completed']} completed / "
                f"{st['dispatches']} dispatches [{state}]"
            )
        return "\n".join(lines)


class WorkerTimeout(RuntimeError):
    """A worker missed its heartbeat window (hung, not provably dead)."""


class WorkerDiedResult(RuntimeError):
    """A dispatch 'succeeded' but the worker returned no result for this
    request id — treated as a per-request failure and retried."""

    def __init__(self, worker_id: str):
        super().__init__(f"worker {worker_id} returned no result")
        self.worker_id = worker_id
