"""Fleet workers: one owned RenderServer per worker (mirror of
``repro.gateway.worker``, DESIGN.md §16).

A *worker* is the unit the gateway routes to, health-checks, and fails over
— one ``RenderServer`` on one device plus the scenes it can host. Two
implementations share one duck-typed contract (``RenderGateway`` never
imports either directly):

  * :class:`InprocWorker` (here) owns a ``RenderServer`` in THIS process —
    the test/e2e form, where worker death is a flag and bitwise parity with
    a direct single-server run is assertable in one process;
  * :class:`~repro_torch.gateway.transport.SubprocessWorker` owns a child
    process speaking the line-JSON protocol
    (``repro_torch.gateway.worker_main``) — the CLI form, where each worker
    has its own torch runtime and CUDA context and death is a real SIGKILL.

The contract (all methods may raise :class:`WorkerDied`):

  worker_id : str           stable routing key
  scene_ids : frozenset     scenes this worker can host (admission screen)
  max_batch : int           batch the gateway hands over per dispatch
  alive()                   liveness predicate (no I/O beyond a poll)
  committed_scene_ids()     scenes with a committed handle (affinity routing)
  resident_scene_ids()      OPTIONAL: committed scenes currently paged in
                            (residency-aware placement, DESIGN.md §17);
                            absent -> routed on the committed set alone
  commit(scene_id, cfg)     pre-commit / failover re-commit
  dispatch(requests)        -> {request_id: result-with-.image}, blocking
  ping()                    cheap liveness round-trip (idle heartbeat)
  kill()                    induce death (tests / chaos CLI flag)
  shutdown()                graceful close (releases handles / child proc)

``dispatch`` is all-or-nothing by design: a worker that dies mid-batch
raises for the WHOLE batch and completes none of it, so the gateway's
retry accounting never has to reason about partially-applied batches
(request ids make the retries idempotent at resolve time regardless).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from repro_torch.gateway.errors import WorkerDied
from repro_torch.serving.queue import RenderRequest
from repro_torch.serving.server import RenderServer
from repro_torch.utils.misc import ITEM_SHARDING

__all__ = ["InprocWorker", "WorkerDied", "strip_stamps"]


def strip_stamps(req: RenderRequest) -> RenderRequest:
    """A copy of ``req`` whose lifecycle-stamp dict is disabled.

    The GATEWAY owns the request lifecycle spans (enqueue -> route ->
    dispatch -> resolve on the gateway clock); an in-process worker's
    ``RenderServer`` would otherwise stamp and emit a second ``request``
    span family onto the same per-request trace lane, partially
    overlapping the gateway's and breaking the per-lane nesting contract
    (``validate_chrome_trace``). ``stamps=None`` is the documented
    duck-typed opt-out every stamp site already checks for.
    """
    copy = dataclasses.replace(req)
    object.__setattr__(copy, "stamps", None)
    return copy


# One process-wide dispatch lock for in-process workers. Their servers share
# one card: the dispatches would serialize on it anyway, and one at a time
# keeps every kernel launch attributable to the dispatch that made it (the
# per-dispatch launch counts the card checks read). It is the worker's OWN
# lock: the stream path inside ``RenderServer`` takes
# ``engine/stream.py::_DEVICE_DISPATCH_LOCK``, which is not reentrant, so
# holding that one around ``server.drain()`` would deadlock the first stream
# frame. Subprocess workers have their own runtimes and need no such lock.
_INPROC_DISPATCH_LOCK = threading.Lock()


class InprocWorker:
    """An in-process fleet member: an owned :class:`RenderServer` on
    ``device`` (CUDA unless the caller names another; no fallback).

    ``kill()`` flips a flag checked at every dispatch/ping entry — the
    in-process simulation of a node loss: requests already handed to a
    dispatch complete or fail atomically with it, everything after raises
    :class:`WorkerDied`. ``shutdown()`` still closes the underlying server
    even after a kill, so a test's killed worker releases its handles.
    ``mesh=`` (several devices, ROADMAP item 8) raises
    ``NotImplementedError``, as ``RenderServer(mesh=)`` does.
    """

    def __init__(
        self,
        worker_id: str,
        scenes,
        *,
        device=None,
        mesh=None,
        max_batch: int = 8,
        max_wait: float = 0.05,
        queue_depth: int = 64,
        scene_shards: int = 1,
        device_budget_mb: Optional[float] = None,
        clock=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                f"InprocWorker(mesh=...) is not ported yet (ROADMAP queue 1, item "
                f"{ITEM_SHARDING}); a worker serves from one device (device=...)"
            )
        self.worker_id = worker_id
        self.scene_ids = frozenset(scenes)
        self.max_batch = max_batch
        kwargs = {} if clock is None else {"clock": clock}
        self.server = RenderServer(
            scenes,
            device=device,
            max_batch=max_batch,
            max_wait=max_wait,
            queue_depth=queue_depth,
            scene_shards=scene_shards,
            device_budget_mb=device_budget_mb,
            **kwargs,
        )
        self._alive = True
        self._closed = False

    # -- liveness ------------------------------------------------------------

    def alive(self) -> bool:
        return self._alive

    def _check_alive(self) -> None:
        if not self._alive:
            raise WorkerDied(f"worker {self.worker_id} is dead")

    def ping(self) -> None:
        self._check_alive()

    def kill(self) -> None:
        """Simulated node loss: stop serving, leave state for shutdown()."""
        self._alive = False

    # -- scenes --------------------------------------------------------------

    def committed_scene_ids(self):
        return self.server.committed_scene_ids

    def resident_scene_ids(self):
        """Committed scenes currently paged IN on this worker's device
        (DESIGN.md §17) — the gateway's residency-aware placement signal.
        Optional in the worker contract: workers without it are routed on
        their committed set alone."""
        return self.server.resident_scene_ids

    def commit(self, scene_id: str, cfg) -> None:
        self._check_alive()
        with _INPROC_DISPATCH_LOCK:
            self.server.commit(scene_id, cfg)

    # -- dispatch ------------------------------------------------------------

    def dispatch(self, requests: List[RenderRequest]) -> Dict[int, object]:
        """Run ``requests`` through the owned server; returns
        ``{request_id: RequestResult}`` (images as CPU tensors). The
        server's own bucketing batches same-signature requests and pads to
        the server's fixed dispatch shape — which is exactly what makes a
        worker's output bitwise-identical to a direct single-server run
        with the same settings."""
        self._check_alive()
        with _INPROC_DISPATCH_LOCK:
            self._check_alive()
            for req in requests:
                wreq = strip_stamps(req)
                if not self.server.submit(wreq):
                    # Worker-queue backpressure: drain what is pending and
                    # retry once; a second failure means the gateway handed
                    # over more than queue_depth in one batch (caller bug).
                    self.server.drain()
                    if not self.server.submit(wreq):
                        raise WorkerDied(
                            f"worker {self.worker_id} queue jammed at depth "
                            f"{self.server.queue.maxsize}"
                        )
            self.server.drain()
        out = {}
        for req in requests:
            res = self.server.results.pop(req.request_id, None)
            if res is None:
                raise WorkerDied(
                    f"worker {self.worker_id} lost request {req.request_id}"
                )
            out[req.request_id] = res
        return out

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._alive = False
        self.server.close()

    def __repr__(self) -> str:
        state = "alive" if self._alive else "dead"
        return (
            f"<InprocWorker {self.worker_id} {state} "
            f"scenes={sorted(self.scene_ids)}>"
        )
