"""Bounded render-request queue with backpressure (a copy of the JAX
package's ``repro.serving.queue``, DESIGN.md §9).

Pure Python by design: no torch import, so the admission layer (and its
tests) runs anywhere — the first device touch is the engine handle's
dispatch. Thread-safe and async-friendly: ``put``/``get_batch``
block with timeouts (a thread-pool bridge works under asyncio), and the
non-blocking ``try_put``/``drain`` variants poll cleanly from an event loop.

A ``RenderRequest`` carries everything the bucketer needs to key the static
jit signature (scene id + render config + camera geometry) plus the dynamic
camera itself. The camera is duck-typed — anything exposing
width/height/znear/zfar (and, by dispatch time, R/t/fx/fy/cx/cy) works, so
pure-Python tests can use stubs.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import get_registry  # pure Python


class QueueFull(Exception):
    """Raised by ``put_nowait`` when the queue is at depth — the caller must
    shed load or retry later (backpressure is explicit, never silent)."""


class QueueClosed(Exception):
    """Raised on ``put`` after ``close()`` — late arrivals are rejected."""


@dataclasses.dataclass(frozen=True)
class RenderRequest:
    """One camera to render against one scene under one config.

    ``cfg`` is treated as an opaque hashable (a ``RenderConfig`` in
    production); ``deadline`` is an absolute time on the server clock or
    None for best-effort; ``enqueue_time`` is stamped by the queue.
    """

    request_id: int
    scene_id: str
    camera: Any
    cfg: Any
    deadline: Optional[float] = None
    enqueue_time: Optional[float] = None
    # Stream affinity (DESIGN.md §15): frames of one interactive camera
    # stream set a shared stream_id so they bucket together and route to
    # that stream's session (its frontend cache + speculation worker)
    # instead of the stateless batch path. None = stateless request.
    stream_id: Optional[str] = None
    # Lifecycle stamps (DESIGN.md §14): monotonic clock readings keyed
    # enqueue/batch_form/dispatch/device_done/resolve, written by the queue,
    # scheduler, and server as the request moves through them. A mutable
    # dict on a frozen dataclass on purpose — the dict OBJECT survives the
    # ``dataclasses.replace`` copies this request goes through, so every
    # phase writes into one shared map; compare=False keeps it out of the
    # generated ``__eq__``.
    stamps: Dict[str, float] = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    def signature(self) -> tuple:
        """The bucketing key: everything the compiled executable specializes
        on, plus the scene id (one ``render_batch`` call serves one scene).
        Mirrors ``core.pipeline.batch_signature`` with scene identity added.
        Stream frames additionally key on their ``stream_id`` — that is the
        whole affinity mechanism: a stream's frames can only ever share a
        bucket with each other, and the FIFO queue + in-order bucket appends
        preserve per-stream frame order through to the session dispatch.
        """
        cam = self.camera
        sig = (self.scene_id, self.cfg, cam.width, cam.height,
               cam.znear, cam.zfar)
        if self.stream_id is not None:
            sig += ("stream", self.stream_id)
        return sig


class RequestQueue:
    """FIFO of ``RenderRequest`` with bounded depth.

    Depth bounds memory and converts overload into backpressure at the edge
    instead of unbounded latency in the scheduler. ``accepted`` counts
    admitted requests; ``rejected`` counts failed put ATTEMPTS (a caller that
    retries after backpressure adds one per failed try — dropped-request
    accounting lives in ``ServingStats.rejected``, not here).
    """

    def __init__(self, maxsize: int = 64, clock=None):
        if maxsize <= 0:
            raise ValueError(f"queue maxsize must be positive, got {maxsize}")
        self.maxsize = maxsize
        self._clock = clock or time.monotonic
        self._items: List[RenderRequest] = []
        self._cond = threading.Condition()
        self._closed = False
        self.accepted = 0
        self.rejected = 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def _count_rejected(self) -> None:
        # Backpressure used to be visible only to the caller; the registry
        # counter makes it a first-class signal (--metrics-json, gateway
        # admission dashboards). Counts failed put ATTEMPTS, same as the
        # local ``rejected`` field it mirrors.
        self.rejected += 1
        get_registry().counter("queue.rejected_total").inc()

    def _admit(self, req: RenderRequest) -> None:
        if req.enqueue_time is None:
            req = dataclasses.replace(req, enqueue_time=self._clock())
        stamps = getattr(req, "stamps", None)   # duck-typed request stubs
        if stamps is not None:
            stamps.setdefault("enqueue", req.enqueue_time)
        self._items.append(req)
        self.accepted += 1
        self._cond.notify_all()

    def put(self, req: RenderRequest, timeout: Optional[float] = None) -> bool:
        """Enqueue; block up to ``timeout`` while full. Returns False (and
        counts a rejection) if the queue stayed full — the backpressure
        signal callers must handle."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while len(self._items) >= self.maxsize and not self._closed:
                remaining = None if deadline is None else deadline - self._clock()
                if remaining is not None and remaining <= 0:
                    self._count_rejected()
                    return False
                self._cond.wait(remaining)
            if self._closed:
                raise QueueClosed("put() on a closed queue")
            self._admit(req)
            return True

    def put_nowait(self, req: RenderRequest) -> None:
        """Enqueue or raise ``QueueFull`` immediately."""
        with self._cond:
            if self._closed:
                raise QueueClosed("put_nowait() on a closed queue")
            if len(self._items) >= self.maxsize:
                self._count_rejected()
                raise QueueFull(f"queue at depth {self.maxsize}")
            self._admit(req)

    def try_put(self, req: RenderRequest) -> bool:
        """Non-raising ``put_nowait`` for poll-style callers."""
        try:
            self.put_nowait(req)
            return True
        except QueueFull:
            return False

    def drain(self, max_n: Optional[int] = None) -> List[RenderRequest]:
        """Dequeue up to ``max_n`` requests without blocking (FIFO order)."""
        with self._cond:
            n = len(self._items) if max_n is None else min(max_n, len(self._items))
            out, self._items = self._items[:n], self._items[n:]
            if out:
                self._cond.notify_all()
            return out

    def get_batch(
        self, max_n: Optional[int] = None, timeout: Optional[float] = None
    ) -> List[RenderRequest]:
        """Blocking ``drain``: wait up to ``timeout`` for at least one
        request; returns [] on timeout or when closed and empty."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while not self._items and not self._closed:
                remaining = None if deadline is None else deadline - self._clock()
                if remaining is not None and remaining <= 0:
                    return []
                self._cond.wait(remaining)
            n = len(self._items) if max_n is None else min(max_n, len(self._items))
            out, self._items = self._items[:n], self._items[n:]
            if out:
                self._cond.notify_all()
            return out

    def close(self) -> None:
        """Stop admissions and wake all waiters; pending items still drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
