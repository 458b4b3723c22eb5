"""Stream sessions: frame-coherent rendering over a committed handle (mirror
of ``repro.engine.stream``, DESIGN.md §15).

``Renderer.open_stream()`` returns a :class:`StreamRenderer`, a per-stream
session that exploits the temporal coherence of interactive camera paths.
The handle runs the render in two halves: the pose-heavy frontend (project
-> identify -> bin, and merge when sharded) and the pixel-producing backend
(bitmask -> compact -> rasterize). The stream keeps a bounded LRU cache of
``FrontendResult``s keyed by :func:`pose_key`, the exact float32 bits of
the pose and intrinsics the frontend consumes, so a frame whose pose was
seen before (an orbit lap, a paused viewer, a replayed path) skips straight
to the backend.

A background speculation worker extrapolates the stream's recent camera
trajectory and pre-runs the FRONTEND for the predicted next pose(s),
parking the binned table in the same cache:

  * successor replay: the pose observed to follow the current one last
    time around (exact on looping or replayed paths);
  * constant-velocity fallback: ``R_pred = (R1 R0^T) R1``,
    ``t_pred = 2 t1 - t0`` in float32 (exact on linear dollies whose steps
    are float32-representable).

The invariant is **verify-or-discard, never approximate**: a speculative
entry is used only when the arriving camera's key matches it exactly, so a
stream's frames are bitwise those of stateless rendering by construction;
a wrong prediction costs device time, never pixels. The prediction queue
holds ``spec_depth`` cameras (drop-oldest, counted in
``spec.dropped_total``) and the cache ``cache_frames`` entries, so a
runaway stream cannot grow device memory without bound.

Ordering on the card: the speculative frontend runs on the worker thread's
current CUDA stream, which is the same default stream the foreground
frames use, under ``_DEVICE_DISPATCH_LOCK``. A cached entry's kernels are
therefore queued before any backend that reads it. The worker enters its
own ``torch.inference_mode()`` (the mode is thread-local).

Observability: the cache registers with the render-cache registry
(``render_cache_info()['<handle>.streamN']``), the speculation lifecycle
is counted in the metrics registry (``stream.*`` / ``spec.*``) and spanned
in the trace (``spec/verify`` per frame, ``spec/run`` per speculative
frontend, ``stream/frontend`` and ``stream/backend``), and
``obs.validate_stream_trace`` cross-checks spans against counters.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.camera import Camera
from repro_torch.core.pipeline import register_render_cache, unregister_render_cache
from repro_torch.obs import get_registry, get_tracer
from repro_torch.utils import pytree_bytes

_STREAM_SEQ = itertools.count()

# ONE dispatch lock for every stream in the process (foreground frames AND
# speculation workers): it orders a speculative frontend against the
# foreground's work on the shared CUDA stream, and device work is
# serialized by the card anyway; the speculation win is caching, not
# overlap.
_DEVICE_DISPATCH_LOCK = threading.Lock()


def _pose_array(x) -> np.ndarray:
    """A pose array in the dtype the frontend consumes: projection takes R
    and t as float32, so float64 collapses to float32 (the JAX package does
    the same with x64 off)."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return a


def pose_key(cam) -> bytes:
    """The exact quantized pose/config signature of one camera.

    'Quantized' means canonicalized to the bits the frontend consumes:
    intrinsics as float32 (projection multiplies float32 tensors by them),
    pose arrays through the float64 -> float32 collapse, and nothing
    coarser. Two cameras share a key iff the frontend would receive
    identical input bits, which is what makes exact-key reuse bitwise-safe.
    Injective on distinct canonical poses (every segment is fixed-length or
    follows a length-determining dtype tag) and stable on bit-identical
    ones (pure bytes, no id() or hash()). The bytes equal the JAX
    package's key for the same camera.
    """
    R = _pose_array(cam.R)
    t = _pose_array(cam.t)
    return b"|".join((
        np.array([cam.width, cam.height], np.int64).tobytes(),
        np.array([cam.znear, cam.zfar], np.float64).tobytes(),
        R.dtype.str.encode(), R.tobytes(),
        t.dtype.str.encode(), t.tobytes(),
        np.array([cam.fx, cam.fy, cam.cx, cam.cy], np.float32).tobytes(),
    ))


def _geometry(cam) -> tuple:
    return (cam.width, cam.height, cam.znear, cam.zfar)


def predict_next_camera(c0, c1) -> Optional[Camera]:
    """Constant-velocity pose extrapolation: the camera that continues the
    ``c0 -> c1`` motion one more step.

    Rotation advances by the observed relative rotation (``R_d = R1 R0^T``,
    ``R_pred = R_d R1``); translation and intrinsics extrapolate linearly in
    float32. For poses that follow such a path in exactly representable
    steps the prediction is bit-exact; anywhere else it merely misses the
    exact-match cache. Returns None when the static geometry changed.
    """
    if _geometry(c0) != _geometry(c1):
        return None
    R0, t0 = _pose_array(c0.R), _pose_array(c0.t)
    R1, t1 = _pose_array(c1.R), _pose_array(c1.t)
    # A component that did not move is predicted to stay put bit-exactly
    # (the general formula would round: (R1 R0^T) R1 != R1 bitwise for a
    # generic rotation even when R0 == R1).
    if np.array_equal(R0, R1):
        R_pred = R1
    else:
        R_pred = ((R1 @ R0.T) @ R1).astype(R1.dtype)
    if np.array_equal(t0, t1):
        t_pred = t1
    else:
        t_pred = (2.0 * t1 - t0).astype(t1.dtype)
    f32 = np.float32

    def lin(a, b):
        a, b = f32(a), f32(b)
        return b if a == b else f32(2.0 * b - a)

    return dataclasses.replace(
        c1,
        R=R_pred,
        t=t_pred,
        fx=lin(c0.fx, c1.fx),
        fy=lin(c0.fy, c1.fy),
        cx=lin(c0.cx, c1.cx),
        cy=lin(c0.cy, c1.cy),
    )


@dataclasses.dataclass
class _CacheEntry:
    front: Any                  # FrontendResult (device tensors)
    speculative: bool           # parked by the worker, not yet verified
    used: bool = False          # served at least one frame


class StreamRenderer:
    """One interactive camera stream over a committed :class:`Renderer`.

    ``render(cam)`` is the synchronous per-frame entry point; frames are
    expected in path order from ONE caller (the predictor learns from that
    order). Thread-safe with respect to its own speculation worker. Close
    the stream (or its handle, which closes it) to stop the worker and drop
    the cache from the registry.
    """

    def __init__(self, handle, *, cache_frames: int = 32, spec_depth: int = 2,
                 speculate: bool = True):
        if cache_frames < 1:
            raise ValueError(f"cache_frames must be >= 1, got {cache_frames}")
        if spec_depth < 0:
            raise ValueError(f"spec_depth must be >= 0, got {spec_depth}")
        self._handle = handle
        self.cache_frames = cache_frames
        self.spec_depth = spec_depth
        self.speculate = speculate and spec_depth > 0
        self.name = f"{handle.cache_name}.stream{next(_STREAM_SEQ)}"

        self._lock = threading.Lock()          # cache + predictor state
        self._device_lock = _DEVICE_DISPATCH_LOCK
        self._cache: "OrderedDict[bytes, _CacheEntry]" = OrderedDict()
        self._succ: "OrderedDict[bytes, Camera]" = OrderedDict()
        self._geom: Optional[tuple] = None
        self._prev: "deque[Camera]" = deque(maxlen=2)
        self._counters = {
            "frames": 0, "hits": 0, "misses": 0,
            "spec_hits": 0, "spec_runs": 0,
            "spec_dropped": 0, "spec_discarded": 0,
            "invalidations": 0,
        }

        self._spec_queue: "deque[Camera]" = deque()
        self._spec_event = threading.Event()
        self._spec_busy = False
        self._spec_idle = threading.Condition(self._lock)
        self._spec_thread: Optional[threading.Thread] = None
        self._closed = False

        register_render_cache(self.name, info=self.cache_info, clear=self.cache_clear)

    # -- cache bookkeeping (registry contract) -------------------------------

    def cache_info(self) -> dict:
        with self._lock:
            return {
                "hits": self._counters["hits"],
                "misses": self._counters["misses"],
                "currsize": len(self._cache),
                "maxsize": self.cache_frames,
            }

    def cache_bytes(self) -> int:
        """Device bytes held by the cached FrontendResults: summed into
        ``Renderer.frontend_cache_mb()`` and charged against the residency
        budget."""
        with self._lock:
            return sum(pytree_bytes(e.front) for e in self._cache.values())

    def cache_clear(self) -> None:
        """Drop every cached frontend result and reset hit/miss counts (the
        ``render_cache_clear()`` contract). Unused speculative entries count
        as discarded."""
        with self._lock:
            self._drop_all_entries_locked()
            self._counters["hits"] = 0
            self._counters["misses"] = 0

    def _drop_all_entries_locked(self) -> None:
        discarded = sum(1 for e in self._cache.values() if e.speculative and not e.used)
        if discarded:
            self._counters["spec_discarded"] += discarded
            get_registry().counter("spec.discarded_total").inc(discarded)
        self._cache.clear()
        self._succ.clear()
        self._prev.clear()
        dropped = len(self._spec_queue)
        if dropped:
            self._counters["spec_dropped"] += dropped
            get_registry().counter("spec.dropped_total").inc(dropped)
        self._spec_queue.clear()

    def _evict_overflow_locked(self) -> None:
        while len(self._cache) > self.cache_frames:
            _, entry = self._cache.popitem(last=False)
            if entry.speculative and not entry.used:
                self._counters["spec_discarded"] += 1
                get_registry().counter("spec.discarded_total").inc()
        while len(self._succ) > 4 * self.cache_frames:
            self._succ.popitem(last=False)

    # -- the per-frame entry point -------------------------------------------

    def render(self, cam: Camera, background=None):
        """Render one stream frame, bitwise ``handle.render(cam, background)``.

        Exact pose-key hit: the cached FrontendResult feeds the backend
        directly. Miss: frontend + backend run and the fresh result is
        cached. Either way the trajectory tracker learns the transition and
        wakes the speculation worker.
        """
        if self._closed:
            raise RuntimeError("StreamRenderer is closed")
        registry = get_registry()
        tracer = get_tracer()
        key = pose_key(cam)
        geom = _geometry(cam)

        t_verify0 = tracer.clock()
        with self._lock:
            if self._geom is not None and geom != self._geom:
                # Mid-stream geometry change (a resolution bump): every
                # cached table was binned for another grid.
                self._drop_all_entries_locked()
                self._counters["invalidations"] += 1
                registry.counter("stream.invalidations_total").inc()
            self._geom = geom
            entry = self._cache.get(key)
            if entry is not None:
                self._cache.move_to_end(key)
                hit = True
                self._counters["hits"] += 1
                if entry.speculative and not entry.used:
                    self._counters["spec_hits"] += 1
                    registry.counter("spec.hits_total").inc()
                entry.used = True
                front = entry.front
            else:
                hit = False
                self._counters["misses"] += 1
            self._counters["frames"] += 1
        registry.counter("stream.frames_total").inc()
        registry.counter("stream.hits_total" if hit else "stream.misses_total").inc()
        tracer.complete(
            "spec/verify", t_verify0, tracer.clock(), category="spec",
            args={"stream": self.name, "hit": hit},
        )

        if not hit:
            t0 = tracer.clock()
            with self._device_lock:
                front = self._handle.render_frontend(cam)
            tracer.complete("stream/frontend", t0, tracer.clock(), category="stream",
                            args={"stream": self.name})
            with self._lock:
                # A speculative run may have raced us to the same key; the
                # results are bitwise equal (same code, same input bits).
                self._cache[key] = _CacheEntry(front, speculative=False, used=True)
                self._cache.move_to_end(key)
                self._evict_overflow_locked()

        t0 = tracer.clock()
        with self._device_lock:
            out = self._handle.render_backend(front, cam, background)
        tracer.complete("stream/backend", t0, tracer.clock(), category="stream",
                        args={"stream": self.name})

        self._observe_trajectory(cam, key)
        return out

    # -- trajectory tracking + speculation -----------------------------------

    def _observe_trajectory(self, cam: Camera, key: bytes) -> None:
        with self._lock:
            if self._prev:
                prev_key = pose_key(self._prev[-1])
                self._succ[prev_key] = cam
                self._succ.move_to_end(prev_key)
            self._prev.append(cam)
            if not self.speculate:
                return
            for p in self._predict_locked(cam, key):
                self._spec_queue.append(p)
                if len(self._spec_queue) > self.spec_depth:
                    self._spec_queue.popleft()
                    self._counters["spec_dropped"] += 1
                    get_registry().counter("spec.dropped_total").inc()
        if self.speculate:
            self._ensure_spec_worker()
            self._spec_event.set()

    def _predict_locked(self, cam: Camera, key: bytes) -> List[Camera]:
        """Predicted next camera(s): successor replay first, constant
        velocity as the fallback. Predictions already cached are skipped, so
        steady-state replay costs no device work."""
        preds: List[Camera] = []
        succ = self._succ.get(key)
        if succ is not None and _geometry(succ) == self._geom:
            # Replay is authoritative once this transition has been seen;
            # extrapolating a second pose on top would burn a frontend a
            # frame that can never hit.
            preds.append(succ)
        elif len(self._prev) == 2:
            cv = predict_next_camera(self._prev[0], self._prev[1])
            if cv is not None:
                preds.append(cv)
        return [p for p in preds if pose_key(p) not in self._cache][: max(self.spec_depth, 0)]

    def _ensure_spec_worker(self) -> None:
        if self._spec_thread is None or not self._spec_thread.is_alive():
            with self._lock:
                if self._closed:
                    return
                if self._spec_thread is not None and self._spec_thread.is_alive():
                    return
                self._spec_thread = threading.Thread(
                    target=self._spec_loop, name=f"{self.name}-spec", daemon=True,
                )
                self._spec_thread.start()

    def _spec_loop(self) -> None:
        # inference_mode is thread-local: the worker enters its own.
        with torch.inference_mode():
            self._spec_serve()

    def _spec_serve(self) -> None:
        registry = get_registry()
        tracer = get_tracer()
        while True:
            self._spec_event.wait()
            self._spec_event.clear()
            if self._closed:
                return
            while True:
                with self._lock:
                    cam = None
                    while self._spec_queue:
                        c = self._spec_queue.popleft()
                        if pose_key(c) in self._cache:
                            continue        # already cached: nothing to do
                        cam = c
                        break
                    if cam is None:
                        self._spec_busy = False
                        self._spec_idle.notify_all()
                        break
                    self._spec_busy = True
                try:
                    t0 = tracer.clock()
                    with self._device_lock:
                        front = self._handle.render_frontend(cam)
                    t1 = tracer.clock()
                except Exception:           # noqa: BLE001 — a failed
                    # speculation must never kill the stream; the real frame
                    # takes the miss path and surfaces any real error.
                    with self._lock:
                        self._spec_busy = False
                        self._spec_idle.notify_all()
                    continue
                with self._lock:
                    if self._closed:
                        self._spec_busy = False
                        self._spec_idle.notify_all()
                        return
                    # Span + counter in one critical section, so the
                    # cross-check spec/run == spec.runs_total never races.
                    registry.counter("spec.runs_total").inc()
                    self._counters["spec_runs"] += 1
                    tracer.complete("spec/run", t0, t1, category="spec",
                                    args={"stream": self.name})
                    if _geometry(cam) == self._geom:
                        k = pose_key(cam)
                        if k not in self._cache:
                            self._cache[k] = _CacheEntry(front, speculative=True)
                            self._evict_overflow_locked()
            if self._closed:
                return

    def wait_spec_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the speculation queue is drained and the worker is
        parked (deterministic tests and measurements). True on idle."""
        with self._lock:
            return self._spec_idle.wait_for(
                lambda: not self._spec_queue and not self._spec_busy, timeout=timeout,
            )

    # -- introspection / lifecycle -------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            hits, misses = self._counters["hits"], self._counters["misses"]
            return {
                "stream": self.name,
                "cache": {
                    "hits": hits,
                    "misses": misses,
                    "currsize": len(self._cache),
                    "maxsize": self.cache_frames,
                },
                "hit_rate": hits / max(hits + misses, 1),
                "cache_bytes": sum(pytree_bytes(e.front) for e in self._cache.values()),
                **self._counters,
            }

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop the speculation worker, discard the cache (unused
        speculative entries count as discarded), and unregister from the
        render-cache registry. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._spec_event.set()
        thread = self._spec_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=30.0)
        with self._lock:
            self._drop_all_entries_locked()
        unregister_render_cache(self.name)
        self._handle._forget_stream(self)

    def __enter__(self) -> "StreamRenderer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if self._closed else "open"
        return (
            f"<StreamRenderer {self.name} {state} "
            f"cache={len(self._cache)}/{self.cache_frames} "
            f"spec_depth={self.spec_depth}>"
        )
