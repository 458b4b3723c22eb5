"""The session-style rendering handle (mirror of ``repro.engine.handle`` for
a commit on one device, DESIGN.md §11).

``engine.open(scene, cfg)`` commits the scene to the device once and
returns a :class:`Renderer`:

  * ``scene_shards=D`` (or a pre-sharded ``ShardedScene``) commits D
    logical shards of the gaussian axis on the handle's device: the layout
    is staged on the host through the refcounted scene-layout cache
    (``serving/sharded.py``) and moved to the device once; renders are
    bitwise those of D = 1 (DESIGN.md §10);

  * ``.render(cam)`` / ``.render_batch(cams, pad_to=...)`` are the
    synchronous entry points; a batch renders lane by lane through the same
    ``render``, so every lane is bitwise equal to a single render;
  * ``.render_frontend(cam)`` / ``.render_backend(front, cam)`` are the two
    halves of ``render``;
  * ``.submit(cam)`` returns a ``concurrent.futures.Future`` served by an
    internal queue -> bucketing-scheduler worker thread; a request that
    fails resolves its own future with the exception and the worker lives
    on;
  * the handle owns a per-geometry cache of its render callables,
    registered with ``core.pipeline.register_render_cache`` so
    ``render_cache_info()`` covers it;
  * ``.close()`` (or the context manager) drains the worker, fails what it
    never resolved, unregisters the cache and releases the scene and its
    own scene-layout reference.

Not ported yet, and raising ``NotImplementedError`` that names the ROADMAP
item: meshes and several devices (queue 1, item 8);
tile-parameter autotune, paged residency and stream sessions (item 11);
the module-default handles behind the JAX package's deprecated free
functions (item 6).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import weakref
from concurrent.futures import Future
from concurrent.futures import wait as _futures_wait
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.pipeline import (
    CameraBatch,
    FrontendResult,
    RenderConfig,
    RenderResult,
    batch_renderer,
    check_config,
    register_render_cache,
    render,
    render_backend,
    render_frontend,
    resolve_feature_gather,
    unregister_render_cache,
)
from repro_torch.core.projection import projected_bytes_per_gaussian
from repro_torch.launch.mesh import render_mesh_shards
from repro_torch.obs import emit_request_spans, get_registry, get_tracer
from repro_torch.serving.bucketing import BucketingScheduler, padded_size
from repro_torch.serving.queue import QueueClosed, RequestQueue
from repro_torch.serving.sharded import (
    acquire_scene_layout,
    pad_camera_batch,
    release_scene_layout,
)
from repro_torch.sharding.scene import SceneLike, ShardedScene
from repro_torch.utils import pytree_bytes, resolve_device
from repro_torch.utils.misc import not_ported

_HANDLE_SEQ = itertools.count()
_FN_CACHE_MAX = 64          # per-handle cached-renderer bound
_ITEM_SHARDING = "8: sharding along the gaussian axis"
_ITEM_STREAMS = "11: streams, residency, autotune"
_ITEM_DEFAULTS = "6: the module-default handles behind the deprecated free functions"
# open() options of the JAX handle the port does not take yet -> queue item.
_UNPORTED_OPTIONS = {
    "devices": _ITEM_SHARDING,
    "mesh": _ITEM_SHARDING,
    "tile_params": _ITEM_STREAMS,
    "autotune_opts": _ITEM_STREAMS,
    "residency": _ITEM_STREAMS,
}


@dataclasses.dataclass(frozen=True)
class _Submitted:
    """One queued ``submit()`` request: the camera plus its future. Within
    one handle the config and scene are fixed, so the bucketing signature
    is the camera geometry alone (one bucket per resolution)."""

    camera: Any
    future: Future
    enqueue_time: Optional[float] = None
    request_id: str = ""
    # Lifecycle stamps: the dict object rides through the queue's
    # dataclasses.replace copies, so every phase writes into one map.
    stamps: Dict[str, float] = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    def signature(self) -> tuple:
        c = self.camera
        return (c.width, c.height, c.znear, c.zfar)


class Renderer:
    """A committed (scene, config) pair on one device with render/serve
    entry points. Construct through :func:`open`. ``submit`` is the
    thread-safe entry; the internal worker owns all device work for the
    futures path."""

    def __init__(
        self,
        scene: SceneLike,
        cfg: RenderConfig,
        *,
        device=None,
        scene_shards: Union[str, int] = "auto",
        device_budget_mb: Optional[float] = None,
        max_batch: int = 8,
        max_wait: float = 0.05,
        queue_depth: int = 64,
        clock=time.monotonic,
    ):
        shards = self._resolve_shards(scene, cfg, scene_shards)
        # One device: the shard axis stays logical (render_mesh_shards over
        # one device is 1), so neither budget term divides by D.
        phys = render_mesh_shards(1, shards)
        cfg_updates = {}
        if cfg.scene_shards != shards:
            cfg_updates["scene_shards"] = shards
        if shards > 1 and cfg.feature_gather == "auto":
            cfg_updates["feature_gather"] = self._resolved_gather(cfg, shards, phys)
        cfg = dataclasses.replace(cfg, **cfg_updates) if cfg_updates else cfg
        check_config(cfg)
        self._device = resolve_device(device)
        self._cfg = cfg
        # Per-device budget model (DESIGN.md §12): the scene parameters at
        # 1/phys plus the per-camera projected features at the padded count
        # over the feature divisor.
        self._scene_mb_per_device = pytree_bytes(scene) / phys / 2**20
        fdiv = self._feature_div(cfg, shards, phys)
        self._feature_mb_per_device = self._feature_mb(scene, shards) / fdiv
        need = self._scene_mb_per_device + self._feature_mb_per_device
        if device_budget_mb is not None and need > device_budget_mb:
            raise ValueError(
                f"scene needs {need:.2f} MB on its one device "
                f"({self._scene_mb_per_device:.2f} MB parameters + "
                f"{self._feature_mb_per_device:.2f} MB per-camera projected "
                f"features at N/{fdiv}), over the {device_budget_mb} MB budget — "
                f"logical shards on one device divide neither; sharding over "
                f"several devices is not ported yet (ROADMAP queue 1, item "
                f"{_ITEM_SHARDING})"
            )
        # What the commit runs ('flat' for a replicated frontend, even
        # though cfg.feature_gather may still read 'auto').
        self._feature_gather = self._resolved_gather(cfg, shards, phys)
        self._phys_shards = phys
        # Commit: a plain scene sharded D > 1 ways is staged on the host
        # through the refcounted layout cache (the layout survives until the
        # last handle over it closes), then moved to the device once.
        staged = scene
        self._layout_ref = None
        if shards > 1 and isinstance(scene, GaussianScene):
            staged = acquire_scene_layout(scene, shards)
            self._layout_ref = (scene, shards)
        self._scene: Optional[SceneLike] = staged.to(self._device)

        # Per-handle renderer cache, visible through the engine-wide
        # registry through a weakref, so the registry never pins the handle;
        # the finalizer removes the entry close() would have removed.
        self._fns: Dict[tuple, Any] = {}
        self._fn_stats = {"hits": 0, "misses": 0}
        self._fn_lock = threading.Lock()
        self.cache_name = f"engine{next(_HANDLE_SEQ)}"
        self_ref = weakref.ref(self)

        def _info(ref=self_ref):
            h = ref()
            return h.cache_info() if h is not None else {
                "hits": 0, "misses": 0, "currsize": 0, "maxsize": _FN_CACHE_MAX,
            }

        def _clear(ref=self_ref):
            h = ref()
            if h is not None:
                h._cache_clear()

        register_render_cache(self.cache_name, info=_info, clear=_clear)
        weakref.finalize(self, unregister_render_cache, self.cache_name)

        # Futures front-end (worker started lazily on first submit()).
        self._clock = clock
        self._max_batch = max_batch
        self._queue = RequestQueue(queue_depth, clock=clock)
        self._scheduler = BucketingScheduler(max_batch, max_wait, clock=clock)
        self._worker_lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._flush_event = threading.Event()
        self._outstanding: List[Future] = []
        self._counters = {
            "submitted": 0, "completed": 0, "batches": 0, "padded_lanes": 0,
        }
        self._closed = False

    # -- committed-state introspection --------------------------------------

    @property
    def cfg(self) -> RenderConfig:
        return self._cfg

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def scene_shards(self) -> int:
        """The committed number of gaussian-axis shards D."""
        return self._cfg.scene_shards

    @property
    def tile_params(self) -> tuple:
        """The committed (tile, group, tile_capacity)."""
        return (self._cfg.tile, self._cfg.group, self._cfg.tile_capacity)

    def stats(self) -> dict:
        """Committed layout + per-handle cache and futures counters. Also
        publishes them as per-handle gauges in the metrics registry
        (dropped again by close())."""
        registry = get_registry()
        prefix = f"engine.{self.cache_name}."
        registry.gauge(prefix + "scene_mb_per_device").set(self._scene_mb_per_device)
        registry.gauge(prefix + "feature_mb_per_device").set(self._feature_mb_per_device)
        registry.gauge(prefix + "physical_shards").set(self._phys_shards)
        with self._worker_lock:
            counters = dict(self._counters)
        for k, v in counters.items():
            registry.gauge(prefix + k).set(v)
        return {
            "config": self._cfg,
            "tile_params": self.tile_params,
            "device": str(self._device),
            "scene_shards": self._cfg.scene_shards,
            "physical_shards": self._phys_shards,
            "scene_mb_per_device": self._scene_mb_per_device,
            "feature_mb_per_device": self._feature_mb_per_device,
            "feature_gather": self._feature_gather,
            "cache": self.cache_info(),
            **counters,
        }

    def cache_info(self) -> dict:
        with self._fn_lock:
            return {
                "hits": self._fn_stats["hits"],
                "misses": self._fn_stats["misses"],
                "currsize": len(self._fns),
                "maxsize": _FN_CACHE_MAX,
            }

    def _cache_clear(self) -> None:
        with self._fn_lock:
            self._fns.clear()
            self._fn_stats["hits"] = 0
            self._fn_stats["misses"] = 0

    # -- budget model (DESIGN.md §12) ----------------------------------------

    @staticmethod
    def _feature_mb(scene, shards: int) -> float:
        """Per-camera projected-feature MB at the padded gaussian count
        (padding rows project too; they are culled, not skipped)."""
        if isinstance(scene, ShardedScene):
            n_pad = scene.padded_size
        else:
            d = max(shards, 1)
            n_pad = -(-scene.num_gaussians // d) * d
        return n_pad * projected_bytes_per_gaussian() / 2**20

    @staticmethod
    def _resolved_gather(cfg: RenderConfig, shards: int, phys: int) -> str:
        """The gather strategy this commit runs."""
        if shards <= 1:
            return "flat"       # replicated frontend: features are flat-N
        if cfg.feature_gather == "auto":
            return "psum" if phys > 1 else "index"
        return resolve_feature_gather(cfg)

    @classmethod
    def _feature_div(cls, cfg: RenderConfig, shards: int, phys: int) -> int:
        """What divides the per-camera feature bytes per device: ``phys``
        only when the psum gather keeps them sharded over physical shards;
        1 for a replicated scene, a logical shard axis, the plain indexed
        gather and the flat concat."""
        if phys > 1 and cls._resolved_gather(cfg, shards, phys) == "psum":
            return phys
        return 1

    @staticmethod
    def _resolve_shards(scene, cfg: RenderConfig, scene_shards) -> int:
        requested = cfg.scene_shards if scene_shards == "auto" else int(scene_shards)
        if requested < 1:
            raise ValueError(f"scene_shards must be >= 1, got {requested}")
        if isinstance(scene, ShardedScene):
            if scene_shards != "auto" and requested != scene.num_shards:
                raise ValueError(
                    f"scene is pre-sharded {scene.num_shards} ways but "
                    f"scene_shards={requested} was requested"
                )
            return scene.num_shards
        return requested

    # -- per-handle renderer cache -------------------------------------------

    def _fn(self, kind: str, cam):
        """The renderer for ``kind`` x this camera's geometry. The config is
        committed, so the key is the geometry alone. Each callable runs the
        same ``core.pipeline`` functions as a free call, so its outputs equal
        them bit for bit."""
        key = (kind, cam.width, cam.height, cam.znear, cam.zfar)
        with self._fn_lock:
            fn = self._fns.get(key)
            if fn is not None:
                self._fn_stats["hits"] += 1
                return fn
            self._fn_stats["misses"] += 1
            cfg, geom = self._cfg, key[1:]
            if kind == "single":
                fn = lambda scene, cam, bg: render(scene, cam, cfg, bg)
            elif kind == "batch":
                fn = batch_renderer(cfg, *geom)
            elif kind == "frontend":
                fn = lambda scene, cam: render_frontend(scene, cam, cfg)
            else:
                # The backend reads only the static geometry (grid + crop).
                geom_cam = Camera(
                    R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
                    fx=1.0, fy=1.0, cx=0.0, cy=0.0,
                    width=geom[0], height=geom[1], znear=geom[2], zfar=geom[3],
                )
                fn = lambda front, bg: render_backend(front, geom_cam, cfg, bg)
            while len(self._fns) >= _FN_CACHE_MAX:
                self._fns.pop(next(iter(self._fns)))
            self._fns[key] = fn
            return fn

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("Renderer is closed")

    def _background(self, background) -> Optional[torch.Tensor]:
        if background is None:
            return None
        return torch.as_tensor(background, dtype=torch.float32, device=self._device)

    # -- synchronous entry points -------------------------------------------

    def render(self, cam: Camera, background=None) -> RenderResult:
        """Render one camera against the committed scene."""
        self._check_open()
        fn = self._fn("single", cam)
        with torch.inference_mode():
            return fn(self._scene, cam, self._background(background))

    def render_frontend(self, cam: Camera) -> FrontendResult:
        """Only the frontend half (project -> identify -> bin) for one
        camera; feed the result to :meth:`render_backend` for pixels."""
        self._check_open()
        fn = self._fn("frontend", cam)
        with torch.inference_mode():
            return fn(self._scene, cam)

    def render_backend(
        self, front: FrontendResult, cam: Camera, background=None
    ) -> RenderResult:
        """Only the backend half (bitmask -> compact -> rasterize) on a
        :class:`FrontendResult`. ``render_backend(render_frontend(cam), cam)``
        equals ``render(cam)``; only the static geometry of ``cam`` is read."""
        self._check_open()
        fn = self._fn("backend", cam)
        with torch.inference_mode():
            return fn(front, self._background(background))

    def render_batch(
        self,
        cams: Union[CameraBatch, Sequence[Camera]],
        pad_to: Optional[int] = None,
        background=None,
    ) -> RenderResult:
        """Render B cameras of one geometry: image (B, H, W, 3), each stats
        field (B,). The batch is padded to ``max(B, pad_to)`` by replicating
        the last camera, as the JAX package pads its dispatch shape; the
        padded lanes are rendered and dropped, and exactly B come back."""
        self._check_open()
        batch = cams if isinstance(cams, CameraBatch) else CameraBatch.from_cameras(cams)
        orig = len(batch)
        padded = pad_camera_batch(batch, padded_size(max(orig, pad_to or 0), 1))
        fn = self._fn("batch", padded)
        with torch.inference_mode():
            out = fn(self._scene, padded, self._background(background))
        if len(padded) != orig:
            out = out.map(lambda x: x[:orig])
        return out

    def open_stream(self, *args, **kwargs):
        raise NotImplementedError(
            f"Renderer.open_stream is not ported yet (ROADMAP queue 1, item {_ITEM_STREAMS})"
        )

    # -- futures front-end ---------------------------------------------------

    def submit(self, cam: Camera) -> Future:
        """Enqueue one camera; returns a Future of its ``RenderResult`` with
        every tensor on the CPU (the worker copies them to the host before it
        resolves). Requests batch with other submits of the same geometry up
        to the handle's ``max_batch``/``max_wait``; a full queue blocks the
        producer. Thread-safe."""
        self._check_open()
        fut: Future = Future()
        self._ensure_worker()
        # Track before enqueueing: the worker may dispatch (and untrack) the
        # request the instant it lands in the queue.
        with self._worker_lock:
            self._counters["submitted"] += 1
            seq = self._counters["submitted"]
            self._outstanding.append(fut)
        get_registry().counter("engine.submitted_total").inc()
        try:
            self._queue.put(_Submitted(
                camera=cam, future=fut, request_id=f"{self.cache_name}#{seq}",
            ))
        except QueueClosed:
            with self._worker_lock:
                self._counters["submitted"] -= 1
                self._outstanding.remove(fut)
            raise RuntimeError("Renderer is closed") from None
        return fut

    def flush(self, timeout: Optional[float] = None) -> None:
        """Force-dispatch pending buckets and wait for outstanding futures."""
        self._flush_event.set()
        with self._worker_lock:
            futs = list(self._outstanding)
        _, not_done = _futures_wait(futs, timeout=timeout)
        if not_done:
            raise TimeoutError(f"flush timed out with {len(not_done)} pending")

    def _ensure_worker(self) -> None:
        with self._worker_lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop, name=f"{self.cache_name}-worker", daemon=True,
                )
                self._worker.start()

    def _worker_loop(self) -> None:
        q, sched = self._queue, self._scheduler
        poll_s = max(min(sched.max_wait, 0.01), 0.001)
        try:
            # inference_mode is thread-local: the worker enters its own.
            with torch.inference_mode():
                while True:
                    for req in q.get_batch(timeout=poll_s):
                        for bucket in sched.add(req):
                            self._dispatch_bucket(bucket)
                    if self._flush_event.is_set():
                        self._flush_event.clear()
                        for req in q.drain():
                            for bucket in sched.add(req):
                                self._dispatch_bucket(bucket)
                        for bucket in sched.flush_all():
                            self._dispatch_bucket(bucket)
                    for bucket in sched.poll():
                        self._dispatch_bucket(bucket)
                    if q.closed and len(q) == 0:
                        for bucket in sched.flush_all():
                            self._dispatch_bucket(bucket)
                        return
        except BaseException as exc:      # noqa: BLE001 — futures must terminate
            # A crash outside _dispatch_bucket's own handler would otherwise
            # strand every outstanding future unresolved forever.
            self._fail_outstanding(exc)
            raise

    def _fail_outstanding(self, exc: BaseException) -> None:
        """Terminate every tracked future with ``exc`` (queued and scheduled
        requests are all in ``_outstanding``: submit tracks before enqueue)."""
        with self._worker_lock:
            futs, self._outstanding[:] = list(self._outstanding), []
        self._queue.drain()
        self._scheduler.flush_all()
        for fut in futs:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)

    def _dispatch_bucket(self, bucket) -> None:
        reqs = bucket.requests
        tracer = get_tracer()
        t0 = self._clock()
        try:
            out = self.render_batch([r.camera for r in reqs], pad_to=self._max_batch)
            host = out.map(torch.Tensor.cpu)     # blocks on the device work
            results = [host.map(lambda x, i=i: x[i]) for i in range(len(reqs))]
        except Exception as exc:                   # noqa: BLE001 — futures own it
            with self._worker_lock:
                for r in reqs:
                    self._outstanding.remove(r.future)
            for r in reqs:
                # A future cancelled between submit and dispatch must not
                # kill the worker (set_* on a cancelled Future raises).
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(exc)
            return
        t1 = self._clock()
        padded = padded_size(max(len(reqs), self._max_batch), 1)
        with self._worker_lock:
            self._counters["batches"] += 1
            self._counters["completed"] += len(reqs)
            self._counters["padded_lanes"] += padded - len(reqs)
            for r in reqs:
                self._outstanding.remove(r.future)
        registry = get_registry()
        registry.counter("engine.batches_total").inc()
        registry.counter("engine.completed_total").inc(len(reqs))
        registry.counter("engine.padded_lanes_total").inc(padded - len(reqs))
        registry.histogram("engine.dispatch_s").observe(t1 - t0)
        if tracer.enabled:
            tracer.complete(
                "engine/dispatch", t0, t1, category="engine",
                args={"handle": self.cache_name, "batch_size": len(reqs), "padded": padded},
            )
        for r, res in zip(reqs, results):
            r.stamps["dispatch"] = t0
            r.stamps["device_done"] = t1
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(res)
            r.stamps["resolve"] = self._clock()
            emit_request_spans(tracer, r.request_id, r.stamps,
                               args={"handle": self.cache_name})

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Drain the worker, fail the futures it never resolved, drop and
        unregister the renderer cache, and release the committed scene.
        Idempotent; the handle is unusable afterwards."""
        if self._closed:
            return
        self._queue.close()                 # wakes the worker; drains pending
        worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join()
        # A healthy worker resolved everything on the way out; if it died
        # earlier the remaining futures must still terminate.
        self._fail_outstanding(RuntimeError(
            f"Renderer {self.cache_name} closed before the request resolved"
        ))
        self._closed = True
        self._worker = None
        unregister_render_cache(self.cache_name)
        get_registry().drop(f"engine.{self.cache_name}.")
        self._cache_clear()
        self._scene = None
        if self._layout_ref is not None:
            # Only this handle's own (scene, D) reference: the cached host
            # layout drops when the last reference goes.
            release_scene_layout(*self._layout_ref)
            self._layout_ref = None

    def __enter__(self) -> "Renderer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if self._closed else "open"
        return (
            f"<Renderer {self.cache_name} {state} mode={self._cfg.mode!r} "
            f"backend={self._cfg.backend!r} scene_shards={self._cfg.scene_shards} "
            f"device={self._device}>"
        )


def open(  # noqa: A001 — the module-level session verb is the API
    scene: SceneLike,
    cfg: RenderConfig,
    *,
    device=None,
    scene_shards: Union[str, int] = "auto",
    device_budget_mb: Optional[float] = None,
    max_batch: int = 8,
    max_wait: float = 0.05,
    queue_depth: int = 64,
    clock=time.monotonic,
    **unported,
) -> Renderer:
    """Commit ``(scene, cfg)`` to ``device`` (CUDA unless the caller names
    another; raises when CUDA is missing) and return the :class:`Renderer`.

    * ``device_budget_mb`` — per-device memory cap counting the scene
      parameters plus the per-camera projected features; an over-budget
      commit raises.
    * ``max_batch``/``max_wait``/``queue_depth`` — the ``submit()`` futures
      front-end's batching knobs; ``clock`` is the scheduler's clock.
    * ``scene_shards`` — ``'auto'`` takes D from ``cfg.scene_shards``, or
      from a pre-sharded ``ShardedScene``; an int D commits D logical shards
      on the one device (``feature_gather='auto'`` runs ``'index'``).
    * ``devices``, ``mesh``, ``tile_params``, ``autotune_opts`` and
      ``residency`` raise ``NotImplementedError`` naming their ROADMAP item.
    """
    for name in unported:
        if name not in _UNPORTED_OPTIONS:
            raise TypeError(f"open() got an unexpected keyword argument {name!r}")
        raise NotImplementedError(
            f"open({name}=...) is not ported yet (ROADMAP queue 1, item "
            f"{_UNPORTED_OPTIONS[name]})"
        )
    return Renderer(
        scene, cfg, device=device, scene_shards=scene_shards,
        device_budget_mb=device_budget_mb,
        max_batch=max_batch, max_wait=max_wait, queue_depth=queue_depth, clock=clock,
    )


default_renderer = not_ported("default_renderer", _ITEM_DEFAULTS)
close_default_renderers = not_ported("close_default_renderers", _ITEM_DEFAULTS)
