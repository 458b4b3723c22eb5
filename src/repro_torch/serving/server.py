"""The render server: a thin dispatch loop over shared engine handles (mirror
of ``repro.serving.server`` on one device, DESIGN.md §9/§11).

  submit() --> RequestQueue --> BucketingScheduler --> Renderer.render_batch
   (bounded, backpressure)      (one bucket per render    (ONE committed handle
                                 signature; max-batch /    per (scene, config);
                                 max-wait flush)           fixed dispatch shape)

Scene placement and the renderer caches live in the
``repro_torch.engine.Renderer`` handles the server opens lazily per (scene
id, config); the server drains the queue into signature buckets and hands
each bucket to the right handle. Every handle commits through the server's
one :class:`~repro_torch.residency.ResidencyManager`, so scenes that fit
the device budget one at a time but not together page in and out, and two
configs over one scene share one device copy. A stream request (its
``stream_id`` set) goes through that stream's session
(``engine/stream.py``) one frame at a time.

The dispatch loop is synchronous and single-threaded, so the latency
accounting is exact; producers may submit from other threads (the queue is
the thread-safe boundary) or replay a timed load with ``run(load)``. Every
completed request yields a ``RequestResult`` with its image as a CPU
tensor, its end-to-end latency and its bucket; ``RenderServer.stats``
aggregates per-bucket latency, throughput and cache hits
(``serving/stats.py``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pipeline import CameraBatch, render_cache_info
from repro_torch.obs import emit_request_spans, get_tracer
from repro_torch.residency import ResidencyManager
from repro_torch.serving.bucketing import Bucket, BucketingScheduler, padded_size
from repro_torch.serving.queue import RenderRequest, RequestQueue
from repro_torch.serving.stats import ServingStats
from repro_torch.sharding.scene import SceneLike
from repro_torch.utils import resolve_device
from repro_torch.utils.misc import ITEM_SHARDING


@dataclasses.dataclass
class RequestResult:
    request_id: int
    image: torch.Tensor          # (H, W, 3) host copy (a CPU tensor)
    latency_s: float             # completion - enqueue (queue + batch + render)
    batch_size: int              # how many requests shared the dispatch
    signature: tuple
    deadline_missed: bool = False


class RenderServer:
    """Serves render requests against a registry of scenes on one device.

    ``device`` (CUDA unless the caller names another; no quiet fallback to
    the CPU) is where every handle commits. ``scene_shards = D > 1`` lets
    requests whose ``cfg.scene_shards`` is D commit D logical shards of the
    gaussian axis on that device (DESIGN.md §10); a request's shard count
    must be 1 or D, and it is part of the bucket signature, so the two
    layouts never mix in a batch. ``device_budget_mb`` seeds the server's
    residency manager: scenes that fit individually but not together page
    in and out LRU against the budget, bitwise invisibly, and only a scene
    too big to fit alone fails at commit; ``prefetch=False`` turns off the
    admission-time page-in. ``autotune=True`` opens every handle with
    ``tile_params='auto'``: the first dispatch of each (scene, config) tunes
    on the server's device, or hits the autotune cache, and the handle
    serves the tuned triple from then on (``autotune_opts`` goes to
    ``repro_torch.autotune.autotune``). ``mesh=`` (several devices, ROADMAP
    item 8) raises ``NotImplementedError``. Close the server (or use it as a
    context manager) to close its handles.
    """

    def __init__(
        self,
        scenes: Mapping[str, SceneLike],
        *,
        device=None,
        mesh=None,
        max_batch: int = 8,
        max_wait: float = 0.05,
        queue_depth: int = 64,
        scene_shards: int = 1,
        device_budget_mb: Optional[float] = None,
        autotune: bool = False,
        autotune_opts: Optional[dict] = None,
        stream_cache_frames: int = 32,
        spec_depth: int = 2,
        speculate: bool = True,
        prefetch: bool = True,
        clock=time.monotonic,
    ):
        if mesh is not None:
            raise NotImplementedError(
                f"RenderServer(mesh=...) is not ported yet (ROADMAP queue 1, item "
                f"{ITEM_SHARDING}); the port serves from one device (device=...)"
            )
        self.scenes = dict(scenes)
        self.device = resolve_device(device)
        self.scene_shards = scene_shards
        self.device_budget_mb = device_budget_mb
        self.autotune = autotune
        self.autotune_opts = autotune_opts
        self.stream_cache_frames = stream_cache_frames
        self.spec_depth = spec_depth
        self.speculate = speculate
        self.prefetch = prefetch
        self._clock = clock
        self.queue = RequestQueue(queue_depth, clock=clock)
        self.scheduler = BucketingScheduler(max_batch, max_wait, clock=clock)
        self.stats = ServingStats()
        self.results: Dict[int, RequestResult] = {}
        # ONE residency manager for every handle this server opens: device
        # copies dedupe per (scene, layout, device) and, under a budget, an
        # over-budget commit evicts cold scenes instead of failing.
        self.residency = ResidencyManager(budget_mb=device_budget_mb, name="server")
        # The server lock: commit()/stream_for()/close() all mutate the
        # handle registry; without it commit() could hand out a handle while
        # close() tears the map down. Reentrant: stream_for -> commit nests.
        self._lock = threading.RLock()
        self._server_closed = False
        self._renderers: Dict[Tuple[str, object], object] = {}
        # One StreamRenderer per (scene, cfg, stream_id), opened on the
        # stream's first frame over the shared handle; the handle's close()
        # closes its streams.
        self._streams: Dict[Tuple[str, object, str], object] = {}

    # -- admission ----------------------------------------------------------

    def _layout_ok(self, req: RenderRequest) -> bool:
        """A request's gaussian layout must be replicated (1) or the
        server's shard count: a mismatch would raise inside the dispatch
        and stop the loop for everyone behind it, so it is screened at
        admission (pure Python, no device touch)."""
        return getattr(req.cfg, "scene_shards", 1) in (1, self.scene_shards)

    def submit(self, req: RenderRequest) -> bool:
        """Non-blocking admission; False = backpressure (queue at depth).
        Raises KeyError for an unknown scene and ValueError for a shard
        layout the server does not serve (caller bugs, not load)."""
        if req.scene_id not in self.scenes:
            raise KeyError(f"unknown scene {req.scene_id!r}")
        if not self._layout_ok(req):
            raise ValueError(
                f"request {req.request_id} wants scene_shards="
                f"{getattr(req.cfg, 'scene_shards', 1)} but this server "
                f"serves 1 or {self.scene_shards}"
            )
        ok = self.queue.try_put(req)
        if not ok:
            self.stats.count_rejected()
        elif self.prefetch:
            self._prefetch(req)
        return ok

    def _prefetch(self, req: RenderRequest) -> None:
        """Admission-time prefetch: if the request's scene is committed but
        paged out, page it in now so its dispatch finds it resident. Only
        committed handles are touched: admission stays cheap and raises
        nothing (a first-time scene pays its commit at dispatch)."""
        with self._lock:
            handle = self._renderers.get((req.scene_id, req.cfg))
            if handle is None or handle.closed or handle.resident:
                return
            try:
                handle.prefetch()
            except Exception:       # noqa: BLE001 — prefetch is advisory;
                pass                # the dispatch path surfaces real errors

    # -- committed handles --------------------------------------------------

    @property
    def committed_scene_ids(self) -> frozenset:
        """Scenes with at least one committed handle."""
        with self._lock:
            return frozenset(sid for sid, _cfg in self._renderers)

    @property
    def resident_scene_ids(self) -> frozenset:
        """Committed scenes whose device copy is resident right now."""
        with self._lock:
            return frozenset(
                sid for (sid, _cfg), h in self._renderers.items()
                if not h.closed and h.resident
            )

    def commit(self, scene_id: str, cfg):
        """The shared engine handle for ``(scene_id, cfg)``, opened on first
        use. Public so callers can pre-commit scenes before taking load: a
        scene too big for the budget even alone fails here (``engine.open``
        raises); scenes that fit one at a time page through the residency
        manager. Handles are per (scene, config), but two configs over one
        scene share one device copy. Raises RuntimeError after close()."""
        with self._lock:
            if self._server_closed:
                raise RuntimeError("RenderServer is closed")
            key = (scene_id, cfg)
            handle = self._renderers.get(key)
            if handle is None:
                from repro_torch import engine

                handle = engine.open(
                    self.scenes[scene_id], cfg, device=self.device, residency=self.residency,
                    tile_params="auto" if self.autotune else None,
                    autotune_opts=self.autotune_opts,
                )
                self._renderers[key] = handle
            return handle

    def stream_for(self, req: RenderRequest):
        """The stream session serving ``req``'s (scene, cfg, stream_id),
        opened on first use over the shared committed handle."""
        with self._lock:
            key = (req.scene_id, req.cfg, req.stream_id)
            stream = self._streams.get(key)
            if stream is None or stream.closed:
                handle = self.commit(req.scene_id, req.cfg)
                stream = handle.open_stream(
                    cache_frames=self.stream_cache_frames,
                    spec_depth=self.spec_depth,
                    speculate=self.speculate,
                )
                self._streams[key] = stream
            return stream

    def stream_stats(self) -> Dict[str, dict]:
        """Per-stream session counters keyed by registry cache name."""
        return {s.name: s.stats() for s in self._streams.values() if not s.closed}

    # -- scheduling / dispatch ----------------------------------------------

    def _pump_queue(self, now: Optional[float] = None) -> int:
        """Drain the queue into buckets, dispatching any bucket that fills
        to max_batch (partial buckets keep waiting)."""
        n = 0
        for req in self.queue.drain():
            for bucket in self.scheduler.add(req, now):
                self._dispatch(bucket)
                n += 1
        return n

    def step(self, now: Optional[float] = None) -> int:
        """One scheduler turn: pump the queue, then dispatch buckets past
        max_wait. Returns the number of dispatches."""
        n = self._pump_queue(now)
        for bucket in self.scheduler.poll(now):
            self._dispatch(bucket)
            n += 1
        return n

    def drain(self) -> None:
        """Flush everything pending (shutdown path): remaining queue items
        are bucketed and every bucket dispatches regardless of age."""
        while len(self.queue) or self.scheduler.pending:
            self._pump_queue()
            for bucket in self.scheduler.flush_all():
                self._dispatch(bucket)

    def _dispatch(self, bucket: Bucket) -> None:
        reqs = bucket.requests
        if getattr(reqs[0], "stream_id", None) is not None:
            self._dispatch_stream(bucket)
            return
        handle = self.commit(reqs[0].scene_id, reqs[0].cfg)
        batch = CameraBatch.from_cameras([r.camera for r in reqs])
        # Fixed dispatch shape: every bucket of a signature pads to
        # max_batch, so a ragged max_wait flush runs the same shape as a
        # full one (one device, so one camera lane per device).
        shape = padded_size(self.scheduler.max_batch, 1)

        before = render_cache_info()
        t0 = self._clock()
        out = handle.render_batch(batch, pad_to=shape)
        images = out.image.cpu()         # blocks until the device work completes
        t1 = self._clock()
        after = render_cache_info()

        tracer = get_tracer()
        if tracer.enabled:
            tracer.complete(
                "serve/dispatch", t0, t1, category="serving",
                args={"batch_size": len(reqs), "padded": shape,
                      "signature": repr(bucket.signature)},
            )
        self._record(bucket, list(images), t0, t1, shape, before, after,
                     args={})

    def _dispatch_stream(self, bucket: Bucket) -> None:
        """Dispatch a stream bucket: frames run IN ORDER through the
        stream's session, one frame per device dispatch (the signature puts
        one stream in a bucket, and queue FIFO kept the frame order).
        Output is bitwise the stateless path's: the session reuses a
        frontend only on an exact pose-key hit."""
        reqs = bucket.requests
        stream = self.stream_for(reqs[0])

        before = render_cache_info()
        t0 = self._clock()
        images = [stream.render(r.camera).image.cpu() for r in reqs]
        t1 = self._clock()
        after = render_cache_info()

        tracer = get_tracer()
        if tracer.enabled:
            tracer.complete(
                "serve/dispatch", t0, t1, category="serving",
                args={"batch_size": len(reqs), "padded": len(reqs),
                      "stream": stream.name, "signature": repr(bucket.signature)},
            )
        # Per-frame dispatch: no padded lanes.
        self._record(bucket, images, t0, t1, len(reqs), before, after,
                     args={"stream": stream.name})

    def _record(self, bucket: Bucket, images: List[torch.Tensor], t0: float, t1: float,
                shape: int, before: dict, after: dict, args: dict) -> None:
        """Fold one dispatch into the stats and the results map, and emit
        each request's lifecycle spans."""
        reqs = bucket.requests
        latencies = [t1 - r.enqueue_time for r in reqs]
        self.stats.record_dispatch(
            bucket.signature,
            batch_size=len(reqs),
            padded_size=shape,
            render_s=t1 - t0,
            latencies_s=latencies,
            cache_before=before,
            cache_after=after,
        )
        tracer = get_tracer()
        for req, img, lat in zip(reqs, images, latencies):
            missed = req.deadline is not None and t1 > req.deadline
            if missed:
                self.stats.count_deadline_miss()
            self.results[req.request_id] = RequestResult(
                request_id=req.request_id,
                image=img,
                latency_s=lat,
                batch_size=len(reqs),
                signature=bucket.signature,
                deadline_missed=missed,
            )
            stamps = req.stamps
            if stamps is None:   # the gateway owns this request's spans
                continue
            stamps["dispatch"] = t0
            stamps["device_done"] = t1
            stamps["resolve"] = self._clock()
            emit_request_spans(tracer, req.request_id, stamps,
                               args={"scene_id": req.scene_id, **args})

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Close every committed handle (releasing their renderer caches,
        scene layouts and residency entries; each handle also closes its
        streams). Terminal: a later ``commit()`` raises RuntimeError; the
        server lock orders close against commit. Idempotent."""
        with self._lock:
            self._server_closed = True
            while self._renderers:
                self._renderers.pop(next(iter(self._renderers))).close()
            self._streams.clear()

    def __enter__(self) -> "RenderServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- timed replay --------------------------------------------------------

    def run(
        self,
        load: Iterable[Tuple[float, RenderRequest]],
        realtime: bool = True,
    ) -> Dict[int, RequestResult]:
        """Serve a timed load of ``(arrival_offset_s, request)`` pairs.

        ``realtime=True`` sleeps the inter-arrival gaps (servicing due
        buckets while waiting) so max-wait flushes behave as in production;
        it needs the default wall clock (an injected fake clock never
        advances through ``time.sleep``). ``realtime=False`` enqueues the
        whole backlog and drains it (closed-loop throughput: buckets fill to
        max_batch regardless of max_wait). Unknown-scene and unservable-
        layout requests are counted as rejections and skipped. Returns the
        results map; ``stats.wall_s`` is stamped on exit.
        """
        t_start = self._clock()
        for offset, req in load:
            if req.scene_id not in self.scenes or not self._layout_ok(req):
                self.stats.count_rejected()
                continue
            if realtime:
                while self._clock() - t_start < offset:
                    self.step()
                    gap = offset - (self._clock() - t_start)
                    if gap > 0:
                        time.sleep(min(gap, max(self.scheduler.max_wait, 1e-3) / 4))
            if not self.queue.try_put(req):
                # Backpressure inline: service the backlog, then retry once;
                # a second failure is a real rejection.
                self._pump_queue()
                if not self.queue.try_put(req):
                    self.stats.count_rejected()
                elif self.prefetch:
                    self._prefetch(req)
            elif self.prefetch:
                self._prefetch(req)
            if realtime:
                self.step()
        self.drain()
        self.stats.wall_s = self._clock() - t_start
        return self.results


def poisson_arrivals(n: int, rate_hz: float, seed: int = 0) -> List[float]:
    """n arrival offsets with exponential inter-arrival gaps (a Poisson
    process at ``rate_hz``): the synthetic open-loop load of the CLI."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=n)
    return np.cumsum(gaps).tolist()
