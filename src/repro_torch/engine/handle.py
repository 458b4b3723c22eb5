"""The session-style rendering handle (mirror of ``repro.engine.handle``,
DESIGN.md §11).

``engine.open(scene, cfg)`` commits the scene to a render mesh once and
returns a :class:`Renderer`:

  * ``device=`` commits on one device; ``devices=``/``mesh=`` on a
    ``(data, model)`` :class:`~repro_torch.launch.mesh.RenderMesh` driven
    by this one process. Camera lanes go to the data rows; with
    ``scene_shards=D`` equal to the mesh's model extent the scene's shards
    are physical, shard ``d`` on model column ``d``, each shard's frontend
    runs on its device and the owner-masked psum gather reduces the
    features to the row's lead device, where the merge and the backend run
    once a lane. Renders are bitwise those of one device at D = 1;
  * ``scene_shards=D`` (or a pre-sharded ``ShardedScene``) on a mesh that
    cannot realize D commits D logical shards: the layout is staged on the
    host through the refcounted scene-layout cache (``serving/sharded.py``)
    and stays one tensor a row (DESIGN.md §10);
  * ``.render(cam)`` / ``.render_batch(cams, pad_to=...)`` are the
    synchronous entry points; a batch renders lane by lane through the same
    ``render``, so every lane is bitwise equal to a single render;
  * ``.render_frontend(cam)`` / ``.render_backend(front, cam)`` are the two
    halves of ``render``;
  * ``.submit(cam)`` returns a ``concurrent.futures.Future`` served by an
    internal queue -> bucketing-scheduler worker thread; a request that
    fails resolves its own future with the exception and the worker lives
    on;
  * the committed scene lives in a refcounted residency entry
    (``residency/manager.py``): every render path acquires it there, so a
    budgeted manager shared by several handles (``residency=``) can page it
    out and back in, bitwise invisibly, from a host copy of the layout;
  * ``.open_stream()`` opens a :class:`~repro_torch.engine.stream.StreamRenderer`
    over the handle: a frontend cache keyed by exact pose plus speculation;
  * ``tile_params=(tile, group, tile_capacity)`` commits that triple;
    ``tile_params='auto'`` defers it to the first render, which looks the
    scene's signature up in the autotune cache or runs the two-phase search
    (``repro_torch.autotune``) over the handle's mesh, then commits the
    winner before any renderer exists: every render path (``render``, the
    halves, ``render_batch``, ``submit``, streams) reaches that resolution
    first, and renders bitwise like an open with the winner fixed;
  * the handle owns a per-geometry cache of its render callables,
    registered with ``core.pipeline.register_render_cache`` so
    ``render_cache_info()`` covers it;
  * ``.close()`` (or the context manager) closes the handle's streams,
    drains the worker, fails what it never resolved, unregisters the cache
    and releases its residency entry and its own scene-layout reference.

``default_renderer(scene, cfg, mesh=None)`` is the module-default handle
behind the deprecated free functions (``render_jit``, ``render_image``,
``render_batch_sharded``), committed on the scene's own device unless a
mesh is named.
"""
from __future__ import annotations

import dataclasses
import functools
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
    RenderStats,
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
from repro_torch.launch.mesh import (
    DevicesArg,
    RenderMesh,
    make_render_mesh,
    mesh_devices,
    one_device_mesh,
    render_mesh_shards,
)
from repro_torch.obs import emit_request_spans, get_registry, get_tracer
from repro_torch.residency import ResidencyManager
from repro_torch.serving.bucketing import BucketingScheduler, padded_size
from repro_torch.serving.queue import QueueClosed, RequestQueue
from repro_torch.serving.sharded import (
    acquire_scene_layout,
    pad_camera_batch,
    release_scene_layout,
)
from repro_torch.sharding.policies import (
    Placement,
    data_extent,
    render_replicated_pspec,
    scene_shard_pspec,
)
from repro_torch.sharding.scene import SceneLike, ShardedScene
from repro_torch.utils import pytree_bytes, resolve_device

_HANDLE_SEQ = itertools.count()
_FN_CACHE_MAX = 64          # per-handle cached-renderer bound


def _mesh_batch(one, rows, batch: CameraBatch, backgrounds) -> RenderResult:
    """Render a batch padded to a multiple of the data extent: lanes go to
    the data rows contiguously, row ``r``'s through ``one`` (the batch
    renderer of the signature) against ``rows[r]`` on its lead device; the
    rows' results are copied to row 0's lead device and concatenated. Rows
    on distinct cards overlap: nothing here waits on the host."""
    if len(rows) == 1:
        return one(rows[0], batch, backgrounds[0])
    per = len(batch) // len(rows)
    outs = []
    for r, scene in enumerate(rows):
        lanes = slice(r * per, (r + 1) * per)
        sub = dataclasses.replace(
            batch, R=batch.R[lanes], t=batch.t[lanes], fx=batch.fx[lanes],
            fy=batch.fy[lanes], cx=batch.cx[lanes], cy=batch.cy[lanes],
        )
        outs.append(one(scene, sub, backgrounds[r]))
    lead = outs[0].image.device
    moved = [o.map(lambda x: x.to(lead)) for o in outs]
    return RenderResult(
        image=torch.cat([o.image for o in moved]),
        stats=RenderStats(**{
            f.name: torch.cat([getattr(o.stats, f.name) for o in moved])
            for f in dataclasses.fields(RenderStats)
        }),
    )


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
    """A committed (scene, config) pair on a render mesh (one device or
    several) with render/serve entry points. Construct through :func:`open`. ``submit`` is the
    thread-safe entry; the internal worker owns all device work for the
    futures path."""

    def __init__(
        self,
        scene: SceneLike,
        cfg: RenderConfig,
        *,
        device=None,
        devices: DevicesArg = None,
        mesh: Optional[RenderMesh] = None,
        scene_shards: Union[str, int] = "auto",
        device_budget_mb: Optional[float] = None,
        max_batch: int = 8,
        max_wait: float = 0.05,
        queue_depth: int = 64,
        tile_params: Union[None, str, tuple] = None,
        autotune_opts: Optional[dict] = None,
        residency: Optional[ResidencyManager] = None,
        clock=time.monotonic,
    ):
        if devices is not None and mesh is not None:
            raise ValueError("pass devices or mesh, not both")
        if device is not None and (devices is not None or mesh is not None):
            raise ValueError("pass device, devices or mesh, not more than one")
        # Tile-grouping params: a (tile, group, tile_capacity) triple commits
        # now; 'auto' waits for the first render, which brings the camera
        # resolution the search needs. The scene it tunes on is held until
        # close(), which evicts its autotune entries.
        self._autotune_opts = dict(autotune_opts or {})
        self._tune_lock = threading.Lock()
        self._tune_pending = tile_params == "auto"
        self._tune_source = scene if self._tune_pending else None
        if tile_params is not None and not self._tune_pending:
            from repro_torch.autotune.search import Candidate, config_for

            try:
                cand = Candidate(*(int(x) for x in tile_params))
            except (TypeError, ValueError):
                raise ValueError(
                    f"tile_params must be None, 'auto', or a (tile, group, "
                    f"tile_capacity) triple; got {tile_params!r}"
                ) from None
            cfg = config_for(cfg, cand)
        shards = self._resolve_shards(scene, cfg, scene_shards)
        if device is not None:
            mesh = one_device_mesh(resolve_device(device))
        # The physical shard count: what divides the per-device bytes. On an
        # explicit mesh it is the mesh's 'model' extent (a mesh without one
        # keeps the shard axis logical: every device holds the whole scene);
        # otherwise the render_mesh_shards policy over the devices the mesh
        # is about to be built from.
        if mesh is not None:
            n_dev = mesh.size
            phys = shards if shards > 1 and mesh.shape.get("model", 1) == shards else 1
        else:
            devices = mesh_devices(devices)
            n_dev = len(devices)
            phys = render_mesh_shards(n_dev, shards)
        # Per-device budget model (DESIGN.md §12): the scene parameters at
        # 1/phys plus the per-camera projected features at the padded count
        # over the feature divisor (phys only under the psum gather). An
        # explicit device_budget_mb wins; a shared residency manager's budget
        # otherwise. The check is per scene: one that cannot fit alone fails
        # fast, while the aggregate across scenes is what the residency
        # manager pages against.
        budget_mb = device_budget_mb
        if budget_mb is None and residency is not None:
            budget_mb = residency.budget_mb
        scene_mb = pytree_bytes(scene) / 2**20

        def model(s, p):
            return scene_mb / p + self._feature_mb(scene, s) / self._feature_div(cfg, s, p)

        if budget_mb is not None:
            # Escalation only when the caller left both the layout and the
            # mesh to the handle (an explicit mesh cannot grow a 'model'
            # axis): the smallest shard count the device count realizes
            # physically that fits the cap.
            if (scene_shards == "auto" and mesh is None
                    and isinstance(scene, GaussianScene) and model(shards, phys) > budget_mb):
                for d in range(max(shards, 1), n_dev + 1):
                    if n_dev % d == 0 and model(d, d) <= budget_mb:
                        shards, phys = d, d
                        break
            if model(shards, phys) > budget_mb:
                layout = f"{phys}-way sharded" if phys > 1 else "replicated"
                fdiv = self._feature_div(cfg, shards, phys)
                raise ValueError(
                    f"scene needs {model(shards, phys):.2f} MB/device {layout} "
                    f"({scene_mb / phys:.2f} MB parameters + "
                    f"{self._feature_mb(scene, shards) / fdiv:.2f} MB per-camera "
                    f"projected features at N/{fdiv}), over the {budget_mb} MB "
                    f"budget — raise scene_shards or the device count"
                )
        self._scene_mb_per_device = scene_mb / phys
        self._feature_mb_per_device = (self._feature_mb(scene, shards)
                                       / self._feature_div(cfg, shards, phys))
        # What the commit runs ('flat' for a replicated frontend, even
        # though cfg.feature_gather may still read 'auto'). 'auto' resolves
        # to the psum gather over physical shards, to 'index' otherwise.
        self._feature_gather = self._resolved_gather(cfg, shards, phys)
        cfg_updates = {}
        if cfg.scene_shards != shards:
            cfg_updates["scene_shards"] = shards
        if shards > 1 and cfg.feature_gather == "auto":
            cfg_updates["feature_gather"] = self._feature_gather
        self._cfg = dataclasses.replace(cfg, **cfg_updates) if cfg_updates else cfg
        check_config(self._cfg)
        if mesh is None:
            mesh = make_render_mesh(devices, scene_shards=phys)
        model_extent = mesh.shape.get("model", 1)
        if shards > 1 and model_extent not in (1, shards):
            raise ValueError(
                f"mesh model axis ({model_extent}) must match scene_shards="
                f"{shards} (or be absent for a logical-only shard axis)"
            )
        self._mesh = mesh
        self._device = mesh.lead(0)
        self._phys_shards = phys
        # Stream sessions, before the commit: the residency entry's dynamic
        # cost (frontend_cache_mb) may run during the eager page-in below.
        self._worker_lock = threading.Lock()
        self._streams: List[Any] = []

        # Commit: a plain scene sharded D > 1 ways is staged on the host
        # through the refcounted layout cache (the layout survives until the
        # last handle over it closes), then registered with the residency
        # manager, which keeps a host copy as its backing store. The eager
        # acquire below is the commit's one placement over the mesh; under a
        # budgeted shared manager the scene may later page out and back in.
        staged = scene
        self._layout_ref = None
        if shards > 1 and isinstance(scene, GaussianScene):
            staged = acquire_scene_layout(scene, shards)
            self._layout_ref = (scene, shards)
        spec = (scene_shard_pspec(mesh) if isinstance(staged, ShardedScene)
                else render_replicated_pspec())
        self._residency = (
            residency if residency is not None
            else ResidencyManager(budget_mb=device_budget_mb)
        )
        self._res_entry = self._residency.register(
            (id(scene), shards, mesh),
            staged,
            Placement(mesh, spec),
            self._scene_mb_per_device + self._feature_mb_per_device,
            label=f"scene@{id(scene):#x}/D{shards}",
            source=scene,
        )
        # Dynamic cost: the stream sessions' frontend caches, through a
        # weakref so the shared entry never pins the handle; the last
        # release drops the entry and every callback with it.
        self_ref = weakref.ref(self)

        def _dyn_cost(ref=self_ref):
            h = ref()
            return h.frontend_cache_mb() if h is not None else 0.0

        self._dyn_cost = _dyn_cost
        self._res_entry.cost_fns.append(_dyn_cost)
        # A handle dropped without close() still releases its reference.
        self._res_finalizer = weakref.finalize(
            self, self._residency.release, self._res_entry
        )
        self._residency.acquire(self._res_entry)

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
    def mesh(self) -> RenderMesh:
        """The committed render mesh (a one-device ``('data',)`` mesh for
        ``device=``)."""
        return self._mesh

    @property
    def scene_shards(self) -> int:
        """The committed number of gaussian-axis shards D."""
        return self._cfg.scene_shards

    @property
    def tile_params(self) -> Union[str, tuple]:
        """The committed (tile, group, tile_capacity), or ``'auto
        (pending)'`` until an ``'auto'`` handle's first render resolves it."""
        if self._tune_pending:
            return "auto (pending)"
        return (self._cfg.tile, self._cfg.group, self._cfg.tile_capacity)

    @property
    def _placed(self) -> Optional[tuple]:
        """The committed scene placed over the mesh (one entry a data row,
        ``sharding/policies.py::place``), acquired through the
        residency manager on every use: an LRU touch while resident, a
        bitwise placement of the host backing after a page-out."""
        entry = self._res_entry
        if entry is None:
            return None
        return self._residency.acquire(entry)

    @property
    def _scene(self) -> Optional[SceneLike]:
        """The committed scene as data row 0 holds it (single renders and
        stream frames run there)."""
        placed = self._placed
        return None if placed is None else placed[0]

    @property
    def committed_scene(self) -> SceneLike:
        """The committed scene as data row 0 holds it (paged in if needed):
        whole on its lead device, or one shard a model column. Handles
        opened through one residency manager on the same (scene, layout,
        mesh) share one entry, and so one copy a device."""
        self._check_open()
        return self._scene

    @property
    def resident(self) -> bool:
        """Whether the committed scene is on the device right now (a
        budgeted shared manager may have paged it out; any render pages it
        back in)."""
        entry = self._res_entry
        return entry is not None and entry.resident

    def prefetch(self) -> bool:
        """Page the committed scene in ahead of a render (the serving
        tier's admission-time hook). True when a transfer happened."""
        self._check_open()
        return self._residency.prefetch(self._res_entry)

    def frontend_cache_mb(self) -> float:
        """Device MB held by this handle's stream sessions' frontend caches:
        memory the static budget model cannot see, charged against the
        residency budget as the entry's dynamic cost."""
        with self._worker_lock:
            streams = list(self._streams)
        return sum(s.cache_bytes() for s in streams if not s.closed) / 2**20

    def stats(self) -> dict:
        """Committed layout + per-handle cache and futures counters. Also
        publishes them as per-handle gauges in the metrics registry
        (dropped again by close())."""
        registry = get_registry()
        prefix = f"engine.{self.cache_name}."
        registry.gauge(prefix + "scene_mb_per_device").set(self._scene_mb_per_device)
        registry.gauge(prefix + "feature_mb_per_device").set(self._feature_mb_per_device)
        registry.gauge(prefix + "physical_shards").set(self._phys_shards)
        frontend_cache_mb = self.frontend_cache_mb()
        registry.gauge(prefix + "frontend_cache_mb").set(frontend_cache_mb)
        with self._worker_lock:
            counters = dict(self._counters)
        for k, v in counters.items():
            registry.gauge(prefix + k).set(v)
        return {
            "config": self._cfg,
            "tile_params": self.tile_params,
            "device": str(self._device),
            "mesh": dict(self._mesh.shape),
            "scene_shards": self._cfg.scene_shards,
            "physical_shards": self._phys_shards,
            "scene_mb_per_device": self._scene_mb_per_device,
            "feature_mb_per_device": self._feature_mb_per_device,
            "frontend_cache_mb": frontend_cache_mb,
            "resident": self.resident,
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
                fn = functools.partial(_mesh_batch, batch_renderer(cfg, *geom))
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

    def _resolve_tile_params(self, cam) -> None:
        """Resolve a pending ``tile_params='auto'`` at this camera's
        resolution: the autotune cache (memory, then file), or the two-phase
        search on the handle's device on a miss; then commit the winner into
        the handle's config. Runs once a handle, before the first renderer
        exists. Thread-safe: the submit worker, a stream and a direct call
        may race here."""
        if not self._tune_pending:
            return
        with self._tune_lock:
            if not self._tune_pending:
                return
            from repro_torch.autotune.search import autotune, config_for

            res = autotune(self._tune_source, cam, self._cfg, mesh=self._mesh,
                           **self._autotune_opts)
            self._cfg = config_for(self._cfg, res.candidate)
            self._tune_pending = False

    def _background(self, background, row: int = 0) -> Optional[torch.Tensor]:
        """The background on data row ``row``'s lead device."""
        if background is None:
            return None
        return torch.as_tensor(background, dtype=torch.float32,
                               device=self._mesh.lead(row))

    # -- synchronous entry points -------------------------------------------

    def render(self, cam: Camera, background=None) -> RenderResult:
        """Render one camera against the committed scene."""
        self._check_open()
        self._resolve_tile_params(cam)
        fn = self._fn("single", cam)
        with torch.inference_mode():
            return fn(self._scene, cam, self._background(background))

    def render_frontend(self, cam: Camera) -> FrontendResult:
        """Only the frontend half (project -> identify -> bin) for one
        camera; feed the result to :meth:`render_backend` for pixels."""
        self._check_open()
        self._resolve_tile_params(cam)
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
        self._resolve_tile_params(cam)
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
        field (B,), on the lead device of data row 0. The batch is padded to
        ``max(B, pad_to)`` rounded up to the mesh's data extent by
        replicating the last camera, as the JAX package pads its dispatch
        shape; the lanes go to the data rows contiguously
        (``camera_batch_pspec``), each rendered through ``render`` on its
        row's scene, so every lane is bitwise a single render. The padded
        lanes are rendered and dropped, and exactly B come back."""
        self._check_open()
        batch = cams if isinstance(cams, CameraBatch) else CameraBatch.from_cameras(cams)
        # An 'auto' handle tunes at lane 0: the signature reads only the
        # geometry every lane shares.
        self._resolve_tile_params(batch.camera(0))
        orig = len(batch)
        lanes = data_extent(self._mesh)
        padded = pad_camera_batch(batch, padded_size(max(orig, pad_to or 0), lanes))
        fn = self._fn("batch", padded)
        with torch.inference_mode():
            bgs = [self._background(background, r) for r in range(self._mesh.rows)]
            out = fn(self._placed, padded, bgs)
        if len(padded) != orig:
            out = out.map(lambda x: x[:orig])
        return out

    def open_stream(self, *, cache_frames: int = 32, spec_depth: int = 2,
                    speculate: bool = True):
        """Open a :class:`~repro_torch.engine.stream.StreamRenderer` over
        this handle: an exact-reuse frontend cache (``cache_frames`` poses,
        LRU) plus a speculation worker (``spec_depth`` pending predictions,
        drop-oldest; ``speculate=False`` keeps reuse only). :meth:`close`
        closes it."""
        self._check_open()
        from repro_torch.engine.stream import StreamRenderer

        stream = StreamRenderer(
            self, cache_frames=cache_frames, spec_depth=spec_depth, speculate=speculate,
        )
        with self._worker_lock:
            self._streams.append(stream)
        return stream

    def _forget_stream(self, stream) -> None:
        with self._worker_lock:
            if stream in self._streams:
                self._streams.remove(stream)

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
        padded = padded_size(max(len(reqs), self._max_batch), data_extent(self._mesh))
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
        """Close the streams, drain the worker, fail the futures it never
        resolved, drop and unregister the renderer cache, and release the
        residency entry (the shared device copy and host backing go when
        the last handle over them closes). Idempotent; the handle is
        unusable afterwards."""
        if self._closed:
            return
        # Streams first: their speculation workers dispatch through this
        # handle and their caches hold device tensors.
        with self._worker_lock:
            streams = list(self._streams)
        for stream in streams:
            stream.close()
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
        # Refcounted: another handle committed on the same (scene, layout,
        # device) through the same manager keeps the entry.
        try:
            self._res_entry.cost_fns.remove(self._dyn_cost)
        except ValueError:
            pass
        if self._res_finalizer.detach():
            self._residency.release(self._res_entry)
        self._res_entry = None
        if self._layout_ref is not None:
            # Only this handle's own (scene, D) reference: the cached host
            # layout drops when the last reference goes.
            release_scene_layout(*self._layout_ref)
            self._layout_ref = None
        if self._tune_source is not None:
            # The tune's in-memory entries go with the handle; the file keeps
            # them, so a re-open reloads instead of searching.
            from repro_torch.autotune import evict_autotune_entries

            evict_autotune_entries(self._tune_source)
            self._tune_source = None

    def __enter__(self) -> "Renderer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if self._closed else "open"
        return (
            f"<Renderer {self.cache_name} {state} mode={self._cfg.mode!r} "
            f"backend={self._cfg.backend!r} scene_shards={self._cfg.scene_shards} "
            f"mesh={dict(self._mesh.shape)} device={self._device}>"
        )


def open(  # noqa: A001 — the module-level session verb is the API
    scene: SceneLike,
    cfg: RenderConfig,
    *,
    device=None,
    devices: DevicesArg = None,
    mesh: Optional[RenderMesh] = None,
    scene_shards: Union[str, int] = "auto",
    device_budget_mb: Optional[float] = None,
    max_batch: int = 8,
    max_wait: float = 0.05,
    queue_depth: int = 64,
    tile_params: Union[None, str, tuple] = None,
    autotune_opts: Optional[dict] = None,
    residency: Optional[ResidencyManager] = None,
    clock=time.monotonic,
) -> Renderer:
    """Commit ``(scene, cfg)`` and return the :class:`Renderer`.

    * ``device``/``devices``/``mesh`` — where to commit (one of them): one
      device (a one-device mesh), a device list for
      ``launch/mesh.py::make_render_mesh`` (an int takes the first n cards;
      a list may repeat a device: virtual devices), or an explicit
      :class:`~repro_torch.launch.mesh.RenderMesh`. None of them: every
      visible card (raises when CUDA is missing; name the CPU to run
      there).
    * ``scene_shards`` — ``'auto'`` takes D from ``cfg.scene_shards``, or
      from a pre-sharded ``ShardedScene``; an int overrides it. The
      physical shard count is the mesh's ``'model'`` extent, or the
      ``render_mesh_shards`` policy over the devices (logical shards when
      the device count cannot realize D). ``feature_gather='auto'`` runs
      ``'psum'`` over physical shards, ``'index'`` otherwise.
    * ``device_budget_mb`` — per-device memory cap counting the scene
      parameters (1/D when physically sharded) plus the per-camera
      projected features (N/D under the psum gather, N otherwise). With
      ``scene_shards='auto'`` and no mesh the handle escalates the shard
      count until the scene fits; a scene over it otherwise raises.
    * ``residency`` — a shared :class:`~repro_torch.residency.ResidencyManager`:
      handles committed through one manager share one copy per (scene,
      layout, mesh) and page in and out against the manager's budget,
      bitwise invisibly. Without it the handle gets a private manager (no
      paging unless ``device_budget_mb`` forces it). With both,
      ``device_budget_mb`` bounds this scene alone.
    * ``max_batch``/``max_wait``/``queue_depth`` — the ``submit()`` futures
      front-end's batching knobs; ``clock`` is the scheduler's clock.
    * ``tile_params`` — ``None`` keeps the config's (tile, group,
      tile_capacity); a triple commits that one (``group_capacity`` floored
      at its tile capacity); ``'auto'`` tunes at the first render (the
      autotune cache, else the two-phase search over the mesh) and commits
      the winner. ``autotune_opts`` goes to
      :func:`repro_torch.autotune.autotune`. A gstg triple past 32 member
      tiles a group raises ``ValueError`` here.
    """
    return Renderer(
        scene, cfg, device=device, devices=devices, mesh=mesh, scene_shards=scene_shards,
        device_budget_mb=device_budget_mb,
        max_batch=max_batch, max_wait=max_wait, queue_depth=queue_depth,
        tile_params=tile_params, autotune_opts=autotune_opts,
        residency=residency, clock=clock,
    )


# ---------------------------------------------------------------------------
# Module-default handles (the deprecation shims' delegate)
# ---------------------------------------------------------------------------

_DEFAULT_MAX = 32
_default_handles: Dict[tuple, Renderer] = {}


def default_renderer(scene: SceneLike, cfg: RenderConfig, *,
                     mesh: Optional[RenderMesh] = None) -> Renderer:
    """The module-default handle for ``(scene, cfg, mesh)``.

    Backs the deprecated free functions (``render_jit``, ``render_image``,
    ``render_batch_sharded``): repeated calls with one scene, config and
    mesh reuse one committed handle and its cached renderers. Without a
    mesh the handle commits where the scene lives (shard 0's device for a
    physical ``ShardedScene``), as ``core.pipeline.render`` runs there.
    Bounded FIFO; an evicted handle is closed.
    """
    key = (id(scene), cfg, mesh if mesh is not None else scene.device)
    handle = _default_handles.get(key)
    if handle is not None and not handle.closed:
        return handle
    if mesh is not None:
        handle = Renderer(scene, cfg, mesh=mesh)
    else:
        handle = Renderer(scene, cfg, device=scene.device)
    while len(_default_handles) >= _DEFAULT_MAX:
        _default_handles.pop(next(iter(_default_handles))).close()
    _default_handles[key] = handle
    # An id() key alone could alias a recycled object: drop and close the
    # entry when the scene goes away.
    weakref.finalize(scene, _drop_default_handle, key)
    return handle


def _drop_default_handle(key) -> None:
    handle = _default_handles.pop(key, None)
    if handle is not None:
        handle.close()


def close_default_renderers() -> None:
    """Close and drop every module-default handle."""
    while _default_handles:
        _default_handles.pop(next(iter(_default_handles))).close()
