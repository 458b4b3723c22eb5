"""End-to-end rendering engine (mirror of ``repro.core.pipeline``; paper
Fig 1 vs Fig 9).

``render()`` runs the six stages (project -> identify -> bin/sort -> bitmask
-> compact -> rasterize, core/stages.py) on the backend named by
``RenderConfig.backend``: ``reference`` (plain PyTorch) or ``cuda`` (the
hand-written BGM and RM kernels). Three modes share the substrate:

  * ``tile_baseline``  — conventional 3D-GS: identify + sort + rasterize at
    the small-tile level. Sorting keys = (gaussian, tile) pairs.
  * ``group_baseline`` — identify + sort + rasterize at the group level
    (groups as large tiles).
  * ``gstg``           — the paper's method: group identification, group-wise
    sorting, per-entry tile bitmasks, FIFO compaction, small-tile
    rasterization. Sorting keys = (gaussian, group) pairs only.

Every mode returns the image plus RenderStats counters (int64 tensors).
``render_batch`` renders B cameras of one geometry lane by lane through
``render`` and stacks them, so every lane is bitwise equal to a single
render.

With ``scene_shards = D > 1`` (or a ``ShardedScene``) the frontend runs per
shard of the gaussian axis and merges the D bin tables with a stable sort
(``core/grouping.py::merge_bin_tables``); image and every counter are
bitwise those of D = 1 (DESIGN.md §10). On one device the shard axis is
logical. The timed-stage mode (``timing=True``) of the JAX package is not
ported yet and raises.

On the ``reference`` backend ``render`` is differentiable in the scene
(core/train.py): only projection, the feature gathers and the blend record
a graph; identify, bin, bitmask and compact give integers and run under
``no_grad``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.camera import Camera
from repro_torch.core.grouping import BinTable, GridSpec, sort_op_count
from repro_torch.core.projection import (
    FEATURE_GATHER_STRATEGIES,
    Projected,
    ShardedProjected,
    proj_valid_count,
)
from repro_torch.core.stages import Backend, get_backend
from repro_torch.obs import get_registry
from repro_torch.sharding.scene import SceneLike, ShardedScene, shard_scene
from repro_torch.utils import wide_count_sum
from repro_torch.utils.misc import not_ported

MODES = ("gstg", "tile_baseline", "group_baseline")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    tile: int = 16
    group: int = 64
    mode: str = "gstg"                 # gstg | tile_baseline | group_baseline
    boundary_group: str = "ellipse"    # group-identification method (GS-TG)
    boundary_tile: str = "ellipse"     # tile identification / bitmask method
    group_capacity: int = 512          # K: entries per group segment
    tile_capacity: int = 256           # K_t: entries per tile segment
    span: int = 4                      # candidate window at group level (bins)
    chunk: int = 32                    # raster gaussian chunk
    early_exit: bool = True
    backend: str = "reference"         # stage implementation: reference | cuda
    scene_shards: int = 1              # D: gaussian-axis shards (DESIGN.md §10)
    feature_gather: str = "auto"       # sharded feature gathers: auto (-> index) | index | psum | flat
    timing: bool = False               # timed-stage mode (not ported)


@dataclasses.dataclass
class RenderStats:
    """Operation counters for the paper's metrics + the cost model."""

    n_visible: torch.Tensor           # gaussians surviving culling
    n_candidate_tests: torch.Tensor   # identification boundary tests
    n_pairs_sort: torch.Tensor        # sorting keys (the paper's redundancy axis)
    sort_ops: torch.Tensor            # comparator-model ops sum L log L
    n_bit_tests: torch.Tensor         # bitmask-generation tile tests (gstg only)
    fifo_ops: torch.Tensor            # linear compaction ops (gstg only)
    alpha_ops: torch.Tensor           # per-pixel alpha computations
    blend_ops: torch.Tensor           # contributing blends
    tile_entries: torch.Tensor        # total per-tile raster entries
    overflow: torch.Tensor            # capacity-dropped entries (must be 0)
    span_overflow: torch.Tensor       # candidate-window dropped bins

    def as_dict(self) -> dict:
        """Counters as Python ints (one host sync)."""
        names = [f.name for f in dataclasses.fields(self)]
        values = torch.stack([getattr(self, n).to(torch.int64).reshape(()) for n in names])
        return dict(zip(names, values.tolist()))


@dataclasses.dataclass
class RenderResult:
    image: torch.Tensor
    stats: RenderStats

    def map(self, fn) -> "RenderResult":
        """The result with ``fn`` applied to the image and every counter
        (``lambda x: x[i]`` takes lane i of a batch, ``Tensor.cpu`` moves
        it to the host)."""
        return RenderResult(
            image=fn(self.image),
            stats=RenderStats(**{
                f.name: fn(getattr(self.stats, f.name))
                for f in dataclasses.fields(RenderStats)
            }),
        )


@dataclasses.dataclass
class FrontendResult:
    """What the frontend (project -> identify -> bin, and merge when
    sharded) hands the backend (bitmask -> compact -> rasterize)."""

    proj: Union[Projected, ShardedProjected]
    table: object                     # BinTable (group- or tile-level)
    n_visible: torch.Tensor
    n_candidate_tests: torch.Tensor
    n_pairs_sort: torch.Tensor
    span_overflow: torch.Tensor


def _grid(cam, cfg: RenderConfig) -> GridSpec:
    return GridSpec(
        width=cam.width, height=cam.height, tile=cfg.tile, group=cfg.group, span=cfg.span
    )


def check_config(cfg: RenderConfig) -> None:
    """Raise for a mode or feature-gather strategy the port does not know, a
    shard count below 1, a feature it has not ported yet, or a gstg grid
    whose member tiles outgrow the 32-bit tile mask."""
    if cfg.scene_shards < 1:
        raise ValueError(f"scene_shards must be >= 1, got {cfg.scene_shards}")
    if cfg.timing:
        raise NotImplementedError(
            "timing=True is not ported yet (ROADMAP queue 1, item 9: "
            "observability and TimedBackend)"
        )
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.feature_gather != "auto" and cfg.feature_gather not in FEATURE_GATHER_STRATEGIES:
        raise ValueError(
            f"unknown feature_gather {cfg.feature_gather!r}; expected "
            f"'auto' or one of {FEATURE_GATHER_STRATEGIES}"
        )
    tpg = (cfg.group // cfg.tile) ** 2
    if cfg.mode == "gstg" and tpg > 32:
        # The JAX package renders this case wrong (it drops member tiles 32
        # and up), so the port refuses it rather than copy that.
        raise ValueError(
            f"gstg needs at most 32 member tiles a group, one bit each in the 32-bit "
            f"tile mask; tile {cfg.tile} and group {cfg.group} give {tpg}"
        )


def _scene_for_render(scene: SceneLike, cfg: RenderConfig) -> SceneLike:
    """The scene in the layout ``cfg.scene_shards`` asks for: a plain scene
    with ``scene_shards > 1`` is padded and sharded here
    (``sharding/scene.py``); a ShardedScene is taken at any D that matches
    the config, D = 1 included."""
    if isinstance(scene, ShardedScene):
        if scene.num_shards != cfg.scene_shards:
            raise ValueError(
                f"scene has {scene.num_shards} shards but cfg.scene_shards="
                f"{cfg.scene_shards}; the shard count is part of the static "
                "signature and must agree"
            )
        return scene
    if cfg.scene_shards > 1:
        return shard_scene(scene, cfg.scene_shards)
    return scene


def resolve_feature_gather(cfg: RenderConfig) -> str:
    """``cfg.feature_gather`` as a concrete strategy: ``'auto'`` is
    ``'index'``, the plain (shard, local) gather. All strategies are
    bitwise alike (DESIGN.md §12); only memory and layout differ."""
    if cfg.feature_gather == "auto":
        return "index"
    if cfg.feature_gather not in FEATURE_GATHER_STRATEGIES:
        raise ValueError(
            f"unknown feature_gather {cfg.feature_gather!r}; expected "
            f"'auto' or one of {FEATURE_GATHER_STRATEGIES}"
        )
    return cfg.feature_gather


def render(
    scene: SceneLike,
    cam: Camera,
    cfg: RenderConfig,
    background: Optional[torch.Tensor] = None,
) -> RenderResult:
    """Render one camera through the staged engine on ``cfg.backend``, on
    the scene's device. ``scene`` is a plain GaussianScene or a ShardedScene
    with ``cfg.scene_shards`` shards."""
    check_config(cfg)
    backend = get_backend(cfg.backend)
    front = _run_frontend(backend, scene, cam, cfg)
    return _run_backend(backend, front, cam, cfg, background)


def render_frontend(scene: SceneLike, cam: Camera, cfg: RenderConfig) -> FrontendResult:
    """The frontend half of :func:`render`: project -> identify -> bin (and
    the cross-shard merge when sharded)."""
    check_config(cfg)
    return _run_frontend(get_backend(cfg.backend), scene, cam, cfg)


def render_backend(
    front: FrontendResult,
    cam: Camera,
    cfg: RenderConfig,
    background: Optional[torch.Tensor] = None,
) -> RenderResult:
    """The backend half of :func:`render`: pixels from a FrontendResult.
    ``render_backend(render_frontend(scene, cam, cfg), cam, cfg)`` equals
    ``render(scene, cam, cfg)``; only the static geometry of ``cam`` is
    read."""
    check_config(cfg)
    return _run_backend(get_backend(cfg.backend), front, cam, cfg, background)


def _frontend_spec(cfg: RenderConfig, grid: GridSpec) -> tuple:
    """The (level, method, num_bins, capacity) the mode's frontend runs at."""
    if cfg.mode == "gstg":
        return "group", cfg.boundary_group, grid.num_groups, cfg.group_capacity
    if cfg.mode == "tile_baseline":
        return "tile", cfg.boundary_tile, grid.num_tiles, cfg.tile_capacity
    if cfg.mode == "group_baseline":
        return "group", cfg.boundary_tile, grid.num_groups, cfg.group_capacity
    raise ValueError(f"unknown mode {cfg.mode!r}")


def _run_frontend(backend: Backend, scene, cam, cfg: RenderConfig) -> FrontendResult:
    """Stages 1-3 for any mode: ONE sort per bin at the mode's granularity;
    per shard, then the stable merge, when the scene is sharded."""
    grid = _grid(cam, cfg)
    level, method, num_bins, capacity = _frontend_spec(cfg, grid)
    gather = resolve_feature_gather(cfg)
    scene = _scene_for_render(scene, cfg)
    if isinstance(scene, ShardedScene):
        proj, table, counts = _sharded_frontend(
            backend, scene, cam, grid, level, method, num_bins, capacity, gather)
    else:
        proj = backend.project(scene, cam)
        # Identify and bin return integers and masks, so no gradient flows
        # through them; without a graph they keep no residuals of their
        # float inputs (36.9 M candidate pairs at the paper's frame).
        with torch.no_grad():
            pairs = backend.identify(proj, grid, level, method)
            table = backend.bin(pairs, num_bins, capacity)
        counts = (pairs.n_candidate_tests, pairs.n_pairs, pairs.n_span_overflow)
    return FrontendResult(
        proj=proj,
        table=table,
        n_visible=proj_valid_count(proj),
        n_candidate_tests=counts[0],
        n_pairs_sort=counts[1],
        span_overflow=counts[2],
    )


def _sharded_frontend(backend: Backend, scene: ShardedScene, cam, grid: GridSpec,
                      level: str, method: str, num_bins: int, capacity: int, gather: str):
    """Project, identify and bin each shard on its own, then merge the D
    tables into the global depth-ordered table, bitwise the replicated one
    (core/grouping.py::merge_bin_tables). The table's ``gauss_idx`` stays
    global: shard d starts at d * Ns in the gaussian-contiguous layout.
    Downstream gathers decompose it into (shard, local) (``proj_take``)
    unless ``gather`` is ``'flat'``, which hands on the padded flat view.

    Returns ``(proj, table, (n_candidate_tests, n_pairs, n_span_overflow))``
    with the counters summed over shards in int64."""
    D, Ns = scene.num_shards, scene.shard_size
    projs, tables, depths, counts = [], [], [], []
    for d in range(D):
        proj = backend.project(scene.shard(d), cam)
        with torch.no_grad():
            pairs = backend.identify(proj, grid, level, method)
            table = backend.bin(pairs, num_bins, capacity)
            valid = table.entry_valid
            # The merge keys, gathered from the shard's own rows: bitwise
            # the flat proj.depth[global index].
            depths.append(torch.where(valid, proj.depth[table.gauss_idx.long()], float("inf")))
            tables.append(dataclasses.replace(
                table, gauss_idx=torch.where(valid, table.gauss_idx + d * Ns, 0)))
        counts.append(torch.stack([pairs.n_candidate_tests, pairs.n_pairs,
                                   pairs.n_span_overflow]).to(torch.int64))
        projs.append(proj)
        del pairs     # this shard's candidates go before the next shard's are made
    with torch.no_grad():
        stacked = BinTable(**{
            f.name: torch.stack([getattr(t, f.name) for t in tables])
            for f in dataclasses.fields(BinTable)
        })
        table = backend.merge(stacked, torch.stack(depths))
    shards = Projected(**{
        f.name: torch.stack([getattr(p, f.name) for p in projs])
        for f in dataclasses.fields(Projected)
    })
    if gather == "flat":
        proj = Projected(**{
            f.name: getattr(shards, f.name).flatten(0, 1) for f in dataclasses.fields(Projected)
        })
    else:
        proj = ShardedProjected(shards=shards, gather=gather)
    return proj, table, tuple(torch.sum(torch.stack(counts), dim=0))


def _run_backend(backend: Backend, front: FrontendResult, cam, cfg: RenderConfig,
                 background) -> RenderResult:
    """Stages 4-6 on a FrontendResult: bitmask/compact/rasterize for gstg,
    direct per-bin rasterization for the baselines."""
    grid = _grid(cam, cfg)
    proj, table = front.proj, front.table
    zero = torch.zeros((), dtype=torch.int64, device=table.gauss_idx.device)

    if cfg.mode == "gstg":
        # 4) BGM: tile-granularity tests on the group entries. 5) RM FIFO:
        # materialized by the reference, virtual for the fused RM. Both give
        # integers, so they record no graph.
        with torch.no_grad():
            masks = backend.bitmasks(proj, table, grid, cfg.boundary_tile, chunk=cfg.chunk)
            compacted = backend.compact(table, masks, grid, cfg.tile_capacity)
        # 6) Small-tile rasterization.
        rast = backend.rasterize_groups(
            proj, table, masks, compacted, grid,
            background=background, chunk=cfg.chunk, early_exit=cfg.early_exit,
            tile_capacity=cfg.tile_capacity,
        )
        stats = RenderStats(
            n_visible=front.n_visible,
            n_candidate_tests=front.n_candidate_tests,
            n_pairs_sort=front.n_pairs_sort,
            sort_ops=sort_op_count(table.lengths),
            n_bit_tests=masks.n_bit_tests,
            fifo_ops=wide_count_sum(table.lengths) * grid.tiles_per_group,
            alpha_ops=rast.alpha_ops,
            blend_ops=rast.blend_ops,
            tile_entries=compacted.tile_entries,
            overflow=table.overflow + compacted.overflow,
            span_overflow=front.span_overflow,
        )
        return RenderResult(image=rast.image, stats=stats)

    if cfg.mode == "tile_baseline":
        raster_grid = grid
    else:
        # Rasterize at group granularity: treat groups as (large) tiles.
        raster_grid = GridSpec(
            width=grid.n_groups_x * grid.group,
            height=grid.n_groups_y * grid.group,
            tile=grid.group,
            group=grid.group,
            span=cfg.span,
        )
    rast = backend.rasterize_tiles(
        proj, table, raster_grid,
        background=background, chunk=cfg.chunk, early_exit=cfg.early_exit,
    )
    stats = RenderStats(
        n_visible=front.n_visible,
        n_candidate_tests=front.n_candidate_tests,
        n_pairs_sort=front.n_pairs_sort,
        sort_ops=sort_op_count(table.lengths),
        n_bit_tests=zero,
        fifo_ops=zero,
        alpha_ops=rast.alpha_ops,
        blend_ops=rast.blend_ops,
        tile_entries=wide_count_sum(table.lengths),
        overflow=table.overflow,
        span_overflow=front.span_overflow,
    )
    return RenderResult(image=rast.image[: cam.height, : cam.width], stats=stats)


# ---------------------------------------------------------------------------
# Batched multi-camera rendering (cached by static signature)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CameraBatch:
    """A batch of cameras sharing static geometry (resolution, clip planes).

    Per-camera pose and intrinsics are stacked host tensors. The intrinsics
    stay float64, so :meth:`camera` rebuilds each lane's Camera exactly as
    it came in and a lane renders bitwise like the single camera.
    """

    R: torch.Tensor    # (B, 3, 3) float32
    t: torch.Tensor    # (B, 3) float32
    fx: torch.Tensor   # (B,) float64
    fy: torch.Tensor   # (B,) float64
    cx: torch.Tensor   # (B,) float64
    cy: torch.Tensor   # (B,) float64
    width: int
    height: int
    znear: float = 0.2
    zfar: float = 1000.0

    @classmethod
    def from_cameras(cls, cams: Sequence[Camera]) -> "CameraBatch":
        if not cams:
            raise ValueError("empty camera batch")
        w, h = cams[0].width, cams[0].height
        zn, zf = cams[0].znear, cams[0].zfar
        for c in cams:
            if (c.width, c.height, c.znear, c.zfar) != (w, h, zn, zf):
                raise ValueError(
                    "all cameras in a batch must share width/height/znear/zfar"
                )

        def stack(f, dtype):
            return torch.from_numpy(np.stack([np.asarray(f(c), dtype) for c in cams]))

        return cls(
            R=stack(lambda c: c.R, np.float32),
            t=stack(lambda c: c.t, np.float32),
            fx=stack(lambda c: c.fx, np.float64),
            fy=stack(lambda c: c.fy, np.float64),
            cx=stack(lambda c: c.cx, np.float64),
            cy=stack(lambda c: c.cy, np.float64),
            width=w,
            height=h,
            znear=zn,
            zfar=zf,
        )

    def __len__(self) -> int:
        return int(self.R.shape[0])

    def camera(self, i: int) -> Camera:
        """Lane ``i`` as a Camera."""
        return Camera(
            R=self.R[i].cpu().numpy(), t=self.t[i].cpu().numpy(),
            fx=float(self.fx[i]), fy=float(self.fy[i]),
            cx=float(self.cx[i]), cy=float(self.cy[i]),
            width=self.width, height=self.height, znear=self.znear, zfar=self.zfar,
        )


def batch_signature(cfg: RenderConfig, cam) -> tuple:
    """The full static signature of one (config, camera-geometry) pair.

    Accepts a ``Camera`` or a ``CameraBatch`` (anything with width/height/
    znear/zfar). Two renders share a cached renderer iff their signatures
    are equal; the serving bucketer groups requests by this key.
    """
    return (cfg, cam.width, cam.height, cam.znear, cam.zfar)


def _stack_results(outs: Sequence[RenderResult]) -> RenderResult:
    """B single-camera results -> one result: image (B, H, W, 3), each
    stats field (B,)."""
    names = [f.name for f in dataclasses.fields(RenderStats)]
    return RenderResult(
        image=torch.stack([o.image for o in outs]),
        stats=RenderStats(**{
            n: torch.stack([getattr(o.stats, n).reshape(()) for o in outs])
            for n in names
        }),
    )


def batch_renderer(cfg: RenderConfig, width, height, znear, zfar):
    """The renderer of one static signature: ``fn(scene, batch, background)``
    renders each lane through :func:`render` and stacks the results."""

    def fn(scene, batch: CameraBatch, background=None) -> RenderResult:
        if (batch.width, batch.height, batch.znear, batch.zfar) != (width, height, znear, zfar):
            raise ValueError("camera batch geometry differs from the renderer's signature")
        scene = _scene_for_render(scene, cfg)    # shard once for every lane
        return _stack_results(
            [render(scene, batch.camera(i), cfg, background) for i in range(len(batch))]
        )

    return fn


_batch_renderer = functools.lru_cache(maxsize=64)(batch_renderer)


# Auxiliary renderer-adjacent caches (name -> (info_fn, clear_fn)). Every
# open engine handle registers its cache here, so ``render_cache_clear`` /
# ``render_cache_info`` stay the single source of truth.
_AUX_RENDER_CACHES: dict = {}


def register_render_cache(name: str, *, info, clear) -> None:
    """Register an auxiliary cache under ``name``. ``info()`` must return a
    dict with at least ``hits``/``misses`` ints; ``clear()`` must drop every
    entry and reset both."""
    if name in ("single", "batch"):
        raise ValueError(f"cache name {name!r} is reserved")
    _AUX_RENDER_CACHES[name] = (info, clear)


def unregister_render_cache(name: str) -> None:
    """Remove an auxiliary cache from the registry. Unknown names are a
    no-op so close() stays idempotent."""
    _AUX_RENDER_CACHES.pop(name, None)


def render_cache_clear() -> None:
    """Drop ALL cached renderers and registered auxiliary caches."""
    _batch_renderer.cache_clear()
    for _, clear in list(_AUX_RENDER_CACHES.values()):
        clear()


def render_cache_info() -> dict:
    """Statistics for every renderer cache as plain dicts:
    ``{"batch": {hits, misses, currsize, maxsize}, **aux}`` with one
    ``"engineN"`` entry per open handle."""
    info = _batch_renderer.cache_info()
    out = {
        "batch": {
            "hits": info.hits, "misses": info.misses,
            "currsize": info.currsize, "maxsize": info.maxsize,
        },
    }
    for name, (aux_info, _) in list(_AUX_RENDER_CACHES.items()):
        out[name] = aux_info()
    return out


def _collect_render_caches(registry) -> None:
    """Metrics collector: publish every render cache's hit/miss/size table
    as ``render_cache.<name>.<field>`` gauges at snapshot time; the prefix
    is dropped first so closed handles leave no stale series behind."""
    registry.drop("render_cache.")
    for kind, info in render_cache_info().items():
        for k, v in info.items():
            if isinstance(v, (int, float)):
                registry.gauge(f"render_cache.{kind}.{k}").set(v)


get_registry().register_collector("render_caches", _collect_render_caches)


def render_batch(
    scene: SceneLike,
    cams: Union[CameraBatch, Sequence[Camera]],
    cfg: RenderConfig,
    background: Optional[torch.Tensor] = None,
) -> RenderResult:
    """Render B cameras of one geometry (image: (B, H, W, 3); stats: (B,)),
    each lane bitwise equal to ``render(scene, cam_i, cfg, background)``.
    The renderer is cached by the static (RenderConfig, geometry)
    signature."""
    batch = cams if isinstance(cams, CameraBatch) else CameraBatch.from_cameras(cams)
    return _batch_renderer(*batch_signature(cfg, batch))(scene, batch, background)


_ITEM_SHIMS = "6: the JAX package's deprecated free functions"
render_jit = not_ported("render_jit", _ITEM_SHIMS)
render_image = not_ported("render_image", _ITEM_SHIMS)
frontend_stats = not_ported("frontend_stats", "11: streams, autotune and residency")
