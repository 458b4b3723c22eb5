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
The scene-sharded frontend (``scene_shards > 1``) and the timed-stage mode
(``timing=True``) of the JAX package are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.grouping import GridSpec, sort_op_count
from repro_torch.core.projection import Projected, proj_valid_count
from repro_torch.core.stages import Backend, get_backend
from repro_torch.utils import wide_count_sum

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
    scene_shards: int = 1              # D: gaussian-axis shards (only 1 ported)
    feature_gather: str = "auto"       # sharded feature gathers (not ported)
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


@dataclasses.dataclass
class FrontendResult:
    """What the frontend (project -> identify -> bin) hands the backend
    (bitmask -> compact -> rasterize)."""

    proj: Projected
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
    """Raise for a mode the port does not know or a feature it has not
    ported yet."""
    if cfg.scene_shards != 1:
        raise NotImplementedError(
            "scene_shards != 1 is not ported yet (ROADMAP queue 1, item 8: "
            "sharding along the gaussian axis)"
        )
    if cfg.timing:
        raise NotImplementedError(
            "timing=True is not ported yet (ROADMAP queue 1, item 9: "
            "observability and TimedBackend)"
        )
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}")


def render(
    scene: GaussianScene,
    cam: Camera,
    cfg: RenderConfig,
    background: Optional[torch.Tensor] = None,
) -> RenderResult:
    """Render one camera through the staged engine on ``cfg.backend``, on
    the scene's device."""
    check_config(cfg)
    backend = get_backend(cfg.backend)
    front = _run_frontend(backend, scene, cam, cfg)
    return _run_backend(backend, front, cam, cfg, background)


def render_frontend(scene: GaussianScene, cam: Camera, cfg: RenderConfig) -> FrontendResult:
    """The frontend half of :func:`render`: project -> identify -> bin."""
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
    """Stages 1-3 for any mode: ONE sort per bin at the mode's granularity."""
    grid = _grid(cam, cfg)
    level, method, num_bins, capacity = _frontend_spec(cfg, grid)
    proj = backend.project(scene, cam)
    pairs = backend.identify(proj, grid, level, method)
    table = backend.bin(pairs, num_bins, capacity)
    return FrontendResult(
        proj=proj,
        table=table,
        n_visible=proj_valid_count(proj),
        n_candidate_tests=pairs.n_candidate_tests,
        n_pairs_sort=pairs.n_pairs,
        span_overflow=pairs.n_span_overflow,
    )


def _run_backend(backend: Backend, front: FrontendResult, cam, cfg: RenderConfig,
                 background) -> RenderResult:
    """Stages 4-6 on a FrontendResult: bitmask/compact/rasterize for gstg,
    direct per-bin rasterization for the baselines."""
    grid = _grid(cam, cfg)
    proj, table = front.proj, front.table
    zero = torch.zeros((), dtype=torch.int64, device=table.gauss_idx.device)

    if cfg.mode == "gstg":
        # 4) BGM: tile-granularity tests on the group entries.
        masks = backend.bitmasks(proj, table, grid, cfg.boundary_tile, chunk=cfg.chunk)
        # 5) RM FIFO: materialized by the reference, virtual for the fused RM.
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
