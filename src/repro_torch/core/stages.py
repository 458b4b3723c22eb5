"""Stage decomposition of the GS-TG pipeline + backend dispatch (mirror of
``repro.core.stages``).

    project -> identify -> bin/sort -> bitmask -> compact -> rasterize

A ``Backend`` supplies the stage implementations behind ``render()``:

  * ``reference`` — plain PyTorch ops throughout (the oracle).
  * ``cuda``      — BGM + rasterizers as hand-written CUDA kernels (the role
    ``pallas`` plays in the JAX package). On CPU tensors its kernel wrappers
    run their plain PyTorch versions; on CUDA tensors they launch the
    kernels or raise. Identification and the stable group sort stay plain
    torch ops (the stable sort is what losslessness rests on).

The ``cuda`` backend's compact stage is virtual: the fused RM kernel applies
the bitmask filter in registers, so only the per-tile lengths/overflow are
computed (a popcount) to keep the counters identical to the reference.

``TimedBackend`` wraps either backend for ``RenderConfig(timing=True)``:
each stage fenced and recorded as a ``stage/<name>`` span.
"""
from __future__ import annotations

import abc
import dataclasses
import math
import threading
from typing import Dict, Optional

import torch

from repro_torch.core.bitmask import GroupBitmasks, compact_tiles, generate_bitmasks, tile_bits
from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.grouping import (
    BinTable,
    GridSpec,
    PairSet,
    bin_pairs,
    identify,
    merge_bin_tables,
)
from repro_torch.core.projection import Projected, ShardedProjected, project
from repro_torch.core.raster import rasterize
from repro_torch.kernels.bitmask_gen import bitmask_kernel
from repro_torch.kernels.layout import LANE, pack_features
from repro_torch.kernels.ops import (
    assemble_image,
    assemble_image_tiles,
    group_origins,
    tile_origins,
    tiles_in_image,
)
from repro_torch.kernels.raster_tile import raster_group_fused_kernel, raster_tile_kernel
from repro_torch.obs import get_tracer
from repro_torch.utils.misc import fence


@dataclasses.dataclass
class TileRaster:
    """Output of the rasterize stage over a tile-level work list."""

    image: torch.Tensor       # (grid.height, grid.width, 3)
    alpha_ops: torch.Tensor   # () int64
    blend_ops: torch.Tensor   # () int64


@dataclasses.dataclass
class CompactedTiles:
    """Result of the compact stage (RM FIFO). ``table`` is materialized only
    by the reference backend; the fused CUDA RM leaves it None."""

    tile_entries: torch.Tensor   # () int64: sum of per-tile lengths (pre-clamp)
    overflow: torch.Tensor       # () int64: entries dropped by tile_capacity
    table: Optional[BinTable] = None


def mask_tile_lengths(
    gtable: BinTable, masks: GroupBitmasks, grid: GridSpec
) -> torch.Tensor:
    """(num_groups, tiles_per_group) per-member-tile entry counts — a
    popcount over the bitmask columns; equals ``compact_tiles(...).lengths``
    regrouped by (group, slot)."""
    bits = tile_bits(masks.masks, grid.tiles_per_group) & gtable.entry_valid[:, :, None]
    return torch.sum(bits, dim=1)  # (G, tpg) int64


class Backend(abc.ABC):
    """Stage implementations behind ``render()``. Identification and binning
    default to the shared plain substrate (stable sort => 3D-GS tie-break
    => losslessness)."""

    name: str = "abstract"

    # -- stage 1: preprocessing ------------------------------------------
    def project(self, scene: GaussianScene, cam: Camera) -> Projected:
        return project(scene, cam)

    # -- stage 2: group/tile identification ------------------------------
    def identify(self, proj: Projected, grid: GridSpec, level: str, method: str) -> PairSet:
        return identify(proj, grid, level, method)

    # -- stage 3: binning + depth sort -----------------------------------
    def bin(self, pairs: PairSet, num_bins: int, capacity: int) -> BinTable:
        return bin_pairs(pairs, num_bins, capacity)

    # -- stage 3b: cross-shard merge (scene-sharded frontend) ------------
    def merge(self, tables: BinTable, depth: torch.Tensor) -> BinTable:
        """Combine D per-shard bin tables (shard-stacked, gauss_idx already
        global) into the global depth-ordered table. The same stable merge
        on every backend: it keeps the (depth, insertion-order) tie-break
        bit for bit (core/grouping.py::merge_bin_tables)."""
        return merge_bin_tables(tables, depth)

    # -- stage 4: bitmask generation (BGM) -------------------------------
    @abc.abstractmethod
    def bitmasks(self, proj, gtable, grid, method, *, chunk: int = 32) -> GroupBitmasks:
        """``chunk`` is the raster chunk size — a layout hint so kernel
        backends pack features with the padding rasterization wants."""

    # -- stage 5: RM FIFO compaction -------------------------------------
    @abc.abstractmethod
    def compact(self, gtable, masks, grid, tile_capacity: int) -> CompactedTiles:
        ...

    # -- stage 6: rasterization ------------------------------------------
    @abc.abstractmethod
    def rasterize_tiles(self, proj, table, grid, *, background, chunk, early_exit) -> TileRaster:
        """Rasterize a tile-level table (the baselines; reference gstg)."""

    @abc.abstractmethod
    def rasterize_groups(self, proj, gtable, masks, compacted, grid, *,
                         background, chunk, early_exit, tile_capacity) -> TileRaster:
        """Rasterize the gstg work list (group table + per-entry bitmasks)."""


class ReferenceBackend(Backend):
    """Plain PyTorch stages: the oracle (core/raster.py)."""

    name = "reference"

    def bitmasks(self, proj, gtable, grid, method, *, chunk=32):
        return generate_bitmasks(proj, gtable, grid, method)

    def compact(self, gtable, masks, grid, tile_capacity):
        table = compact_tiles(gtable, masks, grid, tile_capacity)
        return CompactedTiles(
            tile_entries=torch.sum(table.lengths.to(torch.int64)),
            overflow=table.overflow,
            table=table,
        )

    def rasterize_tiles(self, proj, table, grid, *, background, chunk, early_exit):
        rast = rasterize(proj, table, grid, background, chunk=chunk, early_exit=early_exit)
        return TileRaster(image=rast.image, alpha_ops=rast.alpha_ops, blend_ops=rast.blend_ops)

    def rasterize_groups(self, proj, gtable, masks, compacted, grid, *,
                         background, chunk, early_exit, tile_capacity):
        return self.rasterize_tiles(
            proj, compacted.table, grid,
            background=background, chunk=chunk, early_exit=early_exit,
        )


def refuse_grad(proj) -> None:
    """Raise when autograd records and a float feature of ``proj`` (flat or
    sharded) requires grad: the hand kernels record no graph, so a loss
    through them would have no gradient. Raised on every device, also where
    the wrappers run their plain versions."""
    parts = proj.shards if isinstance(proj, ShardedProjected) else proj
    parts = parts if isinstance(parts, tuple) else (parts,)
    if torch.is_grad_enabled() and any(
        getattr(p, f.name).requires_grad for p in parts for f in dataclasses.fields(p)
    ):
        raise RuntimeError(
            "the cuda backend's hand kernels record no gradient; "
            "train through RenderConfig(backend='reference')"
        )


class CudaBackend(Backend):
    """BGM + RM as hand-written CUDA kernels, same counters as the
    reference. The fused RM never materializes per-tile tables; it honours
    tile_capacity in registers and counts alpha/blend ops in the kernel.
    Its rasterizers refuse features that require grad (``refuse_grad``)."""

    name = "cuda"

    @staticmethod
    def _pad_multiple(chunk: int) -> int:
        return math.lcm(LANE, max(int(chunk), 1))

    def bitmasks(self, proj, gtable, grid, method, *, chunk=32):
        dev = gtable.gauss_idx.device
        feat = pack_features(
            proj, gtable.gauss_idx, gtable.entry_valid, multiple=self._pad_multiple(chunk)
        )
        masks = bitmask_kernel(
            feat, group_origins(grid, dev), tiles_in_image(grid, dev),
            grid.tile, grid.gf, method=method,
        )
        # Kernel masks cover the padded K axis; crop to the table capacity.
        masks = masks[:, : gtable.capacity]
        n_tests = torch.sum(gtable.entry_valid.to(torch.int64)) * grid.tiles_per_group
        return GroupBitmasks(masks=masks, n_bit_tests=n_tests)

    def compact(self, gtable, masks, grid, tile_capacity):
        lengths = mask_tile_lengths(gtable, masks, grid)
        return CompactedTiles(
            tile_entries=torch.sum(lengths),
            overflow=torch.sum(torch.clamp(lengths - tile_capacity, min=0)),
            table=None,
        )

    def rasterize_tiles(self, proj, table, grid, *, background, chunk, early_exit):
        refuse_grad(proj)
        feat = pack_features(
            proj, table.gauss_idx, table.entry_valid, multiple=self._pad_multiple(chunk)
        )
        K = feat.shape[-1]
        out, counts = raster_tile_kernel(
            feat, tile_origins(grid, feat.device), grid.tile,
            chunk=min(chunk, K), early_exit=early_exit,
        )
        return TileRaster(
            image=assemble_image_tiles(out, grid, background),
            alpha_ops=torch.sum(counts[:, 0].to(torch.int64)),
            blend_ops=torch.sum(counts[:, 1].to(torch.int64)),
        )

    def rasterize_groups(self, proj, gtable, masks, compacted, grid, *,
                         background, chunk, early_exit, tile_capacity):
        refuse_grad(proj)
        feat = pack_features(
            proj, gtable.gauss_idx, gtable.entry_valid, multiple=self._pad_multiple(chunk)
        )
        K = feat.shape[-1]
        pad = K - masks.masks.shape[1]
        padded = torch.nn.functional.pad(masks.masks, (0, pad)) if pad else masks.masks
        out, counts = raster_group_fused_kernel(
            feat, padded.contiguous(), group_origins(grid, feat.device), grid.tile, grid.gf,
            chunk=min(chunk, K), early_exit=early_exit, tile_capacity=tile_capacity,
        )
        return TileRaster(
            image=assemble_image(out, grid, background),
            alpha_ops=torch.sum(counts[:, :, 0].to(torch.int64)),
            blend_ops=torch.sum(counts[:, :, 1].to(torch.int64)),
        )


class TimedBackend(Backend):
    """Per-stage timed execution of a wrapped backend (DESIGN.md §14).

    Every stage call is fenced on both sides (``utils/misc.py::fence``: a
    synchronize of each CUDA device the stage's operands live on, nothing
    on the CPU), so the host
    interval between the fences is the stage's device time. It is recorded
    as a ``stage/<name>`` span on the process tracer (``force=True``:
    ``RenderConfig.timing`` is the opt-in) inside a
    ``torch.profiler.record_function`` of the same name, so the spans line
    up with a device trace when the profiler runs.

    The inner stage runs as it is, on the same tensors: a fence changes no
    result, so a timed render is bitwise the untimed one, and on the
    ``reference`` backend autograd records the same graph. The sharded
    frontend loops over its shards, so each shard's project, identify and
    bin is a span of its own (the JAX package records one vmapped span per
    stage).
    """

    def __init__(self, inner: Backend):
        self.inner = inner
        self.name = f"timed:{inner.name}"

    def _run(self, stage: str, fn, *args, **kwargs):
        tracer = get_tracer()
        fence(args)
        t0 = tracer.clock()
        with torch.profiler.record_function(f"stage/{stage}"):
            out = fn(*args, **kwargs)
        fence(args)
        tracer.complete(
            f"stage/{stage}", t0, tracer.clock(), category="stage",
            args={"backend": self.inner.name}, force=True,
        )
        return out

    def project(self, scene, cam):
        return self._run("project", self.inner.project, scene, cam)

    def identify(self, proj, grid, level, method):
        return self._run("identify", self.inner.identify, proj, grid, level, method)

    def bin(self, pairs, num_bins, capacity):
        return self._run("bin", self.inner.bin, pairs, num_bins, capacity)

    def merge(self, tables, depth):
        return self._run("merge", self.inner.merge, tables, depth)

    def bitmasks(self, proj, gtable, grid, method, *, chunk=32):
        return self._run("bitmask", self.inner.bitmasks, proj, gtable, grid, method,
                         chunk=chunk)

    def compact(self, gtable, masks, grid, tile_capacity):
        return self._run("compact", self.inner.compact, gtable, masks, grid, tile_capacity)

    def rasterize_tiles(self, proj, table, grid, *, background, chunk, early_exit):
        return self._run("rasterize", self.inner.rasterize_tiles, proj, table, grid,
                         background=background, chunk=chunk, early_exit=early_exit)

    def rasterize_groups(self, proj, gtable, masks, compacted, grid, *,
                         background, chunk, early_exit, tile_capacity):
        return self._run("rasterize", self.inner.rasterize_groups, proj, gtable, masks,
                         compacted, grid, background=background, chunk=chunk,
                         early_exit=early_exit, tile_capacity=tile_capacity)


# The TimedBackend wrappers, one per inner backend. The JAX package caches a
# jit'd program per timed stage under the render-cache name "timed_stage";
# the port compiles no per-stage programs, so its counterpart caches the
# wrappers, keyed by the inner backend's name (core/pipeline.py registers it
# under the same name). Bounded FIFO.
_TIMED_MAX = 128
_timed_lock = threading.Lock()
_timed: Dict[str, TimedBackend] = {}
_timed_stats = {"hits": 0, "misses": 0}


def timed_backend(inner: Backend) -> TimedBackend:
    """The cached TimedBackend around ``inner``. A backend registered anew
    under a cached name is a miss, and its wrapper replaces the old one."""
    with _timed_lock:
        hit = _timed.get(inner.name)
        if hit is not None and hit.inner is inner:
            _timed_stats["hits"] += 1
            return hit
        _timed_stats["misses"] += 1
        _timed.pop(inner.name, None)
        while len(_timed) >= _TIMED_MAX:
            _timed.pop(next(iter(_timed)))
        _timed[inner.name] = out = TimedBackend(inner)
        return out


def timed_stage_cache_info() -> dict:
    with _timed_lock:
        return {
            "hits": _timed_stats["hits"],
            "misses": _timed_stats["misses"],
            "currsize": len(_timed),
            "maxsize": _TIMED_MAX,
        }


def timed_stage_cache_clear() -> None:
    with _timed_lock:
        _timed.clear()
        _timed_stats["hits"] = 0
        _timed_stats["misses"] = 0


_BACKENDS: Dict[str, Backend] = {}


def register_backend(name: str, backend: Backend) -> None:
    _BACKENDS[name] = backend


def get_backend(name: str) -> Backend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(_BACKENDS)}"
        ) from None


register_backend("reference", ReferenceBackend())
register_backend("cuda", CudaBackend())
