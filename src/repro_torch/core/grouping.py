"""Group/tile identification and static-shape binning (mirror of
``repro.core.grouping``, paper §IV-B).

Each visible Gaussian enumerates a bounded span x span window of candidate
bins, pre-filtered by its circumscribed-radius bbox; the boundary test keeps
the hits, the pairs are flattened and binned with a stable two-key sort
(depth, then bin id), and per-bin segments are cut into a fixed-capacity
table with ``searchsorted``. The same code runs at group granularity (GS-TG)
and at tile granularity (the per-tile baseline).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.boundary import boundary_test
from repro_torch.core.projection import Projected
from repro_torch.utils import cdiv, wide_count_sum


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static geometry of the tile/group decomposition."""

    width: int
    height: int
    tile: int           # small tile side in pixels (e.g. 16)
    group: int          # group side in pixels (e.g. 64); must be k*tile
    span: int = 4       # candidate window (in bins) per Gaussian at group level

    def __post_init__(self):
        if self.group % self.tile != 0:
            raise ValueError("group size must be a multiple of tile size")
        if self.width % self.tile or self.height % self.tile:
            raise ValueError("image dims must be multiples of the tile size")

    @property
    def gf(self) -> int:
        """Group factor: tiles per group side."""
        return self.group // self.tile

    @property
    def tiles_per_group(self) -> int:
        return self.gf * self.gf

    @property
    def n_tiles_x(self) -> int:
        return cdiv(self.width, self.tile)

    @property
    def n_tiles_y(self) -> int:
        return cdiv(self.height, self.tile)

    @property
    def n_groups_x(self) -> int:
        return cdiv(self.width, self.group)

    @property
    def n_groups_y(self) -> int:
        return cdiv(self.height, self.group)

    @property
    def num_tiles(self) -> int:
        return self.n_tiles_x * self.n_tiles_y

    @property
    def num_groups(self) -> int:
        return self.n_groups_x * self.n_groups_y

    def bins(self, level: str) -> Tuple[int, int, int]:
        """(n_bins_x, n_bins_y, bin_px) for 'group' or 'tile' level."""
        if level == "group":
            return self.n_groups_x, self.n_groups_y, self.group
        if level == "tile":
            return self.n_tiles_x, self.n_tiles_y, self.tile
        raise ValueError(level)

    def span_for(self, level: str) -> int:
        if level == "group":
            return self.span
        return self.span * self.gf


@dataclasses.dataclass
class PairSet:
    """Flattened (gaussian, bin) candidate pairs. All (P,) tensors."""

    bin_id: torch.Tensor     # int32, == num_bins for invalid pairs (sorts last)
    gauss_idx: torch.Tensor  # int32
    depth: torch.Tensor      # float32, +inf for invalid
    valid: torch.Tensor      # bool
    # -- counters (int64 scalars) --
    n_candidate_tests: torch.Tensor  # boundary tests run
    n_pairs: torch.Tensor            # valid (gaussian, bin) pairs == sort keys
    n_span_overflow: torch.Tensor    # bins lost to the static span window


@dataclasses.dataclass
class BinTable:
    """Fixed-capacity per-bin entry table (depth-sorted within each bin)."""

    gauss_idx: torch.Tensor    # (B, K) int32 — index into the Projected arrays
    entry_valid: torch.Tensor  # (B, K) bool
    lengths: torch.Tensor      # (B,) int32 true segment length (pre-clamp)
    overflow: torch.Tensor     # () int64 total entries dropped by capacity K

    @property
    def capacity(self) -> int:
        return self.gauss_idx.shape[1]

    @property
    def num_bins(self) -> int:
        return self.gauss_idx.shape[0]


def identify(
    proj: Projected,
    grid: GridSpec,
    level: str,
    method: str,
) -> PairSet:
    """Enumerate candidate (gaussian, bin) pairs and run the boundary test:
    the paper's 'tile identification' (level='tile') or 'group
    identification' (level='group')."""
    n_bins_x, n_bins_y, bin_px = grid.bins(level)
    span = grid.span_for(level)
    num_bins = n_bins_x * n_bins_y
    dev = proj.mean2d.device

    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    r = proj.radius

    def bin_of(v, n):
        return torch.clamp(torch.floor(v / bin_px).to(torch.int32), 0, n - 1)

    # Circumscribed-radius pre-filter bbox (in bin coords), clipped to grid.
    bx0, bx1 = bin_of(mx - r, n_bins_x), bin_of(mx + r, n_bins_x)
    by0, by1 = bin_of(my - r, n_bins_y), bin_of(my + r, n_bins_y)

    d = torch.arange(span, dtype=torch.int32, device=dev)
    cand_x = bx0[:, None] + d[None, :]           # (N, span)
    cand_y = by0[:, None] + d[None, :]
    in_bbox_x = cand_x <= bx1[:, None]
    in_bbox_y = cand_y <= by1[:, None]

    # (N, span_x, span_y): candidate x on axis 1, y on axis 2 (C order of
    # the flattening below matches the JAX package's).
    cx = cand_x[:, :, None]
    cy = cand_y[:, None, :]
    in_bbox = in_bbox_x[:, :, None] & in_bbox_y[:, None, :]
    in_bbox = in_bbox & proj.valid[:, None, None]

    rect = (
        (cx * bin_px).to(torch.float32),
        (cy * bin_px).to(torch.float32),
        ((cx + 1) * bin_px).to(torch.float32),
        ((cy + 1) * bin_px).to(torch.float32),
    )
    lifted = LiftedFields(lambda name: getattr(proj, name), 2)
    hit = in_bbox & boundary_test(method, lifted, rect)

    bin_id = torch.where(hit, cy * n_bins_x + cx, num_bins).to(torch.int32)
    N = proj.mean2d.shape[0]
    gauss_idx = torch.arange(N, dtype=torch.int32, device=dev)[:, None, None]
    gauss_idx = gauss_idx.expand(N, span, span)
    depth = torch.where(hit, proj.depth[:, None, None], float("inf"))

    # Span-window overflow: bbox bins beyond the static window.
    zero = torch.zeros_like(bx0)
    full_w = torch.where(proj.valid, bx1 - bx0 + 1, zero)
    full_h = torch.where(proj.valid, by1 - by0 + 1, zero)
    lost = full_w * full_h - torch.clamp(full_w, max=span) * torch.clamp(full_h, max=span)

    return PairSet(
        bin_id=bin_id.reshape(-1),
        gauss_idx=gauss_idx.reshape(-1),
        depth=depth.reshape(-1).to(torch.float32),
        valid=hit.reshape(-1),
        n_candidate_tests=wide_count_sum(in_bbox),
        n_pairs=wide_count_sum(hit),
        n_span_overflow=wide_count_sum(lost),
    )


_VECTOR_FIELDS = ("mean2d", "conic", "eigvec", "eigval")


class LiftedFields:
    """Boundary-test fields, each fetched by ``take(name)`` when read, with
    ``n_new`` broadcast axes inserted after the entry axes:
    (..., F) -> (..., 1, .., F). A gathered view gathers only what the test
    reads."""

    def __init__(self, take, n_new: int):
        self._take = take
        self._ones = (1,) * n_new

    def __getattr__(self, name):
        v = self._take(name)
        if name in _VECTOR_FIELDS:
            return v.reshape(*v.shape[:-1], *self._ones, v.shape[-1])
        return v.reshape(*v.shape, *self._ones)


def bin_pairs(pairs: PairSet, num_bins: int, capacity: int) -> BinTable:
    """Stable (bin, depth) sort + fixed-capacity segment extraction.

    Two stable sorts (depth, then bin id) give lexicographic (bin_id, depth,
    original index) order: the 3D-GS tie-break that makes the GS-TG per-tile
    subsequence bitwise identical to the per-tile baseline ordering.
    """
    _, order_d = torch.sort(pairs.depth.detach(), stable=True)
    bin_by_d = pairs.bin_id[order_d]
    _, order_b = torch.sort(bin_by_d, stable=True)
    order = order_d[order_b]

    sorted_bins = pairs.bin_id[order]
    sorted_gauss = pairs.gauss_idx[order]

    dev = sorted_bins.device
    bins = torch.arange(num_bins + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(sorted_bins, bins, side="left")
    starts, ends = bounds[:-1], bounds[1:]
    lengths = (ends - starts).to(torch.int32)

    k = torch.arange(capacity, dtype=torch.int64, device=dev)
    idx = starts[:, None] + k[None, :]
    entry_valid = k[None, :] < torch.clamp(lengths, max=capacity)[:, None]
    idx = torch.clamp(idx, 0, sorted_gauss.shape[0] - 1)
    gauss_idx = torch.where(
        entry_valid, sorted_gauss[idx], torch.zeros((), dtype=torch.int32, device=dev)
    )

    overflow = wide_count_sum(torch.clamp(lengths - capacity, min=0))
    return BinTable(
        gauss_idx=gauss_idx,
        entry_valid=entry_valid,
        lengths=lengths,
        overflow=overflow,
    )


def sort_op_count(lengths: torch.Tensor) -> torch.Tensor:
    """Comparator-op model: sum_b L_b * ceil(log2 max(L_b, 2)), int64.

    ceil(log2) is taken in float32, as the JAX package takes it, so the two
    agree term by term."""
    L = lengths.to(torch.float32)
    logL = torch.ceil(torch.log2(torch.clamp(L, min=2.0)))
    return torch.sum(lengths.to(torch.int64) * logL.to(torch.int64))


def tile_rect_in_group(grid: GridSpec, group_ids: torch.Tensor, tile_slot: torch.Tensor):
    """Pixel rect of member tile ``tile_slot`` (0..gf^2-1) of each group."""
    gf = grid.gf
    gx = (group_ids % grid.n_groups_x).to(torch.float32)
    gy = (group_ids // grid.n_groups_x).to(torch.float32)
    tx = (tile_slot % gf).to(torch.float32)
    ty = (tile_slot // gf).to(torch.float32)
    x0 = gx * grid.group + tx * grid.tile
    y0 = gy * grid.group + ty * grid.tile
    return (x0, y0, x0 + grid.tile, y0 + grid.tile)


def group_tile_to_global_tile(grid: GridSpec, group_id, tile_slot):
    """Map (group, member-slot) -> global tile id in the tile grid."""
    gf = grid.gf
    gx = group_id % grid.n_groups_x
    gy = group_id // grid.n_groups_x
    tx = gx * gf + tile_slot % gf
    ty = gy * gf + tile_slot // gf
    return ty * grid.n_tiles_x + tx
