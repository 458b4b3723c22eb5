"""Bitmask generation + the RM's FIFO compaction (mirror of
``repro.core.bitmask``, paper §IV-B, §V-B).

For every entry of a group's depth-sorted table, a gf^2-bit mask marks which
member tiles the Gaussian covers. Rasterization then consumes, per tile, the
subsequence of the group list whose bit is set — extracted here by a linear
cumsum/scatter compaction (O(K) per group, no comparison sort).

Masks are held as int32 bit patterns (torch's uint32 supports few ops);
bit t of an entry's word is member tile t.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.boundary import boundary_test
from repro_torch.core.grouping import BinTable, GridSpec, LiftedFields, tile_rect_in_group
from repro_torch.core.projection import Projected, proj_take
from repro_torch.kernels.ops import member_tiles


@dataclasses.dataclass
class GroupBitmasks:
    masks: torch.Tensor        # (num_groups, K) int32 — bit t == covers member tile t
    n_bit_tests: torch.Tensor  # () int64 — tile-granularity boundary tests run


def tile_bits(masks: torch.Tensor, tpg: int) -> torch.Tensor:
    """(..., K) int32 masks -> (..., K, tpg) bool member-tile bits."""
    shifts = torch.arange(tpg, dtype=torch.int32, device=masks.device)
    return ((masks[..., None] >> shifts) & 1).to(torch.bool)


def pack_bits(hit: torch.Tensor) -> torch.Tensor:
    """(..., tpg) bool -> (...) int32 word with bit t = hit[..., t]."""
    tpg = hit.shape[-1]
    weights = torch.ones((), dtype=torch.int32, device=hit.device) << torch.arange(
        tpg, dtype=torch.int32, device=hit.device
    )
    return torch.sum(hit.to(torch.int32) * weights, dim=-1, dtype=torch.int32)


def generate_bitmasks(
    proj: Projected,
    table: BinTable,
    grid: GridSpec,
    method: str,
) -> GroupBitmasks:
    """BGM: per (group-entry, member-tile) boundary test, packed to bits."""
    num_groups, K = table.gauss_idx.shape
    tpg = grid.tiles_per_group
    dev = table.gauss_idx.device
    group_ids = torch.arange(num_groups, dtype=torch.int32, device=dev)
    slots = torch.arange(tpg, dtype=torch.int32, device=dev)
    # rects: each component (G, 1, tpg) broadcast against (G, K, 1) features.
    rect = tile_rect_in_group(grid, group_ids[:, None, None], slots[None, None, :])

    gathered = LiftedFields(lambda name: proj_take(proj, name, table.gauss_idx), 1)
    hit = boundary_test(method, gathered, rect)  # (G, K, tpg)

    # Tiles that fall outside the image (partial edge groups) are masked off.
    _, tile_in_image = member_tiles(grid, dev)
    hit = hit & tile_in_image[:, None, :] & table.entry_valid[:, :, None]
    n_tests = torch.sum(table.entry_valid.to(torch.int64)) * tpg
    return GroupBitmasks(masks=pack_bits(hit), n_bit_tests=n_tests)


def compact_tiles(
    table: BinTable,
    bitmasks: GroupBitmasks,
    grid: GridSpec,
    tile_capacity: int,
) -> BinTable:
    """RM FIFO stage: per member tile, compact the group-sorted entries whose
    bitmask bit is set, preserving order (hence still depth-sorted).

    Returns a tile-level BinTable of shape (num_tiles, tile_capacity) indexed
    by *global* tile id.
    """
    num_groups, K = table.gauss_idx.shape
    tpg = grid.tiles_per_group
    dev = table.gauss_idx.device

    bits = tile_bits(bitmasks.masks, tpg) & table.entry_valid[:, :, None]  # (G, K, tpg)

    # Stable compaction per (group, tile): position = exclusive cumsum of bits.
    pos = torch.cumsum(bits.to(torch.int32), dim=1) - 1
    lengths = torch.sum(bits.to(torch.int32), dim=1, dtype=torch.int32)  # (G, tpg)

    # Entries not kept, or past the capacity, go to the trash slot.
    out_idx = torch.clamp(
        torch.where(bits, pos, tile_capacity), max=tile_capacity
    ).to(torch.int64)
    src = table.gauss_idx[:, :, None].expand(num_groups, K, tpg)
    compact = torch.zeros((num_groups, tpg, tile_capacity + 1), dtype=torch.int32, device=dev)
    compact.scatter_(2, out_idx.transpose(1, 2), src.transpose(1, 2).contiguous())
    compact = compact[:, :, :tile_capacity]

    k = torch.arange(tile_capacity, dtype=torch.int32, device=dev)
    entry_valid = k[None, None, :] < torch.clamp(lengths, max=tile_capacity)[:, :, None]

    # Re-index (group, slot) -> global tile id; out-of-image tiles go to the
    # trash row num_tiles.
    gtile, in_image = member_tiles(grid, dev)
    num_tiles = grid.num_tiles
    flat_tile = torch.where(in_image, gtile, num_tiles).reshape(-1).to(torch.int64)
    flat_idx = compact.reshape(num_groups * tpg, tile_capacity)
    flat_valid = (entry_valid & in_image[:, :, None]).reshape(num_groups * tpg, tile_capacity)
    flat_len = torch.where(in_image, lengths, 0).reshape(-1)

    tile_gauss = torch.zeros((num_tiles + 1, tile_capacity), dtype=torch.int32, device=dev)
    tile_valid = torch.zeros((num_tiles + 1, tile_capacity), dtype=torch.bool, device=dev)
    tile_len = torch.zeros((num_tiles + 1,), dtype=torch.int32, device=dev)
    tile_gauss[flat_tile] = flat_idx
    tile_valid[flat_tile] = flat_valid
    tile_len[flat_tile] = flat_len.to(torch.int32)

    overflow = torch.sum(torch.clamp(flat_len.to(torch.int64) - tile_capacity, min=0))
    return BinTable(
        gauss_idx=tile_gauss[:num_tiles],
        entry_valid=tile_valid[:num_tiles],
        lengths=tile_len[:num_tiles],
        overflow=overflow,
    )
