"""Layout glue around the GS-TG kernels (mirror of ``repro.kernels.ops``):
bin origins, member tiles inside the image, kernel-output -> image
assembly, and the GSM entry point ``sort_groups_bitonic``."""
from __future__ import annotations

import torch


def group_origins(grid, device=None) -> torch.Tensor:
    """(num_groups, 2) float32 pixel origin of each group."""
    g = torch.arange(grid.num_groups, dtype=torch.int32, device=device)
    return torch.stack(
        [(g % grid.n_groups_x) * grid.group, (g // grid.n_groups_x) * grid.group],
        dim=-1,
    ).to(torch.float32)


def tile_origins(grid, device=None) -> torch.Tensor:
    """(num_tiles, 2) float32 pixel origin of each tile."""
    t = torch.arange(grid.num_tiles, dtype=torch.int32, device=device)
    return torch.stack(
        [(t % grid.n_tiles_x) * grid.tile, (t // grid.n_tiles_x) * grid.tile],
        dim=-1,
    ).to(torch.float32)


def member_tiles(grid, device=None):
    """(num_groups, tpg) global tile ids of each group's member tiles and
    whether each lies inside the image."""
    gf = grid.gf
    g = torch.arange(grid.num_groups, dtype=torch.int32, device=device)[:, None]
    s = torch.arange(grid.tiles_per_group, dtype=torch.int32, device=device)[None, :]
    tx = (g % grid.n_groups_x) * gf + s % gf
    ty = (g // grid.n_groups_x) * gf + s // gf
    in_image = (tx < grid.n_tiles_x) & (ty < grid.n_tiles_y)
    return ty * grid.n_tiles_x + tx, in_image


def tiles_in_image(grid, device=None) -> torch.Tensor:
    """(num_groups, tpg) bool: member tile lies inside the image."""
    return member_tiles(grid, device)[1]


def sort_groups_bitonic(depth_keys: torch.Tensor, payload_idx: torch.Tensor):
    """GSM path: per-group depth sort through the bitonic kernel.

    depth_keys: (G, K) float32 with +inf at invalid slots; payload_idx:
    (G, K) int32. Returns (keys, idx) sorted ascending by key. The indices
    travel as float32, exact below 2**24. As in the JAX package, the
    render path bins with the stable sort instead; this is the ASIC's sort
    unit, run on its own."""
    from repro_torch.kernels.bitonic_sort import bitonic_sort_kernel

    if payload_idx.dtype != torch.int32:
        raise ValueError(f"payload_idx must be int32, got {payload_idx.dtype}")
    k, v = bitonic_sort_kernel(depth_keys, payload_idx.to(torch.float32))
    return k, v.to(torch.int32)


def _background(background, out) -> torch.Tensor:
    if background is None:
        return torch.zeros((3,), dtype=torch.float32, device=out.device)
    return torch.as_tensor(background, dtype=torch.float32, device=out.device)


def assemble_image(out, grid, background=None) -> torch.Tensor:
    """(G, tpg, 4, P) fused-kernel output -> (H, W, 3) image."""
    bg = _background(background, out)
    gf = grid.gf
    T = grid.tile
    rgb = out[:, :, :3, :] + out[:, :, 3:4, :] * bg[None, None, :, None]
    # (gy, gx, ty, tx, c, py, px)
    rgb = rgb.reshape(grid.n_groups_y, grid.n_groups_x, gf, gf, 3, T, T)
    rgb = rgb.permute(0, 2, 5, 1, 3, 6, 4)
    img = rgb.reshape(grid.n_groups_y * gf * T, grid.n_groups_x * gf * T, 3)
    return img[: grid.height, : grid.width]


def assemble_image_tiles(out, grid, background=None) -> torch.Tensor:
    """(num_tiles, 4, P) tile-kernel output -> (H, W, 3) image."""
    bg = _background(background, out)
    T = grid.tile
    rgb = out[:, :3, :] + out[:, 3:4, :] * bg[None, :, None]
    rgb = rgb.reshape(grid.n_tiles_y, grid.n_tiles_x, 3, T, T)
    rgb = rgb.permute(0, 3, 1, 4, 2)
    img = rgb.reshape(grid.n_tiles_y * T, grid.n_tiles_x * T, 3)
    return img[: grid.height, : grid.width]
