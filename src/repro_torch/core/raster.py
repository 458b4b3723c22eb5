"""Tile-wise rasterization (mirror of ``repro.core.raster``, paper Fig 1
right: alpha computation + blending).

Plain PyTorch reference over a tile-level BinTable. Alpha rule:
    q     = (p - mu)^T Conic (p - mu)
    alpha = min(opacity * exp(-q/2), ALPHA_MAX)
    alpha = 0  if q > 9 (3-sigma)  or  alpha < 1/255
Blending is front to back in chunks of ``chunk`` entries with an exclusive
cumprod per chunk (the JAX package's ``lax.scan`` order), gating each entry
on its own transmittance T_before > T_EPS.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.grouping import BinTable, GridSpec
from repro_torch.core.projection import QMAX_3SIGMA, Projected, proj_take

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


@dataclasses.dataclass
class RasterOut:
    image: torch.Tensor        # (H, W, 3)
    alpha_ops: torch.Tensor    # () int64: per-pixel alpha computations executed
    blend_ops: torch.Tensor    # () int64: blends that actually contributed
    processed: torch.Tensor    # (num_tiles,): entries processed per tile


def tile_pixel_coords(grid: GridSpec, device=None) -> torch.Tensor:
    """(num_tiles, T*T, 2) pixel-center coordinates per tile."""
    T = grid.tile
    tix = torch.arange(grid.num_tiles, dtype=torch.int32, device=device)
    tx = (tix % grid.n_tiles_x) * T
    ty = (tix // grid.n_tiles_x) * T
    px = torch.arange(T, dtype=torch.float32, device=device) + 0.5
    yy, xx = torch.meshgrid(px, px, indexing="ij")
    offs = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)  # (T*T, 2)
    base = torch.stack([tx, ty], dim=-1).to(torch.float32)
    return base[:, None, :] + offs[None, :, :]


def settle_cpu_exp() -> None:
    """Make MKL's vector math library, behind torch's CPU exp, choose its
    kernels on this thread. It makes that choice on its first call in a
    process; when that first call is a parallel one, threads that start
    before the choice is made compute their blocks with another, less
    accurate kernel, enough to move a plain rasterizer's pixels by up to
    about 5e-5. Each module whose plain version makes a parallel exp calls
    this when it is imported."""
    torch.exp(torch.ones(1))


settle_cpu_exp()


def alpha_at(pix, mean2d, conic, opacity):
    """Alpha with the q<=9 and 1/255 cutoffs. Shapes broadcast; returns (...)."""
    d = pix - mean2d
    q = (
        conic[..., 0] * d[..., 0] * d[..., 0]
        + 2.0 * conic[..., 1] * d[..., 0] * d[..., 1]
        + conic[..., 2] * d[..., 1] * d[..., 1]
    )
    a = opacity * torch.exp(-0.5 * q)
    a = torch.clamp(a, max=ALPHA_MAX)
    return torch.where((q > QMAX_3SIGMA) | (a < ALPHA_MIN), 0.0, a)


def rasterize(
    proj: Projected,
    table: BinTable,
    grid: GridSpec,
    background: Optional[torch.Tensor] = None,
    chunk: int = 32,
    early_exit: bool = True,
) -> RasterOut:
    """Rasterize all tiles at once (tiles are the batch axis)."""
    dev = table.gauss_idx.device
    if background is None:
        background = torch.zeros((3,), dtype=torch.float32, device=dev)
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    num_tiles, K = table.gauss_idx.shape
    assert num_tiles == grid.num_tiles
    T = grid.tile
    P = T * T
    pix = tile_pixel_coords(grid, dev)  # (num_tiles, P, 2)

    idx = table.gauss_idx
    mean2d = proj_take(proj, "mean2d", idx)   # (num_tiles, K, 2)
    conic = proj_take(proj, "conic", idx)
    rgb = proj_take(proj, "rgb", idx)
    opac = torch.where(table.entry_valid, proj_take(proj, "alpha", idx), 0.0)

    t_run = torch.ones((num_tiles, P), dtype=torch.float32, device=dev)
    c_run = torch.zeros((num_tiles, P, 3), dtype=torch.float32, device=dev)
    a_ops = torch.zeros((num_tiles,), dtype=torch.int64, device=dev)
    b_ops = torch.zeros((num_tiles,), dtype=torch.int64, device=dev)
    for c0 in range(0, K, chunk):
        sl = slice(c0, c0 + chunk)
        m, cn, cl, op = mean2d[:, sl], conic[:, sl], rgb[:, sl], opac[:, sl]
        n = op.shape[1]
        if n < chunk:  # zero-padded tail chunk, as the JAX scan pads K
            pad = chunk - n
            m = torch.nn.functional.pad(m, (0, 0, 0, pad))
            cn = torch.nn.functional.pad(cn, (0, 0, 0, pad))
            cl = torch.nn.functional.pad(cl, (0, 0, 0, pad))
            op = torch.nn.functional.pad(op, (0, pad))
        alpha = alpha_at(
            pix[:, :, None, :], m[:, None, :, :], cn[:, None, :, :], op[:, None, :]
        )  # (num_tiles, P, chunk)
        cp = torch.cumprod(1.0 - alpha, dim=2)
        excl = torch.cat([torch.ones_like(cp[:, :, :1]), cp[:, :, :-1]], dim=2)
        t_before = excl * t_run[:, :, None]
        w = alpha * t_before
        if early_exit:
            live = t_before > T_EPS
            w = torch.where(live, w, 0.0)
        else:
            live = torch.ones_like(w, dtype=torch.bool)
        c_run = c_run + w @ cl
        t_run = t_run * cp[:, :, -1]
        a_ops += torch.sum(live & (op > 0)[:, None, :], dim=(1, 2))
        b_ops += torch.sum(w > 0, dim=(1, 2))

    colors = c_run + t_run[:, :, None] * background[None, None, :]
    img = colors.reshape(grid.n_tiles_y, grid.n_tiles_x, T, T, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid.n_tiles_y * T, grid.n_tiles_x * T, 3)
    img = img[: grid.height, : grid.width]

    return RasterOut(
        image=img,
        alpha_ops=torch.sum(a_ops),
        blend_ops=torch.sum(b_ops),
        processed=torch.sum(table.entry_valid.to(torch.int32), dim=1),
    )
