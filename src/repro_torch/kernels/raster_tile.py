"""Rasterization Module (RM, paper Fig 10): CUDA kernel wrappers and their
plain PyTorch versions.

Two entry points, replacing the Pallas TPU kernels of
``repro.kernels.raster_tile``:

  * ``raster_tile_kernel`` — per-tile rasterization over compacted,
    depth-sorted entry lists (tile_baseline; group_baseline with groups as
    large tiles).
  * ``raster_group_fused_kernel`` — the fused GS-TG RM: consumes the group
    entry lists plus per-entry tile bitmasks, keeps an entry for a member
    tile only if its mask bit and valid flag are set, and clamps each member
    tile's virtual FIFO at ``tile_capacity``; no per-tile table is built.

Both return the (…, 4, T²) rgb + final transmittance block and per-tile
int32 (alpha_ops, blend_ops) counters. The CUDA source is
``csrc/raster_tile.cu``; both kernels blend sequentially per pixel through
one shared step. The fused kernel runs one block per group: it stages each
window of the group's entries once for all member tiles, and each tile's
warps walk only the entries their tile streams, so it gives the tile
kernel's rgb and counters bit for bit over the compacted lists. The plain
versions follow the Pallas kernel's per-chunk exclusive cumprod instead, so
the two agree to float32 reassociation (images) and to rare flips of the
T_before > 1e-4 gate (counters). On a CUDA tensor a wrapper launches its
kernel; on a CPU tensor it runs the plain version; it never falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.layout import (
    F_CONIC_A,
    F_CONIC_B,
    F_CONIC_C,
    F_MEAN_X,
    F_MEAN_Y,
    F_OPACITY,
    F_RGB_B,
    F_RGB_R,
    F_VALID,
    NUM_FEATURES,
)

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
QMAX = 9.0

_P, _I = build.P, build.I
_SIGNATURES = {
    # feat, masks, origin, out, counts, G, K, tile_px, gf, chunk,
    # tile_capacity, early_exit, stream
    "raster_group_fused_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # feat, origin, out, counts, N, K, tile_px, chunk, early_exit, stream
    "raster_tile_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _pixel_offsets(tile_px: int, device):
    """In-tile pixel-center offsets as two (P,) tensors."""
    lin = torch.arange(tile_px * tile_px, dtype=torch.float32, device=device)
    return torch.fmod(lin, tile_px) + 0.5, torch.floor(lin / tile_px) + 0.5


def _raster_plain(feat, pix_x, pix_y, *, chunk, early_exit, masks=None,
                  tile_capacity=None):
    """Chunked front-to-back blend of B entry lists into S pixel blocks each.

    feat (B, F, K); pix_x/pix_y (B, S, P); masks (B, K) int32 — block s of
    list b keeps entry k only if bit s of masks[b, k] and its valid flag are
    set. Returns out (B, S, 4, P) and counts (B, S, 2) int32.
    """
    B, _, K = feat.shape
    S, P = pix_x.shape[1:]
    dev = feat.device
    t_run = torch.ones((B, S, P), dtype=torch.float32, device=dev)
    rgb = torch.zeros((B, S, P, 3), dtype=torch.float32, device=dev)
    a_ops = torch.zeros((B, S), dtype=torch.int64, device=dev)
    b_ops = torch.zeros((B, S), dtype=torch.int64, device=dev)
    kept = torch.zeros((B, S), dtype=torch.int64, device=dev)
    slot_bits = torch.arange(S, dtype=torch.int32, device=dev)[None, :, None]
    px, py = pix_x[..., None], pix_y[..., None]  # (B, S, P, 1)

    for c0 in range(0, K, chunk):
        fc = feat[:, :, c0:c0 + chunk]                        # (B, F, C)
        row = lambda r: fc[:, r][:, None, None, :]             # (B, 1, 1, C)
        dx = px - row(F_MEAN_X)                                # (B, S, P, C)
        dy = py - row(F_MEAN_Y)
        q = (row(F_CONIC_A) * dx * dx + 2.0 * row(F_CONIC_B) * dx * dy
             + row(F_CONIC_C) * dy * dy)
        op = row(F_OPACITY)
        a = torch.clamp(op * torch.exp(-0.5 * q), max=ALPHA_MAX)
        a = torch.where((q > QMAX) | (a < ALPHA_MIN), 0.0, a)

        valid_entry = (fc[:, F_OPACITY] > 0.0)[:, None, :]    # (B, 1, C)
        new_kept = kept
        if masks is not None:
            keep = ((masks[:, None, c0:c0 + chunk] >> slot_bits) & 1) > 0  # (B, S, C)
            stream = keep & (fc[:, F_VALID] > 0.5)[:, None, :]
            if tile_capacity is not None:
                # Virtual FIFO clamp: each streamed entry's position in its
                # tile's compaction list; past the capacity it is dropped.
                pos = kept[..., None] + torch.cumsum(stream.to(torch.int64), dim=-1) - 1
                new_kept = kept + torch.sum(stream, dim=-1)
                stream = stream & (pos < tile_capacity)
            valid_entry = valid_entry & stream
            a = torch.where(stream[:, :, None, :], a, 0.0)

        cp = torch.cumprod(1.0 - a, dim=-1)
        excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
        t_before = t_run[..., None] * excl
        if early_exit:
            live = t_before > T_EPS
            w = torch.where(live, a * t_before, 0.0)
        else:
            live = torch.ones_like(t_before, dtype=torch.bool)
            w = a * t_before
        colors = fc[:, F_RGB_R:F_RGB_B + 1].transpose(1, 2)[:, None]  # (B, 1, C, 3)
        new = (
            t_run * cp[..., -1],
            rgb + w @ colors,
            a_ops + torch.sum(live & valid_entry[:, :, None, :], dim=(-1, -2)),
            b_ops + torch.sum(w > 0.0, dim=(-1, -2)),
            new_kept,
        )
        if early_exit:
            # Block-granular early exit: a tile whose pixels are all dead
            # skips the chunk (its carry stays as it was).
            alive = torch.any(t_run > T_EPS, dim=-1)  # (B, S)
            old = (t_run, rgb, a_ops, b_ops, kept)
            new = tuple(
                torch.where(alive.reshape(B, S, *([1] * (n.ndim - 2))), n, o)
                for n, o in zip(new, old)
            )
        t_run, rgb, a_ops, b_ops, kept = new

    out = torch.cat([rgb.transpose(-1, -2), t_run[:, :, None, :]], dim=2)
    counts = torch.stack([a_ops, b_ops], dim=-1).to(torch.int32)
    return out, counts


def raster_tile_plain(feat, tile_origin, tile_px: int, chunk: int = 128,
                      early_exit: bool = True):
    """Plain PyTorch tile RM: (num_tiles, 4, P) out, (num_tiles, 2) counts."""
    _check_chunk(feat, chunk)
    dx, dy = _pixel_offsets(tile_px, feat.device)
    pix_x = (tile_origin[:, 0, None] + dx[None, :])[:, None, :]
    pix_y = (tile_origin[:, 1, None] + dy[None, :])[:, None, :]
    out, counts = _raster_plain(feat, pix_x, pix_y, chunk=chunk, early_exit=early_exit)
    return out[:, 0], counts[:, 0]


def raster_group_fused_plain(feat, masks, group_origin, tile_px: int, gf: int,
                             chunk: int = 128, early_exit: bool = True,
                             tile_capacity: Optional[int] = None):
    """Plain PyTorch fused GS-TG RM: (G, gf², 4, P) out, (G, gf², 2) counts."""
    _check_chunk(feat, chunk)
    dev = feat.device
    slots = torch.arange(gf * gf, dtype=torch.int32, device=dev)
    ox = group_origin[:, 0, None] + (slots % gf).to(torch.float32)[None, :] * tile_px
    oy = group_origin[:, 1, None] + (slots // gf).to(torch.float32)[None, :] * tile_px
    dx, dy = _pixel_offsets(tile_px, dev)
    return _raster_plain(
        feat, ox[..., None] + dx, oy[..., None] + dy, chunk=chunk,
        early_exit=early_exit, masks=masks, tile_capacity=tile_capacity,
    )


def raster_tile_kernel(
    feat: torch.Tensor,          # (num_tiles, F, K)
    tile_origin: torch.Tensor,   # (num_tiles, 2) float32 pixel origin
    tile_px: int,
    chunk: int = 128,
    early_exit: bool = True,
):
    """Tile RM: (num_tiles, 4, tile_px²) rgb + final transmittance, and
    (num_tiles, 2) int32 (alpha_ops, blend_ops). CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if feat.device.type == "cpu":
        return raster_tile_plain(feat, tile_origin, tile_px, chunk, early_exit)
    N, K = _check_cuda(feat, chunk, "raster_tile")
    origin = _origins(tile_origin, feat, N)
    P = tile_px * tile_px
    out = torch.empty((N, 4, P), dtype=torch.float32, device=feat.device)
    counts = torch.empty((N, 2), dtype=torch.int32, device=feat.device)
    if N == 0:
        return out, counts
    lib = build.load("raster_tile", _SIGNATURES)
    status = lib.raster_tile_launch(
        feat.data_ptr(), origin.data_ptr(), out.data_ptr(), counts.data_ptr(),
        N, K, tile_px, chunk, int(early_exit), build.stream_of(feat),
    )
    build.check_status(lib, status, "raster_tile")
    build.count_launch("raster_tile")
    return out, counts


def raster_group_fused_kernel(
    feat: torch.Tensor,          # (num_groups, F, K) group-sorted entries
    masks: torch.Tensor,         # (num_groups, K) int32 tile bitmasks
    group_origin: torch.Tensor,  # (num_groups, 2) float32
    tile_px: int,
    gf: int,                     # tiles per group side
    chunk: int = 128,
    early_exit: bool = True,
    tile_capacity: Optional[int] = None,
):
    """Fused GS-TG RM: (num_groups, gf², 4, tile_px²) and (num_groups, gf²,
    2) int32 (alpha_ops, blend_ops). CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if feat.device.type == "cpu":
        return raster_group_fused_plain(
            feat, masks, group_origin, tile_px, gf, chunk, early_exit, tile_capacity
        )
    G, K = _check_cuda(feat, chunk, "raster_group_fused")
    if masks.shape != (G, K) or masks.dtype != torch.int32 or masks.device != feat.device:
        raise ValueError("raster_group_fused: masks must be (G, K) int32 beside feat")
    if gf * gf > 32:
        raise ValueError(f"raster_group_fused: {gf * gf} member tiles exceed a 32-bit mask")
    origin = _origins(group_origin, feat, G)
    masks = masks.contiguous()
    P, tpg = tile_px * tile_px, gf * gf
    out = torch.empty((G, tpg, 4, P), dtype=torch.float32, device=feat.device)
    counts = torch.empty((G, tpg, 2), dtype=torch.int32, device=feat.device)
    if G == 0:
        return out, counts
    lib = build.load("raster_tile", _SIGNATURES)
    cap = -1 if tile_capacity is None else int(tile_capacity)
    status = lib.raster_group_fused_launch(
        feat.data_ptr(), masks.data_ptr(), origin.data_ptr(), out.data_ptr(),
        counts.data_ptr(), G, K, tile_px, gf, chunk, cap, int(early_exit),
        build.stream_of(feat),
    )
    build.check_status(lib, status, "raster_group_fused")
    build.count_launch("raster_group_fused")
    return out, counts


def _check_chunk(feat, chunk):
    if chunk <= 0 or feat.shape[-1] % chunk:
        raise ValueError(f"K={feat.shape[-1]} is not a multiple of chunk={chunk}")


def _check_cuda(feat, chunk, what):
    if feat.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {feat.device}")
    B, F, K = feat.shape
    if F != NUM_FEATURES or feat.dtype != torch.float32 or not feat.is_contiguous():
        raise ValueError(f"{what}: feat must be contiguous (B, 16, K) float32")
    _check_chunk(feat, chunk)
    return B, K


def _origins(origin, feat, n):
    origin = origin.to(device=feat.device, dtype=torch.float32).contiguous()
    if origin.shape != (n, 2):
        raise ValueError(f"origins must be ({n}, 2), got {tuple(origin.shape)}")
    return origin
