"""Dense PyTorch oracles for the kernels (mirror of ``repro.kernels.ref``).

Each oracle recomputes a kernel's output with straightforward dense torch
ops: no chunking, no early-exit skipping (per-entry T_before gating only),
no window of entries. They are independent of the kernels' plain versions
(``bitmask_plain``, ``raster_*_plain``, ``bitonic_sort_plain``), which
follow each kernel's algorithm and are its first oracle: a kernel and its
oracle agreeing validates the math and the chunked control flow both.

A dense oracle holds (pixels x entries) at once, so keep its inputs small.
Masks are int32 tensors holding the uint32 bit patterns, as the kernels'
are; the shifts run in int64.
"""
from __future__ import annotations

import torch

from repro_torch.core import boundary
from repro_torch.kernels.layout import (
    F_CONIC_A,
    F_CONIC_B,
    F_CONIC_C,
    F_EIGVAL_1,
    F_EIGVAL_2,
    F_EIGVEC_X,
    F_EIGVEC_Y,
    F_MEAN_X,
    F_MEAN_Y,
    F_OPACITY,
    F_RADIUS,
    F_RGB_B,
    F_RGB_G,
    F_RGB_R,
    F_VALID,
)

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
QMAX = 9.0
SIGMA_CUT = 3.0


def _pixels(ox, oy, tile_px: int):
    """Pixel centres of tiles at origins ``ox``, ``oy`` (any shape (...,)):
    two (..., P) tensors."""
    lin = torch.arange(tile_px * tile_px, dtype=torch.float32, device=ox.device)
    px = ox[..., None] + torch.remainder(lin, tile_px) + 0.5
    py = oy[..., None] + torch.floor(lin / tile_px) + 0.5
    return px, py


def _alphas(feat, px, py):
    """feat (B, F, K), px/py (B, S, P) -> alphas (B, S, P, K)."""
    row = lambda r: feat[:, r][:, None, None, :]  # noqa: E731  (B, 1, 1, K)
    dx = px[..., None] - row(F_MEAN_X)
    dy = py[..., None] - row(F_MEAN_Y)
    q = (
        row(F_CONIC_A) * dx * dx
        + 2.0 * row(F_CONIC_B) * dx * dy
        + row(F_CONIC_C) * dy * dy
    )
    a = torch.clamp(row(F_OPACITY) * torch.exp(-0.5 * q), max=ALPHA_MAX)
    return torch.where((q > QMAX) | (a < ALPHA_MIN), 0.0, a)


def _blend(a, feat):
    """(B, S, P, K) alphas -> (B, S, 4, P) rgb + T, each entry gated on its
    own T_before."""
    cp = torch.cumprod(1.0 - a, dim=-1)
    t_before = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    w = torch.where(t_before > T_EPS, a * t_before, 0.0)
    colors = feat[:, [F_RGB_R, F_RGB_G, F_RGB_B]][:, None]        # (B, 1, 3, K)
    rgb = colors @ w.transpose(-1, -2)                             # (B, S, 3, P)
    return torch.cat([rgb, cp[..., -1][:, :, None, :]], dim=2)


def ref_raster_tiles(feat, tile_origin, tile_px: int):
    """Oracle for the tile RM (``raster_tile_kernel``): (num_tiles, 4, P)."""
    px, py = _pixels(tile_origin[:, 0:1], tile_origin[:, 1:2], tile_px)   # (N, 1, P)
    return _blend(_alphas(feat, px, py), feat)[:, 0]


def ref_raster_group_fused(feat, masks, group_origin, tile_px: int, gf: int):
    """Oracle for the fused GS-TG RM (``raster_group_fused_kernel``):
    (num_groups, gf^2, 4, P). Member tile ``slot`` blends the entries whose
    mask has bit ``slot`` set."""
    slots = torch.arange(gf * gf, device=feat.device)
    ox = group_origin[:, 0, None] + (slots % gf) * tile_px          # (G, tpg)
    oy = group_origin[:, 1, None] + (slots // gf) * tile_px
    px, py = _pixels(ox.to(torch.float32), oy.to(torch.float32), tile_px)
    a = _alphas(feat, px, py)                                        # (G, tpg, P, K)
    words = masks.to(torch.int64) & 0xFFFFFFFF
    keep = ((words[:, None, :] >> slots[None, :, None]) & 1) > 0     # (G, tpg, K)
    a = torch.where(keep[:, :, None, :], a, 0.0)
    return _blend(a, feat)


class _Entries:
    """The boundary tests' fields of a (G, F, K) block, broadcast as (G, K,
    1, ...) against (G, 1, tpg) tile rectangles."""

    def __init__(self, feat):
        def rows(*r):
            return torch.stack([feat[:, i] for i in r], dim=-1)[:, :, None, :]

        self.mean2d = rows(F_MEAN_X, F_MEAN_Y)
        self.radius = feat[:, F_RADIUS][:, :, None]
        self.conic = rows(F_CONIC_A, F_CONIC_B, F_CONIC_C)
        self.eigvec = rows(F_EIGVEC_X, F_EIGVEC_Y)
        self.eigval = rows(F_EIGVAL_1, F_EIGVAL_2)


def ref_bitmask(feat, group_origin, tile_in_image, tile_px: int, gf: int,
                method: str = "ellipse"):
    """Oracle for the BGM (``bitmask_kernel``) through the core boundary
    tests: (num_groups, K) int32 words, bit ``slot`` set where entry k is
    valid, member tile ``slot`` is in the image and the test hits it."""
    tpg = gf * gf
    slots = torch.arange(tpg, dtype=torch.float32, device=feat.device)
    x0 = group_origin[:, 0][:, None, None] + torch.remainder(slots, gf)[None, None, :] * tile_px
    y0 = group_origin[:, 1][:, None, None] + torch.floor(slots / gf)[None, None, :] * tile_px
    rect = (x0, y0, x0 + tile_px, y0 + tile_px)
    hit = boundary.boundary_test(method, _Entries(feat), rect)   # (G, K, tpg)
    valid = feat[:, F_VALID] > 0.5
    hit = hit & valid[:, :, None] & tile_in_image.to(torch.bool)[:, None, :]
    weights = torch.ones((), dtype=torch.int64, device=feat.device) << torch.arange(
        tpg, dtype=torch.int64, device=feat.device)
    words = torch.sum(hit.to(torch.int64) * weights, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def ref_sort(keys, payload):
    """Oracle for the GSM (``bitonic_sort_kernel``): ascending by key, ties
    in their order (stable; the network leaves ties unordered, so compare
    payloads as a multiset of (key, payload) pairs)."""
    order = torch.sort(keys, dim=-1, stable=True).indices
    return torch.gather(keys, -1, order), torch.gather(payload, -1, order)
