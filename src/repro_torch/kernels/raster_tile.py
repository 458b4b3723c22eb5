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
one shared step. The tile kernel runs one block per tile (two warps at 4
pixels a thread for a 16x16 tile) and stages its list in windows of
``TILE_WINDOW`` entries with cp.async, the next window loading while this
one blends; it votes on early exit at chunk boundaries only (warp votes
combined over the tile's warps), so any chunk that divides K stops where
the plain version stops. On the main frame's compacted lists it takes
0.46-0.50 ms on an H100 80GB HBM3 at 700 W (PERF.md).
The fused kernel runs one block per group: it stages each window of the
group's entries once for all member tiles, and each tile's warps walk only
the entries their tile streams, so it gives the tile kernel's rgb and
counters bit for bit over the compacted lists. The plain versions follow
the Pallas kernel's per-chunk exclusive cumprod instead, so the two agree
to float32 reassociation (images) and to rare flips of the T_before > 1e-4
gate (counters). On a CUDA tensor a wrapper launches its kernel; on a CPU
tensor it runs the plain version; it never falls back.
"""
from __future__ import annotations

import ctypes
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
# Entries the tile kernel stages per window (TILE_WIN in csrc/raster_tile.cu).
TILE_WINDOW = 64

# Before raster_tile_plain's first parallel exp, as core/raster.py's
# settle_cpu_exp does for the plain rasterizer: MKL's exp chooses its kernels
# on its first call in a process, and a parallel first call can race it.
torch.exp(torch.ones(1))

_P, _I = build.P, build.I
_SIGNATURES = {
    # feat, masks, origin, out, counts, G, K, tile_px, gf, chunk,
    # tile_capacity, early_exit, stream
    "raster_group_fused_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # feat, origin, out, counts, N, K, tile_px, chunk, early_exit, stream
    "raster_tile_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # tile_px, shape (4,) int32 out
    "raster_tile_shape": [_I, _P],
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
    set. Returns out (B, S, 4, P), counts (B, S, 2) int32 and stop (B, S)
    int64: the chunk boundary at which block s stopped on early exit (K if
    it never did).
    """
    B, _, K = feat.shape
    S, P = pix_x.shape[1:]
    dev = feat.device
    t_run = torch.ones((B, S, P), dtype=torch.float32, device=dev)
    rgb = torch.zeros((B, S, P, 3), dtype=torch.float32, device=dev)
    a_ops = torch.zeros((B, S), dtype=torch.int64, device=dev)
    b_ops = torch.zeros((B, S), dtype=torch.int64, device=dev)
    kept = torch.zeros((B, S), dtype=torch.int64, device=dev)
    stop = torch.full((B, S), K, dtype=torch.int64, device=dev)
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
            stop = torch.where(~alive & (stop == K), c0, stop)
            old = (t_run, rgb, a_ops, b_ops, kept)
            new = tuple(
                torch.where(alive.reshape(B, S, *([1] * (n.ndim - 2))), n, o)
                for n, o in zip(new, old)
            )
        t_run, rgb, a_ops, b_ops, kept = new

    out = torch.cat([rgb.transpose(-1, -2), t_run[:, :, None, :]], dim=2)
    counts = torch.stack([a_ops, b_ops], dim=-1).to(torch.int32)
    return out, counts, stop


def raster_tile_plain(feat, tile_origin, tile_px: int, chunk: int = 128,
                      early_exit: bool = True):
    """Plain PyTorch tile RM: (num_tiles, 4, P) out, (num_tiles, 2) counts."""
    _check_chunk(feat, chunk)
    dx, dy = _pixel_offsets(tile_px, feat.device)
    pix_x = (tile_origin[:, 0, None] + dx[None, :])[:, None, :]
    pix_y = (tile_origin[:, 1, None] + dy[None, :])[:, None, :]
    out, counts, _ = _raster_plain(feat, pix_x, pix_y, chunk=chunk, early_exit=early_exit)
    return out[:, 0], counts[:, 0]


def raster_tile_walk(feat, tile_origin, tile_px: int, chunk: int = 128):
    """The entries of each tile's list that the tile RM needs with early
    exit, those before the chunk boundary where the plain version stops (K
    if it never does), as two (num_tiles,) int64 tensors ``(full,
    opacity_only)``: the ones up to the last entry with opacity > 0 (or
    NaN) are read in full, the rest only for their opacity."""
    _check_chunk(feat, chunk)
    dx, dy = _pixel_offsets(tile_px, feat.device)
    pix_x = (tile_origin[:, 0, None] + dx[None, :])[:, None, :]
    pix_y = (tile_origin[:, 1, None] + dy[None, :])[:, None, :]
    _, _, stop = _raster_plain(feat, pix_x, pix_y, chunk=chunk, early_exit=True)
    stop = stop[:, 0]
    live = ~(feat[:, F_OPACITY] <= 0.0)
    idx = torch.arange(1, feat.shape[-1] + 1, device=feat.device)
    full = torch.minimum(stop, torch.where(live, idx, 0).amax(-1))
    return full, stop - full


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
    out, counts, _ = _raster_plain(
        feat, ox[..., None] + dx, oy[..., None] + dy, chunk=chunk,
        early_exit=early_exit, masks=masks, tile_capacity=tile_capacity,
    )
    return out, counts


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
    with torch.cuda.device(feat.device):    # the launch goes to the current device
        status = lib.raster_tile_launch(
            feat.data_ptr(), origin.data_ptr(), out.data_ptr(), counts.data_ptr(),
            N, K, tile_px, chunk, int(early_exit), build.stream_of(feat),
        )
    build.check_status(lib, status, "raster_tile")
    build.count_launch("raster_tile")
    return out, counts


def tile_kernel_shape(tile_px: int) -> dict:
    """The tile kernel's launch for ``tile_px`` as the CUDA source decides
    it: threads a block, pixels a thread, whether every pixel slot lies in
    the tile, and entries a window. Builds the kernel on first use."""
    lib = build.load("raster_tile", _SIGNATURES)
    shape = (ctypes.c_int32 * 4)()
    build.check_status(lib, lib.raster_tile_shape(tile_px, ctypes.addressof(shape)),
                       "raster_tile_shape")
    return {"block_threads": shape[0], "pixels_per_thread": shape[1],
            "full": bool(shape[2]), "window_entries": shape[3]}


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
    with torch.cuda.device(feat.device):    # the launch goes to the current device
        status = lib.raster_group_fused_launch(
            feat.data_ptr(), masks.data_ptr(), origin.data_ptr(), out.data_ptr(),
            counts.data_ptr(), G, K, tile_px, gf, chunk, cap, int(early_exit),
            build.stream_of(feat),
        )
    build.check_status(lib, status, "raster_group_fused")
    build.count_launch("raster_group_fused")
    return out, counts


def edge_case_lists(tile_px: int, chunk: int, generator: torch.Generator):
    """Nine small tile lists at the tile kernel's seams: CPU tensors feat
    (9, 16, K) float32 and origins (9, 2) float32, K the least multiple of
    ``chunk`` that holds four windows (256 at chunk 32 or 64, 2,048 at chunk
    2,048). Entries are faint splats around the tile (opacity 0.01-0.08), so
    a tile lives to its list's end unless a list says otherwise. With W =
    TILE_WINDOW, per list:

      0. empty;
      1-3. W entries (the list ends at a window boundary), W + 1 (one entry
         past it) and 2W;
      4. K entries: every window full;
      5. 3W + 5 entries, opacity 0 at every third and -0.25 at every fifth,
         and none live in the second window (a window with nothing to blend);
      6. 3W entries with a NaN opacity at entry 5 and at entry W - 1, the
         first window's last: two small splats whose pixels turn NaN (and
         count as dead), while the rest of the tile blends on;
      7. 3W entries, three opaque tile-wide splats at W + 6 .. W + 8: every
         pixel dies there, inside the second window, and the tile stops at
         the next chunk boundary (inside that window at chunk 32, at a window
         boundary at chunk W, nowhere at chunk 2,048);
      8. 3W entries, opaque from its first chunk (entries 0-3).
    """
    W = TILE_WINDOW
    K = -(-max(chunk, 4 * W) // chunk) * chunk
    lengths = [0, W, W + 1, 2 * W, K, 3 * W + 5, 3 * W, 3 * W, 3 * W]
    N = len(lengths)

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float64)

    origins = torch.stack([torch.arange(N, dtype=torch.float64) * tile_px,
                           torch.full((N,), float(tile_px), dtype=torch.float64)], -1)
    feat = torch.zeros((N, NUM_FEATURES, K), dtype=torch.float64)
    for i, n in enumerate(lengths):
        f = feat[i]
        ox, oy = origins[i].tolist()
        f[F_MEAN_X, :n] = ox - tile_px / 2 + rand(n) * 2 * tile_px
        f[F_MEAN_Y, :n] = oy - tile_px / 2 + rand(n) * 2 * tile_px
        s1, s2 = tile_px * (0.1 + 0.7 * rand(n)), tile_px * (0.1 + 0.7 * rand(n))
        th = 2 * torch.pi * rand(n)
        c, s = torch.cos(th), torch.sin(th)
        a = c * c * s1 * s1 + s * s * s2 * s2  # covariance R diag(s1², s2²) Rᵀ
        b = c * s * (s1 * s1 - s2 * s2)
        d = s * s * s1 * s1 + c * c * s2 * s2
        det = a * d - b * b
        f[F_CONIC_A, :n], f[F_CONIC_B, :n], f[F_CONIC_C, :n] = d / det, -b / det, a / det
        f[F_OPACITY, :n] = 0.01 + 0.07 * rand(n)
        f[F_RGB_R:F_RGB_B + 1, :n] = rand(3, n)
        f[F_VALID, :n] = 1.0

    k = torch.arange(K)
    op = feat[5, F_OPACITY]
    op[(k % 3 == 0) & (k < lengths[5])] = 0.0
    op[(k % 5 == 0) & (k < lengths[5])] = -0.25
    op[W:2 * W] = 0.0
    nan_at = [5, W - 1]  # small splats (sigma 2 px) inside the tile
    feat[6, F_MEAN_X, nan_at] = origins[6, 0] + torch.tensor([0.25, 0.75], dtype=torch.float64) * tile_px
    feat[6, F_MEAN_Y, nan_at] = origins[6, 1] + torch.tensor([0.25, 0.75], dtype=torch.float64) * tile_px
    feat[6, F_CONIC_A, nan_at], feat[6, F_CONIC_B, nan_at], feat[6, F_CONIC_C, nan_at] = (
        0.25, 0.0, 0.25)
    feat[6, F_OPACITY, nan_at] = float("nan")
    for i, opaque in ((7, slice(W + 6, W + 9)), (8, slice(0, 4))):
        f = feat[i]
        f[F_MEAN_X, opaque] = origins[i, 0] + tile_px / 2
        f[F_MEAN_Y, opaque] = origins[i, 1] + tile_px / 2
        f[F_CONIC_A, opaque], f[F_CONIC_B, opaque], f[F_CONIC_C, opaque] = 1e-6, 0.0, 1e-6
        f[F_OPACITY, opaque] = 0.97
    return feat.to(torch.float32), origins.to(torch.float32)


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
