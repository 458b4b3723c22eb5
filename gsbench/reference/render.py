"""Plain PyTorch reference of one 3D Gaussian Splatting frame, in float32.

This is the yardstick that decides a run's ``correct``: it imports torch
alone, never the program under test, and works out everything from the
scene tensors and the camera that the benchmark made. It follows the 3D-GS
forward pass as the GS-TG paper states it (Kerbl et al. 2023, GS-TG
section II-B):

  * projection: world to camera by (R, t); the EWA 2D covariance
    J W Sigma W^T J^T plus 0.3 on the diagonal (the low-pass filter);
    conic = its inverse; radius = 3 sqrt(major eigenvalue); colour from the
    degree-0 (and degree-1) SH coefficients along the view direction;
    opacity = sigmoid(logit);
  * culling: in front of znear and before zfar, the 3-sigma circle overlaps
    the image, a positive 2D determinant, opacity above 1/255;
  * lists: every (gaussian, tile) pair whose 3-sigma ellipse reaches the
    tile's rectangle, ordered by (depth, gaussian index). **No list is
    cut**: there is no capacity and no candidate window;
  * blending: per pixel, front to back, alpha = min(o exp(-q/2), 0.99),
    zero where q > 9 or alpha < 1/255; an entry contributes only while the
    transmittance before it is above 1e-4; background black.

Beside the image it counts the work that these inputs need, whatever
implements them (``gsbench/work.py`` turns the counts into a bound): the
live entries of each group list, the alpha tests made before a pixel's
early exit and the blends that contribute.

``tf32=True`` computes every matrix product with its inputs rounded to
TF32 (10 mantissa bits) and float32 accumulation, as the card's tensor
cores do with TF32 allowed: the control, the nearest precision below the
float32 that the configurations state. It gives the same bits on every
device, so the control runs here and on the card alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
COV2D_BLUR = 0.3
QMAX = 9.0                 # (3 sigma)^2
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
CHUNK = 32                 # list entries blended at a time
BLOCK_TILES = 2048         # tiles blended at a time
MAX_PAIRS = 1 << 24        # candidate (gaussian, bin) pairs tested at a time


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera: world to camera rotation ``R`` (3x3, nested lists
    or an array) and translation ``t``; intrinsics in pixels; +z looks into
    the scene, x right, y down."""

    R: tuple
    t: tuple
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    znear: float = 0.2
    zfar: float = 1000.0


@dataclasses.dataclass
class Frame:
    image: torch.Tensor          # (H, W, 3) float32
    counts: Dict[str, int]       # the work these inputs need (see module doc)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even at 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def _matmul(tf32: bool):
    if not tf32:
        return torch.matmul
    return lambda a, b: torch.matmul(round_tf32(a), round_tf32(b))


def _quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(*q.shape[:-1], 3, 3)


def project(scene: Dict[str, torch.Tensor], cam: Camera, tf32: bool = False) -> dict:
    """Screen-space features of the visible gaussians, keyed by field, with
    ``index`` their rows in the scene (ascending)."""
    mm = _matmul(tf32)
    means = scene["means3d"]
    dev = means.device
    R = torch.as_tensor(cam.R, dtype=torch.float32, device=dev).reshape(3, 3)
    t = torch.as_tensor(cam.t, dtype=torch.float32, device=dev).reshape(3)
    pc = mm(means, R.T) + t
    x, y, z = pc.unbind(-1)
    zs = torch.clamp(z, min=1e-6)
    u = cam.fx * x / zs + cam.cx
    v = cam.fy * y / zs + cam.cy

    M = _quat_to_rot(scene["quats"]) * torch.exp(scene["log_scales"])[:, None, :]
    cov3 = mm(M, M.transpose(1, 2))
    cov_cam = mm(mm(R.expand(len(means), 3, 3), cov3), R.T)
    zero = torch.zeros_like(zs)
    J = torch.stack([
        cam.fx / zs, zero, -cam.fx * x / (zs * zs),
        zero, cam.fy / zs, -cam.fy * y / (zs * zs),
    ], dim=-1).reshape(-1, 2, 3)
    cov2 = mm(mm(J, cov_cam), J.transpose(1, 2))
    a = cov2[:, 0, 0] + COV2D_BLUR
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + COV2D_BLUR
    det = a * c - b * b
    det_c = torch.clamp(det, min=1e-12)
    half = 0.5 * (a + c)
    major = half + torch.sqrt(torch.clamp(half * half - det, min=1e-12))
    radius = 3.0 * torch.sqrt(torch.clamp(major, min=1e-12))

    eye = -(R.T @ t)
    dirs = means - eye
    dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-12)
    sh = scene["sh"]
    rgb = SH_C0 * sh[:, 0, :]
    if sh.shape[1] >= 4:
        dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        rgb = rgb + SH_C1 * (-dy * sh[:, 1, :] + dz * sh[:, 2, :] - dx * sh[:, 3, :])
    rgb = torch.clamp(rgb + 0.5, 0.0, 1.0)
    opacity = torch.sigmoid(scene["opacity"])

    keep = ((z > cam.znear) & (z < cam.zfar)
            & (u + radius > 0) & (u - radius < cam.width)
            & (v + radius > 0) & (v - radius < cam.height)
            & (det > 1e-12) & (opacity > ALPHA_MIN))
    index = torch.nonzero(keep).squeeze(1)
    conic = torch.stack([c / det_c, -b / det_c, a / det_c], dim=-1)
    return {
        "index": index,
        "mean": torch.stack([u, v], dim=-1)[index],
        "conic": conic[index],
        "depth": z[index],
        "radius": radius[index],
        "rgb": rgb[index],
        "opacity": opacity[index],
    }


def _min_q_over_rect(mean, conic, x0, y0, x1, y1):
    """Least value of the conic's quadratic form (p - mean)^T Q (p - mean)
    over the closed rectangle: 0 with the mean inside, else the least of
    the four edges' clamped 1-D minima."""
    A, B, C = conic[:, 0], conic[:, 1], conic[:, 2]
    mx, my = mean[:, 0], mean[:, 1]

    def q(px, py):
        dx, dy = px - mx, py - my
        return A * dx * dx + 2.0 * B * dx * dy + C * dy * dy

    def on_vertical(xe):    # x fixed: the minimum over y at my - B dx / C
        return q(xe, torch.minimum(torch.maximum(my - B * (xe - mx) / C, y0), y1))

    def on_horizontal(ye):
        return q(torch.minimum(torch.maximum(mx - B * (ye - my) / A, x0), x1), ye)

    least = torch.minimum(torch.minimum(on_vertical(x0), on_vertical(x1)),
                          torch.minimum(on_horizontal(y0), on_horizontal(y1)))
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)
    return torch.where(inside, torch.zeros_like(least), least)


def bin_pairs(proj: dict, px: int, nx: int, ny: int):
    """Every (visible gaussian, bin) pair of a grid of ``px``-pixel bins
    whose 3-sigma ellipse reaches the bin: the bins of the circumscribed
    circle's box, each held to the exact ellipse test. Returns (gaussian
    position in ``proj``, bin id), tested in blocks of at most
    ``MAX_PAIRS`` candidates."""
    mean, radius = proj["mean"], proj["radius"]
    dev = mean.device
    bx0 = torch.clamp(torch.floor((mean[:, 0] - radius) / px), 0, nx - 1).long()
    bx1 = torch.clamp(torch.floor((mean[:, 0] + radius) / px), 0, nx - 1).long()
    by0 = torch.clamp(torch.floor((mean[:, 1] - radius) / px), 0, ny - 1).long()
    by1 = torch.clamp(torch.floor((mean[:, 1] + radius) / px), 0, ny - 1).long()
    w = bx1 - bx0 + 1
    n_cand = w * (by1 - by0 + 1)
    ends = torch.cumsum(n_cand, 0)
    gs, bins = [], []
    start_g = 0
    while start_g < len(n_cand):
        base = int(ends[start_g - 1]) if start_g else 0
        stop_g = int(torch.searchsorted(ends, base + MAX_PAIRS, side="right"))
        stop_g = max(stop_g, start_g + 1)
        sl = slice(start_g, stop_g)
        g = torch.repeat_interleave(torch.arange(start_g, stop_g, device=dev), n_cand[sl])
        first = ends[sl] - n_cand[sl]
        off = torch.arange(len(g), device=dev) + base - first.repeat_interleave(n_cand[sl])
        bx = bx0[g] + off % w[g]
        by = by0[g] + off // w[g]
        x0, y0 = (bx * px).float(), (by * px).float()
        hit = _min_q_over_rect(mean[g], proj["conic"][g], x0, y0, x0 + px, y0 + px) <= QMAX
        gs.append(g[hit])
        bins.append((by * nx + bx)[hit])
        start_g = stop_g
    if not gs:
        empty = torch.zeros(0, dtype=torch.long, device=dev)
        return empty, empty
    return torch.cat(gs), torch.cat(bins)


def render(scene: Dict[str, torch.Tensor], cam: Camera, *, group: int = 64, tile: int = 16,
           tf32: bool = False) -> Frame:
    """The frame of ``scene`` seen by ``cam`` (width and height multiples
    of ``tile``) and the work it needs. ``group`` only sets the grid on
    which the group lists are counted."""
    mm = _matmul(tf32)
    proj = project(scene, cam, tf32)
    dev = proj["mean"].device
    W, H = cam.width, cam.height
    ntx, nty = W // tile, H // tile
    n_tiles = ntx * nty
    nv = len(proj["depth"])

    # Depth order with the gaussian's row as the tie-break: a stable sort of
    # the depths in row order.
    rank = torch.empty(nv, dtype=torch.long, device=dev)
    rank[torch.sort(proj["depth"], stable=True).indices] = torch.arange(nv, device=dev)
    g, tid = bin_pairs(proj, tile, ntx, nty)
    order = torch.sort(tid * max(nv, 1) + rank[g]).indices
    g, tid = g[order], tid[order]
    lengths = torch.bincount(tid, minlength=n_tiles)
    starts = torch.cumsum(lengths, 0) - lengths

    image = torch.zeros((nty, ntx, tile, tile, 3), dtype=torch.float32, device=dev)
    alpha_tests = torch.zeros((), dtype=torch.int64, device=dev)
    blends = torch.zeros((), dtype=torch.int64, device=dev)
    ramp = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    offs = torch.stack(torch.meshgrid(ramp, ramp, indexing="xy"), -1).reshape(-1, 2)

    by_len = torch.sort(lengths, descending=True, stable=True).indices
    for b0 in range(0, n_tiles, BLOCK_TILES):
        tiles = by_len[b0:b0 + BLOCK_TILES]
        L = int(lengths[tiles[0]])
        if L == 0:
            break
        nb = len(tiles)
        origin = torch.stack([(tiles % ntx) * tile, (tiles // ntx) * tile], -1).float()
        pix = origin[:, None, :] + offs[None]                        # (nb, P, 2)
        T = torch.ones(pix.shape[:2], dtype=torch.float32, device=dev)
        color = torch.zeros((*pix.shape[:2], 3), dtype=torch.float32, device=dev)
        ks = torch.arange(CHUNK, device=dev)
        for c0 in range(0, L, CHUNK):
            k = c0 + ks
            live_e = k[None, :] < lengths[tiles][:, None]           # (nb, chunk)
            pos = torch.where(live_e, starts[tiles][:, None] + k[None, :], 0)
            e = g[pos]
            m, cn = proj["mean"][e], proj["conic"][e]
            d = pix[:, :, None, :] - m[:, None, :, :]                # (nb, P, chunk, 2)
            dx, dy = d[..., 0], d[..., 1]
            q = (cn[:, None, :, 0] * dx * dx + 2.0 * cn[:, None, :, 1] * dx * dy
                 + cn[:, None, :, 2] * dy * dy)
            a = torch.clamp(proj["opacity"][e][:, None, :] * torch.exp(-0.5 * q), max=ALPHA_MAX)
            a = torch.where((q > QMAX) | (a < ALPHA_MIN) | ~live_e[:, None, :], 0.0, a)
            keep = torch.cumprod(1.0 - a, dim=2)
            t_before = T[:, :, None] * torch.cat([torch.ones_like(keep[..., :1]),
                                                  keep[..., :-1]], dim=2)
            on = t_before > T_EPS
            wgt = torch.where(on, a * t_before, 0.0)
            color = color + mm(wgt, proj["rgb"][e])
            alpha_tests += torch.sum(on & live_e[:, None, :])
            blends += torch.sum(wgt > 0)
            T = T * keep[..., -1]
        image[tiles // ntx, tiles % ntx] = color.reshape(nb, tile, tile, 3)

    ngx, ngy = -(-W // group), -(-H // group)
    gg, gid = bin_pairs(proj, group, ngx, ngy)
    glen = torch.bincount(gid, minlength=ngx * ngy)
    # Member tiles of each group that lie in the image (edge groups hold
    # fewer).
    gx, gy = torch.arange(ngx * ngy, device=dev) % ngx, torch.arange(ngx * ngy, device=dev) // ngx
    per = group // tile
    cols = torch.clamp(ntx - gx * per, max=per)
    rows = torch.clamp(nty - gy * per, max=per)
    counts = {
        "visible": nv,
        "tile_entries": int(len(g)),
        "longest_tile_list": int(lengths.max()) if n_tiles else 0,
        "alpha_tests": int(alpha_tests),
        "blends": int(blends),
        "group_entries": int(len(gg)),
        "longest_group_list": int(glen.max()),
        "entry_tile_tests": int(torch.sum(glen * cols * rows)),
    }
    img = image.permute(0, 2, 1, 3, 4).reshape(H, W, 3)
    return Frame(image=img, counts=counts)


def dense_render(scene: Dict[str, torch.Tensor], cam: Camera) -> torch.Tensor:
    """Every visible gaussian tested at every pixel, front to back, one
    entry at a time: no lists at all. Only for tiny frames (tests)."""
    proj = project(scene, cam)
    order = torch.sort(proj["depth"], stable=True).indices
    ys, xs = torch.meshgrid(torch.arange(cam.height) + 0.5, torch.arange(cam.width) + 0.5,
                            indexing="ij")
    pix = torch.stack([xs, ys], -1).to(proj["mean"].device)
    T = torch.ones(pix.shape[:2])
    color = torch.zeros((*pix.shape[:2], 3))
    for i in order.tolist():
        d = pix - proj["mean"][i]
        cn = proj["conic"][i]
        q = cn[0] * d[..., 0] ** 2 + 2.0 * cn[1] * d[..., 0] * d[..., 1] + cn[2] * d[..., 1] ** 2
        a = torch.clamp(proj["opacity"][i] * torch.exp(-0.5 * q), max=ALPHA_MAX)
        a = torch.where((q > QMAX) | (a < ALPHA_MIN), 0.0, a)
        on = T > T_EPS
        color = color + torch.where(on, a * T, 0.0)[..., None] * proj["rgb"][i]
        T = T * (1.0 - a)
    return color


def camera_of(obj) -> Camera:
    """A reference Camera from any object with the same fields."""
    return Camera(R=tuple(map(tuple, _rows(obj.R))), t=tuple(float(v) for v in _flat(obj.t)),
                  fx=float(obj.fx), fy=float(obj.fy), cx=float(obj.cx), cy=float(obj.cy),
                  width=int(obj.width), height=int(obj.height),
                  znear=float(obj.znear), zfar=float(obj.zfar))


def _rows(m):
    return [[float(v) for v in row] for row in m]


def _flat(v):
    return [float(x) for x in (v.tolist() if hasattr(v, "tolist") else v)]


__all__ = ["Camera", "Frame", "render", "project", "dense_render", "round_tf32",
           "camera_of", "bin_pairs", "T_EPS"]
