"""Bitmask Generation Module (BGM, paper Fig 10): CUDA kernel wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``repro.kernels.bitmask_gen.bitmask_kernel``.
The CUDA source is ``csrc/bitmask_gen.cu``: one thread per (group, entry),
gf (1..5) and the method fixed at compile time, the group's tile-in-image
flags read once as a word, each tile-line quantity computed once per entry
and shared by the member tiles on that line, one 32-bit word out, bit for
bit the words of ``bitmask_plain``.

``bitmask_kernel`` launches the kernel for CUDA tensors and runs
``bitmask_plain`` for CPU tensors; it never falls back from one to the
other. Masks are int32 tensors holding the uint32 bit patterns.
``edge_case_block`` builds the float32 edge cases both are held to.
"""
from __future__ import annotations

import torch

from repro_torch.core import boundary
from repro_torch.kernels import build
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
    F_RADIUS,
    F_VALID,
    NUM_FEATURES,
)

KERNEL_METHODS = ("aabb", "obb", "ellipse")

_P, _I = build.P, build.I
_SIGNATURES = {
    # feat, origin, tile_in_image, out, G, K, tile_px, gf, method, stream
    "bitmask_gen_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def bitmask_plain(
    feat: torch.Tensor,
    group_origin: torch.Tensor,
    tile_in_image: torch.Tensor,
    tile_px: int,
    gf: int,
    method: str = "ellipse",
) -> torch.Tensor:
    """Plain PyTorch BGM: the kernel's arithmetic, operation for operation
    (the boundary tests of ``core.boundary``, which keep the JAX order)."""
    _check_method(method)
    tpg = gf * gf
    slots = torch.arange(tpg, dtype=torch.int32, device=feat.device)
    ox = group_origin[:, 0, None, None]
    oy = group_origin[:, 1, None, None]
    x0 = ox + ((slots % gf) * tile_px).to(torch.float32)[None, None, :]
    y0 = oy + ((slots // gf) * tile_px).to(torch.float32)[None, None, :]
    rect = (x0, y0, x0 + tile_px, y0 + tile_px)  # each (G, 1, tpg)

    def rows(*r):  # (G, K, 1, len(r)) feature vector, (G, K, 1) if one row
        v = torch.stack([feat[:, i] for i in r], dim=-1)[:, :, None, :]
        return v[..., 0] if len(r) == 1 else v

    mean2d = rows(F_MEAN_X, F_MEAN_Y)
    if method == "aabb":
        hit = boundary.aabb_test(mean2d, rows(F_RADIUS), rect)
    elif method == "obb":
        hit = boundary.obb_test(
            mean2d, rows(F_EIGVEC_X, F_EIGVEC_Y), rows(F_EIGVAL_1, F_EIGVAL_2), rect
        )
    else:
        hit = boundary.ellipse_test(mean2d, rows(F_CONIC_A, F_CONIC_B, F_CONIC_C), rect)
    valid = feat[:, F_VALID] > 0.5
    hit = hit & valid[:, :, None] & tile_in_image.to(torch.bool)[:, None, :]
    weights = torch.ones((), dtype=torch.int32, device=feat.device) << slots
    return torch.sum(hit.to(torch.int32) * weights, dim=-1, dtype=torch.int32)


def bitmask_kernel(
    feat: torch.Tensor,          # (num_groups, F, K) float32
    group_origin: torch.Tensor,  # (num_groups, 2) float32
    tile_in_image: torch.Tensor, # (num_groups, tpg) bool
    tile_px: int,
    gf: int,
    method: str = "ellipse",
) -> torch.Tensor:
    """(num_groups, K) int32 bitmasks: the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor.

    The kernel shares each tile line between the tiles on it, which gives
    the plain version's words only when every tile line ox + i * tile_px is
    an integer of magnitude at most 2**24. Group origins must be such
    integers, as those of ``ops.group_origins`` are."""
    _check_method(method)
    if feat.device.type == "cpu":
        return bitmask_plain(feat, group_origin, tile_in_image, tile_px, gf, method)
    if feat.device.type != "cuda":
        raise ValueError(f"bitmask_kernel: unsupported device {feat.device}")
    G, F, K = feat.shape
    if F != NUM_FEATURES or feat.dtype != torch.float32 or not feat.is_contiguous():
        raise ValueError("bitmask_kernel: feat must be contiguous (G, 16, K) float32")
    if gf * gf > 32:
        raise ValueError(f"bitmask_kernel: {gf * gf} member tiles exceed a 32-bit mask")
    origin = group_origin.to(device=feat.device, dtype=torch.float32).contiguous()
    in_img = tile_in_image.to(device=feat.device, dtype=torch.int32).contiguous()
    if origin.shape != (G, 2) or in_img.shape != (G, gf * gf):
        raise ValueError("bitmask_kernel: origin/tile_in_image shapes disagree with feat")
    out = torch.empty((G, K), dtype=torch.int32, device=feat.device)
    if G == 0 or K == 0:
        return out
    lib = build.load("bitmask_gen", _SIGNATURES)
    status = lib.bitmask_gen_launch(
        feat.data_ptr(), origin.data_ptr(), in_img.data_ptr(), out.data_ptr(),
        G, K, tile_px, gf, KERNEL_METHODS.index(method), build.stream_of(feat),
    )
    build.check_status(lib, status, "bitmask_gen")
    build.count_launch("bitmask_gen")
    return out


def edge_case_block(gf: int, tile_px: int, generator: torch.Generator):
    """Four groups of 512 entries that put the BGM's float32 edge cases to
    every method: CPU tensors feat (4, 16, 512) float32, origins (4, 2)
    float32 and tile_in_image (4, gf * gf) bool. Per group, by entries:

      * 0-127: scene-like splats (random covariances) around the group;
      * 128-255: means on the group's tile lines and corners, and one ulp
        either side of them (not at a line at 0, see below);
      * 256-319: q = 9 exactly on a tile edge (B = 0), or one ulp past it;
        aabb radii and obb half-axes that reach an edge exactly;
      * 320-383: B = 0, |A| and |C| below 1e-12, huge conics, radii and
        eigenvalues, zero and unnormalised eigenvectors;
      * 384-495: NaN or +-inf in one row a method reads, with valid = 1
        except at 480-495, whose valid flags are 0, 0.5, one ulp above 0.5,
        NaN, +-inf or 1;
      * 496-511: scene-like splats again, but in group 0 a mean one ulp
        below the tile line at 0.

    Those 16 means are the block's only float32 subnormals. Each has an
    infinite A (or C) and radius 0, so its ellipse and its aabb box miss
    the tile whose line it sits below; read as zero (flush to zero), the
    mean lies on the line, inside the tile, and the entry's word changes.
    Group origins: (0, 0); the next group to the right; integers just
    below 2**24; and a negative one, left of the image. All are integers,
    as the kernel requires (see ``bitmask_kernel``). Group 0 has every
    member tile in the image; the others have some outside it.
    """
    f32 = torch.float32
    G, K, tpg, span = 4, 512, gf * gf, gf * tile_px
    inf, nan = float("inf"), float("nan")

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float64)

    def pick(values, n):
        idx = torch.randint(len(values), (n,), generator=generator)
        return torch.tensor(values, dtype=torch.float64)[idx]

    def lines(o, idx):  # tile lines o + idx * tile_px, as the kernel computes them
        return torch.tensor(o, dtype=f32) + (idx * tile_px).to(f32)

    def ulp(v, step):  # v one ulp up (+1), down (-1) or as is (0), in float32
        v = v.to(f32)
        up = torch.nextafter(v, torch.full_like(v, inf))
        down = torch.nextafter(v, torch.full_like(v, -inf))
        return torch.where(step > 0, up, torch.where(step < 0, down, v))

    origins = torch.tensor([[0.0, 0.0], [float(span), 0.0],
                            [float(2**24 - span), float(2**23)], [float(-span), 64.0]],
                           dtype=f32)
    in_img = rand(G, tpg) < 0.7
    in_img[0] = True
    in_img[2, tpg - gf:] = False
    feat = torch.zeros((G, NUM_FEATURES, K), dtype=torch.float64)
    for g in range(G):
        ox, oy = origins[g].tolist()
        f = feat[g]
        # Scene-like splats everywhere first; the segments below overwrite.
        f[F_MEAN_X] = ox - tile_px + rand(K) * (span + 2 * tile_px)
        f[F_MEAN_Y] = oy - tile_px + rand(K) * (span + 2 * tile_px)
        s1, s2 = tile_px * (0.05 + 1.5 * rand(K)), tile_px * (0.05 + 1.5 * rand(K))
        th = 2 * torch.pi * rand(K)
        c, s = torch.cos(th), torch.sin(th)
        a = c * c * s1 * s1 + s * s * s2 * s2  # covariance R diag(s1², s2²) Rᵀ
        b = c * s * (s1 * s1 - s2 * s2)
        d = s * s * s1 * s1 + c * c * s2 * s2
        det = a * d - b * b
        f[F_CONIC_A], f[F_CONIC_B], f[F_CONIC_C] = d / det, -b / det, a / det
        f[F_RADIUS] = 3 * torch.maximum(s1, s2)
        f[F_EIGVEC_X], f[F_EIGVEC_Y] = c, s
        f[F_EIGVAL_1], f[F_EIGVAL_2] = s1 * s1, s2 * s2
        f[F_VALID] = 1.0

        # Means on tile lines and corners, and one ulp off (not at line 0).
        seg = slice(128, 256)
        n = 128
        lx = lines(ox, torch.randint(gf + 1, (n,), generator=generator))
        ly = lines(oy, torch.randint(gf + 1, (n,), generator=generator))
        step_x = torch.randint(-1, 2, (n,), generator=generator) * (lx != 0)
        step_y = torch.randint(-1, 2, (n,), generator=generator) * (ly != 0)
        on_y = rand(n) < 0.5
        f[F_MEAN_X, seg] = ulp(lx, step_x).double()
        f[F_MEAN_Y, seg] = torch.where(on_y, ulp(ly, step_y).double(), f[F_MEAN_Y, seg])

        # q = 9 exactly at distance d from a line (A d^2 = 9), or one ulp of
        # A past it; the aabb radius and the obb half-axis are d too.
        seg = slice(256, 320)
        n = 64
        pairs = torch.tensor([[1.0, 3.0], [4.0, 1.5], [0.25, 6.0], [0.5625, 4.0]],
                             dtype=torch.float64)
        A, dist = pairs[torch.randint(4, (n,), generator=generator)].unbind(-1)
        A = ulp(A, (rand(n) < 0.5).long()).double()
        side = torch.where(rand(n) < 0.5, -1.0, 1.0).double()
        line = torch.randint(gf + 1, (n,), generator=generator)
        mid = torch.randint(gf, (n,), generator=generator)
        vertical = rand(n) < 0.5
        near_x = lines(ox, line).double() + side * dist
        near_y = lines(oy, line).double() + side * dist
        mid_x = lines(ox, mid).double() + 0.5 * tile_px
        mid_y = lines(oy, mid).double() + 0.5 * tile_px
        f[F_MEAN_X, seg] = torch.where(vertical, near_x, mid_x)
        f[F_MEAN_Y, seg] = torch.where(vertical, mid_y, near_y)
        f[F_CONIC_A, seg], f[F_CONIC_B, seg], f[F_CONIC_C, seg] = A, 0.0, A
        f[F_RADIUS, seg] = dist
        f[F_EIGVEC_X, seg], f[F_EIGVEC_Y, seg] = 1.0, 0.0
        f[F_EIGVAL_1, seg] = (dist / 3) ** 2
        f[F_EIGVAL_2, seg] = (dist / 3) ** 2

        # Degenerate and huge shapes.
        seg = slice(320, 384)
        n = 64
        small_huge = [0.0, -0.0, 1e-13, -1e-13, 9.9e-13, 1e-12, 1.0, -1.0, 1e30, -1e30]
        f[F_CONIC_A, seg] = pick(small_huge, n)
        f[F_CONIC_C, seg] = pick(small_huge, n)
        f[F_CONIC_B, seg] = pick([0.0, -0.0, 0.5, -3.0, 1e20, -1e38], n)
        f[F_RADIUS, seg] = pick([0.0, -0.0, -5.0, 0.5, 1e30], n)
        f[F_EIGVAL_1, seg] = pick([0.0, -1.0, 1e-13, 4.0, 1e38], n)
        f[F_EIGVAL_2, seg] = pick([0.0, -1.0, 1e-13, 4.0, 1e38], n)
        vec = torch.tensor([[0.0, 0.0], [1e30, 0.0], [0.6, 0.8], [-1.0, 0.0], [3.0, 4.0]],
                           dtype=torch.float64)[torch.randint(5, (n,), generator=generator)]
        f[F_EIGVEC_X, seg], f[F_EIGVEC_Y, seg] = vec.unbind(-1)

        # Non-finite values in one row a method reads, with valid = 1.
        seg = slice(384, 496)
        n = 112
        rows = torch.tensor([F_MEAN_X, F_MEAN_Y, F_CONIC_A, F_CONIC_B, F_CONIC_C, F_RADIUS,
                             F_EIGVEC_X, F_EIGVEC_Y, F_EIGVAL_1, F_EIGVAL_2])
        which = rows[torch.randint(len(rows), (n,), generator=generator)]
        f[which, torch.arange(seg.start, seg.stop)] = pick([nan, inf, -inf], n)
        f[F_VALID, 480:496] = pick([0.0, 0.5, 0.50000006, nan, inf, -inf, 1.0], 16)

        if g == 0:  # one ulp below line x = 0 (496-503) or y = 0 (504-511)
            sub = -torch.finfo(f32).smallest_normal * 2.0**-23
            row = torch.randint(gf, (16,), generator=generator) * tile_px + 0.5 * tile_px
            f[F_MEAN_X, 496:512] = torch.cat([torch.full((8,), sub), row[8:].double()])
            f[F_MEAN_Y, 496:512] = torch.cat([row[:8].double(), torch.full((8,), sub)])
            f[F_CONIC_A, 496:512] = torch.tensor([inf] * 8 + [1.0] * 8)
            f[F_CONIC_B, 496:512] = 0.0
            f[F_CONIC_C, 496:512] = torch.tensor([1.0] * 8 + [inf] * 8)
            f[F_RADIUS, 496:512] = 0.0
            f[F_VALID, 496:512] = 1.0
    return feat.to(f32), origins, in_img


def _check_method(method: str) -> None:
    if method not in KERNEL_METHODS:
        raise ValueError(
            f"the BGM kernel runs {KERNEL_METHODS}, not {method!r}"
        )
