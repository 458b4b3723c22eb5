"""Bitmask Generation Module (BGM, paper Fig 10): CUDA kernel wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``repro.kernels.bitmask_gen.bitmask_kernel``.
The CUDA source is ``csrc/bitmask_gen.cu``: one thread per (group, entry),
the gf^2 member-tile tests in registers, one 32-bit word out.

``bitmask_kernel`` launches the kernel for CUDA tensors and runs
``bitmask_plain`` for CPU tensors; it never falls back from one to the
other. Masks are int32 tensors holding the uint32 bit patterns.
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
    the plain version on a CPU tensor."""
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


def _check_method(method: str) -> None:
    if method not in KERNEL_METHODS:
        raise ValueError(
            f"the BGM kernel runs {KERNEL_METHODS}, not {method!r}"
        )
