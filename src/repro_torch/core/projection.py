"""Preprocessing stage of the 3D-GS pipeline (mirror of
``repro.core.projection``).

Computes, per Gaussian: depth D, 2D center, 2D covariance (+ its conic
inverse), screen-space radius (3-sigma rule, as in the original 3D-GS), view
color from SH, and the frustum-culling validity mask.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import SH_C0, GaussianScene, covariance3d

# Low-pass filter added to the 2D covariance diagonal (anti-aliasing), exactly
# as in the reference 3D-GS rasterizer.
COV2D_BLUR = 0.3
# 3-sigma rule for the Gaussian's screen extent (paper §II-B).
SIGMA_CUT = 3.0
QMAX_3SIGMA = SIGMA_CUT * SIGMA_CUT

SH_C1 = 0.4886025119029199


@dataclasses.dataclass
class Projected:
    """Per-Gaussian screen-space features (all (N, ...))."""

    mean2d: torch.Tensor      # (N, 2) pixel coords
    cov2d: torch.Tensor       # (N, 3) upper-triangular (a, b, c): [[a, b], [b, c]]
    conic: torch.Tensor       # (N, 3) inverse covariance, same packing
    depth: torch.Tensor       # (N,)
    radius: torch.Tensor      # (N,) 3-sigma screen radius (pixels)
    axis_radius: torch.Tensor # (N, 2) 3-sigma per screen axis (AABB half-extent)
    eigvec: torch.Tensor      # (N, 2) major-axis unit vector (for OBB)
    eigval: torch.Tensor      # (N, 2) eigenvalues (major, minor) of cov2d
    rgb: torch.Tensor         # (N, 3) decoded view-dependent color
    alpha: torch.Tensor       # (N,) sigmoid opacity
    valid: torch.Tensor       # (N,) bool frustum/size cull mask


def proj_take(proj: Projected, name: str, idx: torch.Tensor) -> torch.Tensor:
    """Gather field ``name`` at gaussian indices ``idx`` (any shape). The
    port keeps projected features flat; the per-shard layout of the JAX
    package (``ShardedProjected``) is not ported yet."""
    return getattr(proj, name)[idx.long()]


def proj_valid_count(proj: Projected) -> torch.Tensor:
    """Visible-gaussian count (exact integer reduction)."""
    return torch.sum(proj.valid.to(torch.int64))


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH color (deg 0 or 1 supported; higher coeffs ignored).

    sh: (N, K, 3); dirs: (N, 3) unit view directions.
    """
    rgb = SH_C0 * sh[:, 0, :]
    if sh.shape[1] >= 4:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        rgb = rgb + SH_C1 * (-y * sh[:, 1, :] + z * sh[:, 2, :] - x * sh[:, 3, :])
    return torch.clamp(rgb + 0.5, 0.0, 1.0)


def eigen2x2(a, b, c, det):
    """Closed-form eigen-decomposition of [[a, b], [b, c]] with determinant
    ``det``: (major eigenvalue, minor eigenvalue, (N, 2) major-axis unit
    vector). The vector is ill-conditioned where |b| is tiny (a nearly
    axis-aligned ellipse): there ulp-level drift in (a, b, c) moves it."""
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=1e-12))
    lam1 = mid + disc  # major
    lam2 = torch.clamp(mid - disc, min=1e-12)  # minor
    # Major-axis direction: eigenvector of lam1.
    big_b = torch.abs(b) > 1e-9
    ex = torch.where(big_b, b, lam1 - c)
    ey = torch.where(big_b, lam1 - a, torch.zeros_like(b))
    # Degenerate (already axis-aligned): fall back to x-axis.
    enorm = torch.sqrt(ex * ex + ey * ey)
    ok = enorm > 1e-9
    enorm_safe = torch.clamp(enorm, min=1e-12)
    ex = torch.where(ok, ex / enorm_safe, torch.ones_like(ex))
    ey = torch.where(ok, ey / enorm_safe, torch.zeros_like(ey))
    return lam1, lam2, torch.stack([ex, ey], dim=-1)


def project(scene: GaussianScene, cam: Camera) -> Projected:
    """The preprocessing stage: features + culling (paper Fig 1)."""
    dev = scene.means3d.device
    R = torch.as_tensor(cam.R, dtype=torch.float32, device=dev)
    t = torch.as_tensor(cam.t, dtype=torch.float32, device=dev)
    p_cam = scene.means3d @ R.T + t[None, :]  # (N, 3)
    x, y, z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]
    z_safe = torch.clamp(z, min=1e-6)

    mean2d = torch.stack(
        [cam.fx * x / z_safe + cam.cx, cam.fy * y / z_safe + cam.cy], dim=-1
    )

    # --- 2D covariance via the projective Jacobian (EWA splatting) ---
    cov3d = covariance3d(scene.log_scales, scene.quats)      # (N, 3, 3)
    cov3d_cam = torch.einsum("ij,njk,lk->nil", R, cov3d, R)   # R Σ R^T
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    # J = [[fx/z, 0, -fx x / z^2], [0, fy/z, -fy y / z^2]]
    j00 = cam.fx * inv_z
    j02 = -cam.fx * x * inv_z2
    j11 = cam.fy * inv_z
    j12 = -cam.fy * y * inv_z2
    zeros = torch.zeros_like(j00)
    J = torch.stack(
        [
            torch.stack([j00, zeros, j02], dim=-1),
            torch.stack([zeros, j11, j12], dim=-1),
        ],
        dim=-2,
    )  # (N, 2, 3)
    cov2d_full = J @ cov3d_cam @ J.transpose(-1, -2)          # (N, 2, 2)
    a = cov2d_full[:, 0, 0] + COV2D_BLUR
    b = cov2d_full[:, 0, 1]
    c = cov2d_full[:, 1, 1] + COV2D_BLUR
    cov2d = torch.stack([a, b, c], dim=-1)

    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    lam1, lam2, eigvec = eigen2x2(a, b, c, det)
    radius = SIGMA_CUT * torch.sqrt(torch.clamp(lam1, min=1e-12))
    eigval = torch.stack([lam1, lam2], dim=-1)

    # Tight per-axis 3-sigma extents (AABB of the ellipse, not of the circle).
    axis_radius = SIGMA_CUT * torch.sqrt(
        torch.clamp(torch.stack([a, c], dim=-1), min=1e-12)
    )

    # --- color + opacity ---
    cam_pos = -R.T @ t
    dirs = scene.means3d - cam_pos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    rgb = eval_sh(scene.sh, dirs)
    alpha = torch.sigmoid(scene.opacity)

    # --- culling (paper Fig 1: invisible Gaussians removed) ---
    in_front = z > cam.znear
    not_far = z < cam.zfar
    on_screen = (
        (mean2d[:, 0] + radius > 0.0)
        & (mean2d[:, 0] - radius < cam.width)
        & (mean2d[:, 1] + radius > 0.0)
        & (mean2d[:, 1] - radius < cam.height)
    )
    big_enough = det > 1e-12
    visible_alpha = alpha > (1.0 / 255.0)
    valid = in_front & not_far & on_screen & big_enough & visible_alpha

    # Sanitize culled Gaussians exactly as the JAX package does: a NaN
    # feature would poison rasterization through 0*NaN even at zero opacity.
    def _clean(x, default):
        mask = valid if x.ndim == 1 else valid[:, None]
        default = torch.as_tensor(default, dtype=x.dtype, device=dev)
        return torch.where(
            mask, torch.nan_to_num(x, nan=0.0, posinf=1e30, neginf=-1e30), default
        )

    ident2 = [1.0, 0.0, 1.0]
    return Projected(
        mean2d=_clean(mean2d, 0.0),
        cov2d=_clean(cov2d, ident2),
        conic=_clean(conic, ident2),
        depth=_clean(z, float("inf")),
        radius=_clean(radius, 0.0),
        axis_radius=_clean(axis_radius, 0.0),
        eigvec=_clean(eigvec, [1.0, 0.0]),
        eigval=_clean(eigval, 1.0),
        rgb=_clean(rgb, 0.0),
        alpha=_clean(alpha, 0.0),
        valid=valid,
    )
