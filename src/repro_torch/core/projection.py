"""Preprocessing stage of the 3D-GS pipeline (mirror of
``repro.core.projection``).

Computes, per Gaussian: depth D, 2D center, 2D covariance (+ its conic
inverse), screen-space radius (3-sigma rule, as in the original 3D-GS), view
color from SH, and the frustum-culling validity mask.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import SH_C0, GaussianScene, covariance3d, row_norm, small_matmul

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


# Per-field trailing widths of Projected — the basis of the per-camera
# activation term in the device-budget model (engine/handle.py): every field
# is float32 except ``valid`` (bool, 1 byte).
PROJECTED_FIELD_WIDTHS = {
    "mean2d": 2, "cov2d": 3, "conic": 3, "depth": 1, "radius": 1,
    "axis_radius": 2, "eigvec": 2, "eigval": 2, "rgb": 3, "alpha": 1,
    "valid": 1,
}


def projected_bytes_per_gaussian() -> int:
    """Bytes of projected per-camera features one gaussian costs."""
    # Guard against schema drift: a Projected field added without updating
    # the widths dict would silently undercount the device-budget model.
    assert set(PROJECTED_FIELD_WIDTHS) == {
        f.name for f in dataclasses.fields(Projected)
    }, "PROJECTED_FIELD_WIDTHS out of sync with Projected's fields"
    return sum(
        w * (1 if name == "valid" else 4)
        for name, w in PROJECTED_FIELD_WIDTHS.items()
    )


@dataclasses.dataclass
class ShardedProjected:
    """Projected features kept in the per-shard layout (DESIGN.md §12).

    ``shards`` holds either the ordinary :class:`Projected` tensors with a
    leading ``(D, Ns)`` shard axis (the per-shard projections stacked on
    one device, never flattened to the padded ``(D * Ns, ...)`` view), or a
    tuple of D ``Projected``, each on its shard's device (the physical
    form, a scene placed over a mesh's ``'model'`` axis). ``gather``
    selects how a consumer fetches an entry's features from its owning
    shard:

      * ``'index'`` — the plain 2-D indexed gather ``field[shard, local]``;
        on the physical form each shard gathers what it owns on its device
        and the lead device selects the owner's values;
      * ``'psum'``  — owner-masked per-shard gathers summed over the shard
        axis on the raw bit patterns (exactly one shard owns each entry, so
        the integer sum is the owner's bits). On the physical form each
        shard gathers on its own device and the D contributions are summed
        on the lead device: the reduce of a several-device commit.
        Inference only: it refuses to record a gradient.

    Both are bitwise the flat gather ``concat(shards)[global_idx]``:
    ``flat[g] == shards[g // Ns, g % Ns]``.
    """

    shards: Union[Projected, Tuple[Projected, ...]]
    gather: str = "index"    # 'index' | 'psum'

    @property
    def physical(self) -> bool:
        return isinstance(self.shards, tuple)

    @property
    def num_shards(self) -> int:
        if self.physical:
            return len(self.shards)
        return self.shards.depth.shape[0]

    @property
    def shard_size(self) -> int:
        if self.physical:
            return self.shards[0].depth.shape[0]
        return self.shards.depth.shape[1]

    @property
    def valid(self) -> torch.Tensor:
        """(D, Ns) cull mask of the stacked form: reductions over it equal
        the flat ones (``proj_valid_count`` also counts a physical form)."""
        return self.shards.valid


FEATURE_GATHER_STRATEGIES = ("index", "psum", "flat")


def _bit_view(x: torch.Tensor):
    """``x`` as the integer view its bits are summed in (float32 as int32,
    bool as uint8), and the function that restores the dtype."""
    if x.dtype == torch.bool:
        return x.view(torch.uint8), (lambda v: v.view(torch.bool))
    return x.view(torch.int32), (lambda v: v.view(x.dtype))


def _gather_owner_sum(x: torch.Tensor, shard: torch.Tensor, local: torch.Tensor):
    """Owner-masked gather-and-sum over the shard axis, bit-exact.

    ``x``: (D, Ns, *F), float32 or bool like every Projected field;
    ``shard``/``local``: int64 indices of any shape. Each shard contributes
    its own rows where it owns the entry and zero bits elsewhere; the sum
    over shards runs on the raw bit patterns (float32 as int32, bool as
    uint8), so the one owner's bits come back verbatim: signed zeros and
    NaN payloads too.
    """
    view, restore = _bit_view(x)
    zero = torch.zeros((), dtype=view.dtype, device=x.device)
    parts = []
    for d in range(x.shape[0]):
        own = shard == d
        g = view[d][torch.where(own, local, 0)]
        parts.append(torch.where(own.reshape(own.shape + (1,) * (g.ndim - own.ndim)), g, zero))
    # Pin the accumulator: torch.sum of an integer tensor widens to int64.
    # Exactly one part is nonzero, so the same-width sum cannot overflow.
    return restore(torch.sum(torch.stack(parts), dim=0, dtype=view.dtype))


def _gather_parts(parts, name: str, shard: torch.Tensor, local: torch.Tensor, psum: bool):
    """The physical form of the owner gathers: field ``name`` of each part
    lives on its own device. The entry indices are copied to each part's
    device and gathered there, masked to the owner (on the bit view under
    ``psum``); the D contributions are copied to the indices' device (the
    lane's lead device) and summed in the same integer width (``psum``) or
    selected by owner (``index``). Both give the owner's bits."""
    out_dev = shard.device
    idx_on: dict = {}
    contribs = []
    for d, part in enumerate(parts):
        x = getattr(part, name)
        dev = x.device
        if dev not in idx_on:
            idx_on[dev] = (shard.to(dev), local.to(dev))
        sh, lo = idx_on[dev]
        own = sh == d
        src, restore = _bit_view(x) if psum else (x, None)
        g = src[torch.where(own, lo, 0)]
        mask = own.reshape(own.shape + (1,) * (g.ndim - own.ndim))
        contribs.append(
            torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=dev)).to(out_dev))
    if psum:
        # Exactly one contribution is nonzero: the same-width sum is exact.
        return restore(torch.sum(torch.stack(contribs), dim=0, dtype=contribs[0].dtype))
    out = contribs[0]
    extra = (1,) * (out.ndim - shard.ndim)
    for d in range(1, len(contribs)):
        out = torch.where((shard == d).reshape(shard.shape + extra), contribs[d], out)
    return out


def proj_take(proj, name: str, idx: torch.Tensor) -> torch.Tensor:
    """Gather field ``name`` of a flat :class:`Projected` or a
    :class:`ShardedProjected` at global gaussian indices ``idx`` (any
    shape), on ``idx``'s device: the one gather every consumer (the
    reference bitmask and raster gathers, the kernels' feature packer) goes
    through, so the (shard, local) decomposition lives in one place.

    A field that requires grad is gathered by ``index_select`` (through the
    flat view of a contiguous ``(D, Ns)`` field), which gives the same
    values and whose backward is an index_add, parallel over the entries.
    The backward of ``field[idx]`` sorts the indices and walks each run of
    equal ones serially, and every padding entry of a bin table holds index
    0: a third of the paper frame's tile table."""
    idx = idx.long()
    if isinstance(proj, ShardedProjected):
        ns = proj.shard_size
        fields = ([getattr(p, name) for p in proj.shards] if proj.physical
                  else [getattr(proj.shards, name)])
        if proj.gather == "psum" and torch.is_grad_enabled() and any(
                f.requires_grad for f in fields):
            raise RuntimeError(
                "the psum feature gather is inference-only; train with "
                "feature_gather 'index' or 'flat'"
            )
        if proj.physical:
            return _gather_parts(proj.shards, name, idx // ns, idx % ns,
                                 psum=proj.gather == "psum")
        field = fields[0]
        if proj.gather == "psum":
            return _gather_owner_sum(field, idx // ns, idx % ns)
        if field.requires_grad:
            return _index_select(field.flatten(0, 1), idx)
        return field[idx // ns, idx % ns]
    field = getattr(proj, name)
    if field.requires_grad:
        return _index_select(field, idx)
    return field[idx]


def _index_select(field: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    flat = field.index_select(0, idx.reshape(-1))
    return flat.reshape(*idx.shape, *field.shape[1:])


def proj_valid_count(proj) -> torch.Tensor:
    """Visible-gaussian count for flat or sharded features (an exact integer
    reduction, so the shard-summed total equals the flat one). A physical
    layout counts each shard on its device and sums on shard 0's."""
    if isinstance(proj, ShardedProjected) and proj.physical:
        dev = proj.shards[0].valid.device
        return torch.sum(torch.stack([
            torch.sum(p.valid.to(torch.int64)).to(dev) for p in proj.shards]))
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


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), from exp of -|x| (nothing overflows, forward or
    backward). On the CPU ``torch.sigmoid`` runs a vectorised body and a
    scalar tail that round differently, so one logit gets different bits at
    different positions of a tensor; ``torch.exp`` does not."""
    e = torch.exp(torch.where(x >= 0, -x, x))
    return torch.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def project(scene: GaussianScene, cam: Camera) -> Projected:
    """The preprocessing stage: features + culling (paper Fig 1)."""
    dev = scene.means3d.device
    R = torch.as_tensor(cam.R, dtype=torch.float32, device=dev)
    t = torch.as_tensor(cam.t, dtype=torch.float32, device=dev)
    # The products below are written out (small_matmul, row_norm) and the
    # sigmoid is taken through exp, so that every row's features are the
    # same bits whatever the number of rows: a scene shard projects exactly
    # as the same rows of the whole scene.
    p_cam = small_matmul(scene.means3d, R.T) + t[None, :]  # (N, 3)
    x, y, z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]
    z_safe = torch.clamp(z, min=1e-6)

    mean2d = torch.stack(
        [cam.fx * x / z_safe + cam.cx, cam.fy * y / z_safe + cam.cy], dim=-1
    )

    # --- 2D covariance via the projective Jacobian (EWA splatting) ---
    cov3d = covariance3d(scene.log_scales, scene.quats)      # (N, 3, 3)
    cov3d_cam = small_matmul(small_matmul(R, cov3d), R.T)    # R Σ R^T
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
    cov2d_full = small_matmul(small_matmul(J, cov3d_cam), J.transpose(-1, -2))  # (N, 2, 2)
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
    dirs = dirs / (row_norm(dirs) + 1e-12)
    rgb = eval_sh(scene.sh, dirs)
    alpha = _sigmoid(scene.opacity)

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
