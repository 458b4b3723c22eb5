"""Gaussian scene container + synthetic scene generation
(mirror of ``repro.core.gaussians``).

A scene holds the 3D-GS parameterization, all float32 tensors on one device:
    means3d   (N, 3)   world-space centers
    log_scales(N, 3)   per-axis log std-dev
    quats     (N, 4)   rotation quaternions (unnormalized; normalized on use)
    opacity   (N,)     pre-sigmoid opacity logits
    sh        (N, K, 3) spherical-harmonics color coefficients (K = (deg+1)^2)
"""
from __future__ import annotations

import dataclasses
import zlib
from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.gs_scenes import PAPER_SCENES
from repro_torch.utils import resolve_device

SH_C0 = 0.28209479177387814  # Y_0^0

SCENE_FIELDS = ("means3d", "log_scales", "quats", "opacity", "sh")


@dataclasses.dataclass
class GaussianScene:
    means3d: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity: torch.Tensor
    sh: torch.Tensor

    @property
    def num_gaussians(self) -> int:
        return self.means3d.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1

    @property
    def device(self) -> torch.device:
        return self.means3d.device

    def to(self, device) -> "GaussianScene":
        return GaussianScene(
            **{f: getattr(self, f).to(device) for f in SCENE_FIELDS}
        )


def scene_from_numpy(arrays, device) -> GaussianScene:
    """Scene in the JAX field layout -> port scene on ``device``.

    ``arrays`` is a mapping of the five field names to arrays, or any object
    with those attributes (a ``repro`` GaussianScene converts directly
    through numpy)."""
    get = arrays.__getitem__ if isinstance(arrays, Mapping) else (
        lambda name: getattr(arrays, name)
    )
    dev = torch.device(device)
    return GaussianScene(**{
        f: torch.as_tensor(np.array(get(f), dtype=np.float32), device=dev)
        for f in SCENE_FIELDS
    })


def scene_to_numpy(scene: GaussianScene) -> Dict[str, np.ndarray]:
    """Port scene -> dict of float32 numpy arrays in the JAX field layout."""
    return {
        f: getattr(scene, f).detach().cpu().numpy().astype(np.float32)
        for f in SCENE_FIELDS
    }


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the degree-0 SH color decode (3D-GS convention)."""
    return (rgb - 0.5) / SH_C0


def sh0_to_rgb(sh0: torch.Tensor) -> torch.Tensor:
    return sh0 * SH_C0 + 0.5


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a (..., m, k) and b (..., k, p) with a small k: k
    broadcast products added in the order 0, 1, .., k - 1. Each output
    element is then the same sum whatever the leading sizes are, on every
    device. A library matmul picks its kernel, and with it the order of its
    sum, by the shapes: a shard's rows could round unlike the same rows of
    the whole scene (``core/pipeline.py``, scene sharding)."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def row_norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (kept, size 1), its squares added
    in order, for the reason :func:`small_matmul` gives."""
    sq = v[..., 0:1] * v[..., 0:1]
    for i in range(1, v.shape[-1]):
        sq = sq + v[..., i:i + 1] * v[..., i:i + 1]
    return torch.sqrt(sq)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3, 3) rotation matrix."""
    q = q / (row_norm(q) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    rows = [
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def covariance3d(log_scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T, (N, 3, 3)."""
    R = quat_to_rotmat(quats)
    S = torch.exp(log_scales)
    M = R * S[..., None, :]  # R @ diag(S)
    return small_matmul(M, M.transpose(-1, -2))


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def random_scene(
    num_gaussians: int,
    extent: float = 4.0,
    scale_range=(-4.6, -1.9),
    opacity_range=(-4.5, 3.5),
    sh_degree: int = 0,
    cluster: bool = True,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> GaussianScene:
    """Synthetic scene with clustered Gaussians. Same distribution as
    ``repro.core.gaussians.random_scene``, not the same numbers: tests carry
    scenes across with ``scene_from_numpy``.

    The scene is made on ``generator``'s device; without one, on ``device``
    (CUDA by default) from a generator seeded with 0.
    """
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(0)
    elif device is not None and torch.device(device).type != generator.device.type:
        raise ValueError(
            f"device={device!r} disagrees with the generator's "
            f"{generator.device}"
        )
    g = generator
    n = num_gaussians
    if cluster:
        n_clusters = max(1, n // 64)
        centers = _uniform(g, (n_clusters, 3), -extent, extent)
        assign = torch.randint(0, n_clusters, (n,), generator=g, device=g.device)
        jitter = torch.randn((n, 3), generator=g, device=g.device) * (extent * 0.08)
        means = centers[assign] + jitter
    else:
        means = _uniform(g, (n, 3), -extent, extent)
    log_scales = _uniform(g, (n, 3), scale_range[0], scale_range[1])
    quats = torch.randn((n, 4), generator=g, device=g.device)
    opacity = _uniform(g, (n,), opacity_range[0], opacity_range[1])
    n_sh = (sh_degree + 1) ** 2
    rgb = _uniform(g, (n, 3), 0.05, 0.95)
    sh = torch.zeros((n, n_sh, 3), device=g.device)
    sh[:, 0, :] = rgb_to_sh0(rgb)
    if n_sh > 1:
        sh[:, 1:, :] = 0.1 * torch.randn(
            (n, n_sh - 1, 3), generator=g, device=g.device
        )
    return GaussianScene(
        means3d=means.float(),
        log_scales=log_scales.float(),
        quats=quats.float(),
        opacity=opacity.float(),
        sh=sh.float(),
    )


def scene_like_paper(
    name: str,
    num_gaussians: Optional[int] = None,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> GaussianScene:
    """Synthetic stand-in scaled to the paper's six evaluation scenes.

    Without a ``generator`` the scene is seeded from the crc32 of its name
    (as the JAX benchmarks seed theirs) on ``device`` (CUDA by default).
    """
    spec = PAPER_SCENES[name]
    n = num_gaussians if num_gaussians is not None else spec.synthetic_gaussians
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(zlib.crc32(name.encode()) % 2**31)
    return random_scene(n, extent=spec.extent, cluster=True, generator=generator)
