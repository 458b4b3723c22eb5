"""Synthetic Gaussian scenes + camera trajectories for renderer benchmarks
(mirror of ``repro.data.scenes``). The scene comes from the port's
``random_scene`` and a ``torch.Generator`` seeded with ``seed``: the JAX
package's distribution, not its numbers."""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.camera import Camera, orbit_cameras
from repro_torch.core.gaussians import GaussianScene, random_scene
from repro_torch.utils import resolve_device


def synthetic_scene_and_views(
    seed: int,
    num_gaussians: int,
    width: int,
    height: int,
    n_views: int = 4,
    extent: float = 4.0,
    device=None,
) -> Tuple[GaussianScene, List[Camera]]:
    """A random scene on ``device`` (CUDA unless named) and ``n_views``
    cameras orbiting it."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    scene = random_scene(num_gaussians, extent=extent, generator=gen)
    cams = orbit_cameras(n_views, radius=extent * 1.6, width=width, height=height)
    return scene, cams
