"""The paper's six evaluation scenes (Table II) + synthetic stand-in specs
(copy of ``repro.configs.gs_scenes``: pure data), and ``scene_and_camera``,
a scene's stand-in with its eval camera.

Pretrained 3D-GS-30k checkpoints are not available offline; the synthetic
generator reproduces the statistics the paper's effect depends on (Gaussian
count scale, clustering, screen footprint). Resolutions are the paper's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    name: str
    dataset: str
    width: int
    height: int
    kind: str                  # indoor | outdoor
    paper_gaussians: int       # approximate published 3D-GS-30k model size
    synthetic_gaussians: int   # scaled-down stand-in used on CPU
    extent: float              # world extent of the synthetic stand-in


PAPER_SCENES: Dict[str, SceneSpec] = {
    "train": SceneSpec("train", "Tanks&Temples", 1959, 1090, "outdoor",
                       1_026_000, 24_000, 5.0),
    "truck": SceneSpec("truck", "Tanks&Temples", 1957, 1091, "outdoor",
                       2_541_000, 24_000, 5.0),
    "drjohnson": SceneSpec("drjohnson", "DeepBlending", 1332, 876, "indoor",
                           3_278_000, 20_000, 4.0),
    "playroom": SceneSpec("playroom", "DeepBlending", 1264, 832, "indoor",
                          2_343_000, 20_000, 4.0),
    "rubble": SceneSpec("rubble", "Mill-19", 4608, 3456, "outdoor",
                        9_060_000, 32_000, 8.0),
    "residence": SceneSpec("residence", "UrbanScene3D", 5472, 3648, "outdoor",
                           5_950_000, 32_000, 8.0),
}

# Evaluation renders on CPU use tile-aligned reduced resolutions that keep the
# scenes' aspect ratios; the cost model then scales op counts by the pixel and
# Gaussian ratios to project to paper scale.
EVAL_RESOLUTION: Dict[str, tuple] = {
    "train": (512, 288),
    "truck": (512, 288),
    "drjohnson": (384, 256),
    "playroom": (384, 256),
    "rubble": (640, 480),
    "residence": (640, 448),
}


def scene_and_camera(name: str, n_gaussians=None, width=None, height=None, *, device=None):
    """A paper scene's synthetic stand-in and its eval camera (the port's
    copy of ``benchmarks/common.py::scene_and_camera``): the scene seeded
    from the crc32 of its name (``core/gaussians.py::scene_like_paper``) on
    ``device`` (CUDA by default), the camera at ``(0, 0.35 extent, 1.5
    extent)`` looking at the origin with a 62 degree horizontal field of
    view. ``width``/``height`` override the eval resolution."""
    from repro_torch.core.camera import make_camera
    from repro_torch.core.gaussians import scene_like_paper

    spec = PAPER_SCENES[name]
    w, h = EVAL_RESOLUTION[name]
    scene = scene_like_paper(name, n_gaussians, device=device)
    cam = make_camera(
        (0.0, spec.extent * 0.35, spec.extent * 1.5), (0, 0, 0),
        width or w, height or h, fov_x_deg=62.0,
    )
    return scene, cam
