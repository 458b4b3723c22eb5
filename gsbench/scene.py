"""The benchmark's inputs, made from ``--seed``: the synthetic scene and the
cameras of the orbit. Both sides (the program and the reference) get the
same tensors and cameras; nothing here imports the program.

The scene generator is a copy of the program's synthetic stand-in for the
paper's scenes (clustered gaussians, the same draws in the same order, so
``repro_torch.core.gaussians.scene_like_paper(name, n, generator=g)`` gives
the same tensors from a generator in the same state). No 3D-GS-30k
checkpoint is in the repository; the stand-in keeps the paper's gaussian
count, clustering and screen footprint.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from gsbench.reference.render import Camera

SH_C0 = 0.28209479177387814
SCENE_FIELDS = ("means3d", "log_scales", "quats", "opacity", "sh")


def generator(seed: int, salt: str, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``salt`` (the
    configuration's name): any whole number, negative or past 64 bits too."""
    digest = hashlib.sha256(f"{salt}:{int(seed)}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def synthetic_scene(n: int, extent: float, g: torch.Generator, *,
                    scale_range=(-4.6, -1.9), opacity_range=(-4.5, 3.5)) -> Dict[str, torch.Tensor]:
    """``n`` clustered gaussians on the generator's device, float32: ``n //
    64`` cluster centres uniform in the cube of half-side ``extent``, each
    gaussian a centre plus normal jitter of 0.08 ``extent``; log-scales and
    opacity logits uniform; random quaternions; degree-0 colour uniform in
    [0.05, 0.95]."""
    dev = g.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    centers = uniform((max(1, n // 64), 3), -extent, extent)
    assign = torch.randint(0, len(centers), (n,), generator=g, device=dev)
    jitter = torch.randn((n, 3), generator=g, device=dev) * (extent * 0.08)
    means = centers[assign] + jitter
    log_scales = uniform((n, 3), scale_range[0], scale_range[1])
    quats = torch.randn((n, 4), generator=g, device=dev)
    opacity = uniform((n,), opacity_range[0], opacity_range[1])
    rgb = uniform((n, 3), 0.05, 0.95)
    sh = ((rgb - 0.5) / SH_C0)[:, None, :]
    return {"means3d": means.float(), "log_scales": log_scales.float(),
            "quats": quats.float(), "opacity": opacity.float(), "sh": sh.float().contiguous()}


def scene_for(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's scene for this seed, made on ``device``."""
    return synthetic_scene(config["gaussians"], config["extent"],
                           generator(seed, config["name"], device))


def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """World to camera (R rows = camera x, y, z axes in the world; t)."""
    def sub(a, b):
        return [a[i] - b[i] for i in range(3)]

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]

    def unit(a):
        n = math.sqrt(sum(x * x for x in a)) + 1e-12
        return [x / n for x in a]

    fwd = unit(sub(target, eye))
    right = unit(cross(fwd, up))
    down = cross(fwd, right)
    R = (tuple(right), tuple(down), tuple(fwd))
    t = tuple(-sum(R[i][j] * eye[j] for j in range(3)) for i in range(3))
    return R, t


def orbit_camera(config: dict, azimuth_deg: float) -> Camera:
    """The configuration's eval camera turned by ``azimuth_deg`` about the
    vertical axis: the eye on the circle through (0, 0.35 extent, 1.5
    extent) times ``camera_scale`` (1 by default), looking at the origin,
    with a 62 degree horizontal field of view. Azimuth 0 with scale 1 is
    the program's eval camera (configs/gs_scenes.py::scene_and_camera)."""
    e = config["extent"] * config.get("camera_scale", 1.0)
    radius = math.hypot(0.35 * e, 1.5 * e)
    elev = math.atan2(0.35 * e, 1.5 * e)
    az = math.radians(azimuth_deg)
    eye = [radius * math.cos(elev) * math.sin(az), radius * math.sin(elev),
           radius * math.cos(elev) * math.cos(az)]
    R, t = look_at(eye)
    w, h = config["width"], config["height"]
    f = 0.5 * w / math.tan(0.5 * math.radians(config.get("fov_x_deg", 62.0)))
    return Camera(R=R, t=t, fx=f, fy=f, cx=w / 2.0, cy=h / 2.0, width=w, height=h)


def to_program(cam: Camera):
    """The same camera as the program's ``Camera`` (float32 pose arrays)."""
    import numpy as np
    from repro_torch.core.camera import Camera as ProgramCamera

    return ProgramCamera(R=np.asarray(cam.R, np.float32), t=np.asarray(cam.t, np.float32),
                         fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
                         width=int(cam.width), height=int(cam.height),
                         znear=float(cam.znear), zfar=float(cam.zfar))


def to_program_scene(scene: Dict[str, torch.Tensor]):
    """The scene tensors as the program's ``GaussianScene`` (no copy)."""
    from repro_torch.core.gaussians import GaussianScene

    return GaussianScene(**{f: scene[f] for f in SCENE_FIELDS})
