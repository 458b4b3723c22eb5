"""Pinhole camera model for 3D-GS rendering (mirror of ``repro.core.camera``).

World-to-camera extrinsics (R, t) with OpenCV conventions: +z looks into the
scene, x right, y down. Intrinsics are (fx, fy, cx, cy) in pixels.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera description. Arrays are small (3x3 / 3-vec) numpy values;
    the projection stage moves them to the scene's device."""

    R: np.ndarray          # (3, 3) world->camera rotation
    t: np.ndarray          # (3,)  world->camera translation
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    znear: float = 0.2
    zfar: float = 1000.0

    def resolution(self) -> Tuple[int, int]:
        return self.width, self.height


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Build world->camera (R, t) looking from ``eye`` toward ``target``."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, up)
    right = right / (np.linalg.norm(right) + 1e-12)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # rows = camera axes in world
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def make_camera(
    eye,
    target,
    width: int,
    height: int,
    fov_x_deg: float = 60.0,
    up=(0.0, 1.0, 0.0),
    znear: float = 0.2,
    zfar: float = 1000.0,
) -> Camera:
    R, t = look_at(eye, target, up)
    fx = 0.5 * width / np.tan(0.5 * np.deg2rad(fov_x_deg))
    fy = fx  # square pixels
    return Camera(
        R=R,
        t=t,
        fx=float(fx),
        fy=float(fy),
        cx=width / 2.0,
        cy=height / 2.0,
        width=int(width),
        height=int(height),
        znear=znear,
        zfar=zfar,
    )


def orbit_cameras(
    n: int,
    radius: float,
    width: int,
    height: int,
    elevation: float = 0.35,
    fov_x_deg: float = 60.0,
) -> list:
    """A ring of n cameras orbiting the origin — synthetic eval trajectory."""
    cams = []
    for i in range(n):
        ang = 2.0 * np.pi * i / max(n, 1)
        eye = (
            radius * np.cos(ang),
            radius * elevation,
            radius * np.sin(ang),
        )
        cams.append(make_camera(eye, (0.0, 0.0, 0.0), width, height, fov_x_deg))
    return cams


def world_to_cam(R: torch.Tensor, t: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """(N,3) world points -> camera frame."""
    return xyz @ R.T + t[None, :]
