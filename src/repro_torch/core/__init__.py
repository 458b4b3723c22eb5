from repro_torch.core.camera import Camera, make_camera, orbit_cameras
from repro_torch.core.gaussians import (
    GaussianScene,
    random_scene,
    scene_from_numpy,
    scene_like_paper,
    scene_to_numpy,
)
from repro_torch.core.grouping import GridSpec
from repro_torch.core.pipeline import (
    CameraBatch,
    FrontendResult,
    RenderConfig,
    RenderResult,
    RenderStats,
    render,
    render_backend,
    render_batch,
    render_frontend,
)
from repro_torch.core.projection import Projected, project
from repro_torch.core.stages import Backend, get_backend, register_backend

__all__ = [
    "Camera",
    "make_camera",
    "orbit_cameras",
    "GaussianScene",
    "random_scene",
    "scene_from_numpy",
    "scene_like_paper",
    "scene_to_numpy",
    "GridSpec",
    "CameraBatch",
    "FrontendResult",
    "RenderConfig",
    "RenderResult",
    "RenderStats",
    "render",
    "render_backend",
    "render_batch",
    "render_frontend",
    "Projected",
    "project",
    "Backend",
    "get_backend",
    "register_backend",
]
