"""Scene configurations of the port (the LM configs of ``repro.configs`` are
not ported yet)."""
from repro_torch.configs.gs_scenes import (
    EVAL_RESOLUTION,
    PAPER_SCENES,
    SceneSpec,
    scene_and_camera,
)

__all__ = ["EVAL_RESOLUTION", "PAPER_SCENES", "SceneSpec", "scene_and_camera"]
