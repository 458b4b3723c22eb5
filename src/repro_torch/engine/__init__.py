"""The session-style rendering engine: ``engine.open(scene, cfg)`` returns a
``Renderer`` handle with ``.render``, ``.render_batch``, the futures-based
``.submit``, ``.open_stream`` (a ``StreamRenderer`` session), ``.stats``
and context-manager ``.close``."""
from repro_torch.engine.handle import (
    Renderer,
    close_default_renderers,
    default_renderer,
    open,
)
from repro_torch.engine.stream import StreamRenderer, pose_key, predict_next_camera

__all__ = [
    "Renderer",
    "StreamRenderer",
    "close_default_renderers",
    "default_renderer",
    "open",
    "pose_key",
    "predict_next_camera",
]
