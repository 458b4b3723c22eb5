"""The session-style rendering engine: ``engine.open(scene, cfg)`` returns a
``Renderer`` handle with ``.render``, ``.render_batch``, the futures-based
``.submit``, ``.stats`` and context-manager ``.close``."""
from repro_torch.engine.handle import (
    Renderer,
    close_default_renderers,
    default_renderer,
    open,
)

__all__ = ["Renderer", "close_default_renderers", "default_renderer", "open"]
