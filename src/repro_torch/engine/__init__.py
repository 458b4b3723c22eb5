"""The session-style rendering engine: ``engine.open(scene, cfg)``."""
from repro_torch.engine.handle import Renderer, open

__all__ = ["Renderer", "open"]
