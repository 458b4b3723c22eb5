"""The session-style rendering handle (mirror of the synchronous core of
``repro.engine.handle``).

``engine.open(scene, cfg)`` commits the scene to the device once and returns
a :class:`Renderer` with ``.render(cam)``, ``.close()`` and the
context-manager protocol. The rest of the JAX handle (``render_batch``,
``submit``, ``stats``, autotune, residency, meshes) is not ported yet
(ROADMAP queue 1, item 6) and raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.pipeline import RenderConfig, RenderResult, check_config, render
from repro_torch.utils import resolve_device

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 6: engine handle)"


class Renderer:
    """A scene committed to one device under one RenderConfig."""

    def __init__(self, scene: GaussianScene, cfg: RenderConfig, device=None):
        check_config(cfg)
        self._device = resolve_device(device)
        self._cfg = cfg
        self._scene: Optional[GaussianScene] = scene.to(self._device)

    def render(self, cam: Camera, background=None) -> RenderResult:
        """Render one camera against the committed scene."""
        if self._scene is None:
            raise RuntimeError("Renderer is closed")
        if background is not None:
            background = torch.as_tensor(background, dtype=torch.float32, device=self._device)
        with torch.inference_mode():
            return render(self._scene, cam, self._cfg, background)

    def render_batch(self, *args, **kwargs):
        raise NotImplementedError(f"Renderer.render_batch {_NOT_PORTED}")

    def submit(self, *args, **kwargs):
        raise NotImplementedError(f"Renderer.submit {_NOT_PORTED}")

    def stats(self):
        raise NotImplementedError(f"Renderer.stats {_NOT_PORTED}")

    def close(self) -> None:
        """Release the committed scene. Idempotent."""
        self._scene = None

    def __enter__(self) -> "Renderer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if self._scene is None else "open"
        return (
            f"<Renderer {state} mode={self._cfg.mode!r} "
            f"backend={self._cfg.backend!r} device={self._device}>"
        )


def open(  # noqa: A001 — the module-level session verb is the API
    scene: GaussianScene,
    cfg: RenderConfig,
    *,
    device=None,
    **unported,
) -> Renderer:
    """Commit ``(scene, cfg)`` to ``device`` (CUDA unless the caller names
    another; raises when CUDA is missing) and return the handle. The JAX
    handle's other options (meshes, budgets, autotune, residency) are not
    ported yet and raise."""
    if unported:
        raise NotImplementedError(f"open({', '.join(sorted(unported))}=...) {_NOT_PORTED}")
    return Renderer(scene, cfg, device=device)
