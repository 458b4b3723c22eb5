"""GS-TG renderer ported to PyTorch + hand-written CUDA kernels for Hopper.

Mirrors the module layout of the JAX package ``repro`` (the reference the
port is tested against) and imports nothing from it. Entry points run on
CUDA unless the caller names another device::

    from repro_torch import engine
    from repro_torch.core import RenderConfig, make_camera, scene_like_paper

    scene = scene_like_paper("train", 1_026_000)
    with engine.open(scene, RenderConfig(backend="cuda")) as r:
        out = r.render(cam)
"""
