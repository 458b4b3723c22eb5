"""3D-GS scene optimization (mirror of ``repro.core.train``).

Optimizes Gaussian parameters against target images with AdamW: the
standard 3D-GS training loop (L1 + D-SSIM loss), differentiated by torch
autograd through ``core.pipeline.render`` on the ``reference`` backend (the
sorting order treated as constant, as in the reference implementation). The
``cuda`` backend's hand kernels record no gradient and refuse to train.
Lossless GS-TG means training through either pipeline is identical; gstg is
the default.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import SCENE_FIELDS, GaussianScene
from repro_torch.core.metrics import dssim, psnr
from repro_torch.core.pipeline import RenderConfig, render
from repro_torch.optim.adamw import adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class SceneTrainConfig:
    lr_means: float = 1.6e-3
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_sh: float = 2.5e-3
    lambda_dssim: float = 0.2
    steps: int = 200


def scene_loss(scene: GaussianScene, cam: Camera, target, cfg: RenderConfig, lam: float):
    """(loss, image): (1 - lam) * L1 + lam * D-SSIM of the render."""
    img = render(scene, cam, cfg).image
    l1 = torch.mean(torch.abs(img - target))
    return (1.0 - lam) * l1 + lam * dssim(img, target), img


def trainable(scene: GaussianScene) -> GaussianScene:
    """The scene with each field a fresh leaf that requires grad."""
    return GaussianScene(**{
        f: getattr(scene, f).detach().requires_grad_(True) for f in SCENE_FIELDS
    })


def make_train_step(cam: Camera, cfg: RenderConfig, tcfg: SceneTrainConfig):
    """A step ``(scene, opt_state, target, i) -> (scene, opt_state, loss,
    psnr)``: the loss and its gradients by autograd, then one AdamW update
    with a learning rate per parameter group."""
    lrs = GaussianScene(
        means3d=tcfg.lr_means,
        log_scales=tcfg.lr_scales,
        quats=tcfg.lr_quats,
        opacity=tcfg.lr_opacity,
        sh=tcfg.lr_sh,
    )

    def step(scene: GaussianScene, opt_state, target, i):
        leaves = trainable(scene)
        with torch.enable_grad():
            loss, img = scene_loss(leaves, cam, target, cfg, tcfg.lambda_dssim)
            grads = torch.autograd.grad(loss, [getattr(leaves, f) for f in SCENE_FIELDS])
        with torch.no_grad():
            grads = GaussianScene(**dict(zip(SCENE_FIELDS, grads)))
            scene, opt_state = adamw_update(
                leaves, grads, opt_state, i, lr=lrs, weight_decay=0.0
            )
            return scene, opt_state, loss.detach(), psnr(img, target)

    return step


def fit_scene(
    scene: GaussianScene,
    cams: List[Camera],
    targets: List[torch.Tensor],
    cfg: RenderConfig,
    tcfg: SceneTrainConfig,
    log_every: int = 50,
) -> Tuple[GaussianScene, List[dict]]:
    """Optimize scene params against (camera, target image) pairs."""
    opt_state = adamw_init(scene)
    history = []
    steps = [make_train_step(cam, cfg, tcfg) for cam in cams]
    for i in range(tcfg.steps):
        vi = i % len(cams)
        scene, opt_state, loss, p = steps[vi](scene, opt_state, targets[vi], i)
        if i % log_every == 0 or i == tcfg.steps - 1:
            history.append({"step": i, "loss": float(loss), "psnr": float(p)})
    return scene, history
