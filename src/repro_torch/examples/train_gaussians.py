"""End-to-end 3D-GS training on the port: optimize Gaussian parameters
against target renders, differentiating THROUGH the GS-TG pipeline (the
``reference`` backend, by torch autograd). Lossless GS-TG means training
through either pipeline is identical.

    PYTHONPATH=src python -m repro_torch.examples.train_gaussians [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_gaussians --device cpu

The scene, cameras, config and perturbation are those of the JAX package's
``examples/train_gaussians.py``; the numbers come from seeded torch
generators, so they are not the JAX example's.
"""
import argparse
import dataclasses

import torch

from repro_torch.core import make_camera, random_scene
from repro_torch.core.pipeline import RenderConfig, render
from repro_torch.core.train import SceneTrainConfig, fit_scene
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--gaussians", type=int, default=400)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # The SSIM filter is a convolution: keep it in float32 on the card.
    torch.backends.cudnn.allow_tf32 = False

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    target_scene = random_scene(args.gaussians, extent=2.5, generator=gen(0))
    cams = [
        make_camera((0.0, 1.0, 4.0), (0, 0, 0), 96, 96),
        make_camera((3.0, 1.0, 2.5), (0, 0, 0), 96, 96),
        make_camera((-3.0, 1.2, 2.5), (0, 0, 0), 96, 96),
    ]
    cfg = RenderConfig(tile=16, group=32, group_capacity=512, tile_capacity=512)
    with torch.no_grad():
        targets = [render(target_scene, c, cfg).image for c in cams]

    # start from a perturbed copy and recover the target scene
    means = target_scene.means3d
    sh = target_scene.sh
    init = dataclasses.replace(
        target_scene,
        means3d=means + 0.08 * torch.randn(means.shape, generator=gen(1), device=dev),
        opacity=target_scene.opacity - 1.0,
        sh=sh + 0.1 * torch.randn(sh.shape, generator=gen(2), device=dev),
    )
    tcfg = SceneTrainConfig(steps=args.steps)
    fitted, history = fit_scene(init, cams, targets, cfg, tcfg, log_every=25)
    for h in history:
        print(f"step {h['step']:4d}  loss={h['loss']:.5f}  psnr={h['psnr']:.2f}dB")
    print(f"\nPSNR {history[0]['psnr']:.2f} -> {history[-1]['psnr']:.2f} dB ({dev})")
    return history


if __name__ == "__main__":
    main()
