"""Image quality metrics: PSNR and SSIM (mirror of ``repro.core.metrics``).

Images are (H, W, C) float tensors in [0, data_range]. On a CUDA card the
SSIM filter is a cuDNN convolution, which runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; the training example and the
chip smoke run set it False, so the card computes in float32 as the JAX
package does.
"""
from __future__ import annotations

import torch


def psnr(img: torch.Tensor, ref: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(
    img: torch.Tensor,
    ref: torch.Tensor,
    data_range: float = 1.0,
    size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM over channels, with an 11x11 Gaussian window (sigma 1.5)
    and VALID borders."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_kernel(size, sigma, img.device)[None, None]  # (1, 1, s, s)

    def filt(x):  # (H, W, C) -> VALID correlation per channel
        out = torch.nn.functional.conv2d(x.permute(2, 0, 1)[:, None], win)  # (C, 1, h, w)
        return out[:, 0].permute(1, 2, 0)

    mu_x = filt(img)
    mu_y = filt(ref)
    xx = filt(img * img) - mu_x * mu_x
    yy = filt(ref * ref) - mu_y * mu_y
    xy = filt(img * ref) - mu_x * mu_y
    s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / (
        (mu_x**2 + mu_y**2 + c1) * (xx + yy + c2)
    )
    return torch.mean(s)


def dssim(img: torch.Tensor, ref: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    return (1.0 - ssim(img, ref, data_range)) / 2.0
