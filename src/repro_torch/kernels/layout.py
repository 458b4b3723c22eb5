"""Shared feature layout for the GS-TG kernels (mirror of
``repro.kernels.layout``).

Kernels consume gathered per-bin Gaussian features in an SoA (feature-major)
layout (B, F, K_pad): F = 16 feature rows, K_pad entries padded to a
multiple of lcm(128, chunk) so every raster chunk size divides it. The
layout is the JAX package's, so packed blocks compare 1:1.
"""
from __future__ import annotations

import torch

from repro_torch.core.projection import proj_take
from repro_torch.utils import round_up

F_MEAN_X = 0
F_MEAN_Y = 1
F_CONIC_A = 2
F_CONIC_B = 3
F_CONIC_C = 4
F_OPACITY = 5   # 0 for invalid entries
F_RGB_R = 6
F_RGB_G = 7
F_RGB_B = 8
F_RADIUS = 9
F_EIGVEC_X = 10
F_EIGVEC_Y = 11
F_EIGVAL_1 = 12
F_EIGVAL_2 = 13
F_DEPTH = 14
F_VALID = 15
NUM_FEATURES = 16

LANE = 128

# (Projected field, channel) of each feature row except F_VALID.
_ROWS = (
    ("mean2d", 0), ("mean2d", 1),
    ("conic", 0), ("conic", 1), ("conic", 2),
    ("alpha", None),
    ("rgb", 0), ("rgb", 1), ("rgb", 2),
    ("radius", None),
    ("eigvec", 0), ("eigvec", 1),
    ("eigval", 0), ("eigval", 1),
    ("depth", None),
)


def pack_features(
    proj,
    gauss_idx: torch.Tensor,
    entry_valid: torch.Tensor,
    multiple: int = LANE,
) -> torch.Tensor:
    """Gather Projected fields into (B, NUM_FEATURES, K_pad) fp32 blocks.

    gauss_idx/entry_valid: (B, K). Invalid and padded entries are all zero,
    so their opacity (=> alpha) and valid flag are 0.
    """
    B, K = gauss_idx.shape
    K_pad = round_up(max(K, 1), max(int(multiple), 1))
    packed = torch.zeros(
        (B, NUM_FEATURES, K_pad), dtype=torch.float32, device=gauss_idx.device
    )
    fields = {}
    for row, (name, ch) in enumerate(_ROWS):
        if name not in fields:
            fields[name] = proj_take(proj, name, gauss_idx)
        v = fields[name] if ch is None else fields[name][..., ch]
        packed[:, row, :K] = torch.where(entry_valid, v, 0.0)
    packed[:, F_VALID, :K] = entry_valid.to(torch.float32)
    return packed
