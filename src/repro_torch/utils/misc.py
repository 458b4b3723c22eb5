"""Small shared utilities (mirror of ``repro.utils.misc``)."""
from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def wide_count_sum(values: torch.Tensor) -> torch.Tensor:
    """Overflow-safe counter sum: int64, exact for every count the renderer
    produces. (The JAX package accumulates in float32 when x64 is off, which
    is exact only below 2**24; compare the two by value.)"""
    return torch.sum(values.to(torch.int64))
