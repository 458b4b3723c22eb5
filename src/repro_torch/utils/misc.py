"""Small shared utilities (mirror of ``repro.utils.misc``)."""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

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


def pytree_bytes(tree) -> int:
    """Total bytes of the tensors in ``tree``: a tensor, or a dataclass,
    mapping, list or tuple of them (nested), at their declared dtypes."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, Mapping):
        items = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        items = list(tree)
    else:
        return 0
    return sum(pytree_bytes(x) for x in items)


def not_ported(name: str, item: str):
    """A stand-in for an entry point of the JAX package that the port has
    not taken over yet: it raises, naming ROADMAP queue 1's ``item``."""

    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP queue 1, item {item})")

    fn.__name__ = fn.__qualname__ = name
    return fn
