"""Small shared utilities (mirror of ``repro.utils.misc``)."""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Optional

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


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every tensor: a tensor, or a
    dataclass, mapping, list or tuple of them (nested). Other leaves (a
    shard count, a name) are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)
        })
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def tree_devices(tree) -> list:
    """The distinct devices of the tensors in ``tree`` (a tensor, or a
    dataclass, list or tuple of them, nested), in the order first met."""
    if isinstance(tree, torch.Tensor):
        return [tree.device]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(tree)
    else:
        return []
    out = []
    for x in items:
        for dev in tree_devices(x):
            if dev not in out:
                out.append(dev)
    return out


def tree_device(tree) -> Optional[torch.device]:
    """The device of the first tensor in ``tree`` (a tensor, or a dataclass,
    list or tuple of them, nested), or None when it holds no tensor."""
    devs = tree_devices(tree)
    return devs[0] if devs else None


def fence(tree) -> None:
    """Wait for the work queued on every CUDA device that ``tree``'s
    tensors live on. On the CPU there is nothing to wait for: ops run
    eagerly."""
    for dev in tree_devices(tree):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
