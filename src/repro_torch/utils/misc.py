"""Small shared utilities (mirror of ``repro.utils.misc``)."""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Optional, Tuple

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


def pytree_count(tree) -> int:
    """Total number of elements of the tensors in ``tree``."""
    return sum(t.numel() for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


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


def tree_map(fn, tree, *rest):
    """``tree`` with ``fn`` applied to every tensor: a tensor, or a
    dataclass, mapping, list or tuple (named ones too) of them, nested.
    Other leaves (a shard count, a name) are kept as they are. With
    ``rest``, trees of the same structure, ``fn`` takes each tensor of
    ``tree`` and the values at the same place in the others (a leaf of
    ``tree`` may face any value there, a learning rate say)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree


@torch.no_grad()
def tree_copy(tree):
    """``tree`` with every tensor copied, contiguous and outside autograd:
    the functional optimizer forms run their in-place forms on such a copy."""
    return tree_map(lambda x: x.clone(memory_format=torch.contiguous_format), tree)


def _children(tree) -> Optional[Tuple[list, Any]]:
    """(children in jax's order, a rebuild function), or None for a leaf."""
    if tree is None:
        return [], lambda xs: None
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda xs: type(tree)(zip(keys, xs))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):       # NamedTuple
        return list(tree), lambda xs: type(tree)(*xs)
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda xs: type(tree)(xs)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return ([getattr(tree, n) for n in names],
                lambda xs: dataclasses.replace(tree, **dict(zip(names, xs))))
    return None


def tree_flatten(tree) -> Tuple[list, str]:
    """The leaves of ``tree`` in jax's order, and a description of its
    structure (the manifest's ``treedef``)."""
    leaves: list = []

    def walk(node) -> str:
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            return "*"
        if node is None:
            return "None"
        parts = [walk(c) for c in kids[0]]
        if isinstance(node, Mapping):
            parts = [f"{k!r}: {p}" for k, p in zip(sorted(node), parts)]
            return "{" + ", ".join(parts) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(parts) + "]"
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return "(" + ", ".join(parts) + ")"
        return f"{type(node).__name__}(" + ", ".join(parts) + ")"

    desc = walk(tree)
    return leaves, f"PyTreeDef({desc})"


def tree_unflatten(tree, leaves) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` (in jax's order)."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        children, rebuild = kids
        return rebuild([build(c) for c in children])

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


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
