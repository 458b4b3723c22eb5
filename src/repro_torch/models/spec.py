"""Single source of truth for parameter shapes + logical sharding axes
(mirror of ``repro.models.spec``).

A ParamSpec tree (nested dicts of LeafSpec) is built once per model config;
it is consumed three ways, as in the JAX package:
  * init_from_spec(spec, generator)   -> real parameters (smoke runs, serving)
  * abstract_from_spec(spec)          -> tensors on the ``meta`` device
  * partition_from_spec(spec, rules)  -> PartitionSpec tree (mesh placement)
and ``params_from_numpy`` carries a parameter tree of the JAX package (its
leaves as numpy arrays) into the port bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.pspec import P
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    dtype: str = "bfloat16"
    init: str = "normal"              # normal | zeros | ones | small_normal
    fan_in: Optional[int] = None      # for scaled normal init

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_leaf(x) -> bool:
    return isinstance(x, LeafSpec)


def torch_dtype(name: str) -> torch.dtype:
    """A LeafSpec dtype name ('bfloat16', 'float32', ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def map_spec(fn, spec):
    """``spec`` with ``fn`` applied to every LeafSpec, in sorted key order
    (the order ``jax.tree.flatten`` gives a dict)."""
    if is_leaf(spec):
        return fn(spec)
    return {k: map_spec(fn, spec[k]) for k in sorted(spec)}


def init_from_spec(spec, generator: torch.Generator, device=None):
    """Parameters for ``spec`` on ``device`` (CUDA unless named): zeros, ones,
    or a normal scaled by 1/sqrt(fan_in) (0.1 times that for small_normal),
    drawn in float32 from ``generator`` and cast to the leaf's dtype. The
    draws are made on the generator's device, so a CUDA generator keeps a
    full-width model off the host. Not bitwise ``jax.random``'s values."""
    dev = resolve_device(device)

    def mk(leaf: LeafSpec):
        dt = torch_dtype(leaf.dtype)
        if leaf.init == "zeros":
            return torch.zeros(leaf.shape, dtype=dt, device=dev)
        if leaf.init == "ones":
            return torch.ones(leaf.shape, dtype=dt, device=dev)
        fan = leaf.fan_in or (leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1])
        scale = 1.0 / max(fan, 1) ** 0.5
        if leaf.init == "small_normal":
            scale *= 0.1
        x = torch.randn(leaf.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(scale).to(device=dev, dtype=dt)

    return map_spec(mk, spec)


def abstract_from_spec(spec):
    """Tensors of the spec's shapes and dtypes on the ``meta`` device."""
    return map_spec(
        lambda l: torch.empty(l.shape, dtype=torch_dtype(l.dtype), device="meta"), spec
    )


def partition_from_spec(spec, rules: Dict[str, Optional[object]]):
    """rules: logical axis name -> mesh axis (str/tuple) or None."""

    def leaf_spec(l: LeafSpec):
        return P(*[rules.get(a) if a is not None else None for a in l.axes])

    return map_spec(leaf_spec, spec)


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (the JAX package's parameters or cache through
    ``np.asarray``) as tensors on ``device``, bit for bit. A bfloat16 leaf
    (numpy dtype ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    crosses as its int16 bits."""
    dev = resolve_device(device)

    def one(a):
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(dev)

    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return one(tree)


def spec_bytes(spec) -> int:
    total = 0

    def add(l: LeafSpec):
        nonlocal total
        total += math.prod(l.shape) * torch_dtype(l.dtype).itemsize

    map_spec(add, spec)
    return total
