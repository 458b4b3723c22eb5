"""``PartitionSpec``: the port's counterpart of ``jax.sharding.PartitionSpec``.

A module with no imports of the port, so that the model layer
(``models/spec.py``) and the placement layer (``sharding/policies.py``)
both read specs from it without the placement code or ``launch/``.
"""
from __future__ import annotations

from typing import Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """``PartitionSpec('model')`` is ``('model',)``; ``PartitionSpec()`` is
    the replicated spec ``()``; equal, as tuples, to the JAX spec of the
    same axes (a one-axis tuple entry reads as that axis, as in JAX)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec
