"""Render partition specs and placement over a :class:`RenderMesh` (mirror
of the render part of ``repro.sharding.policies``).

A spec is a :class:`PartitionSpec`, a tuple that reads like the JAX one:
per leading axis of an operand, the mesh axis (or axes) it lays over, and
``PartitionSpec()`` for a replicated operand. The five render specs hold
the JAX package's values.

:func:`place` stands in for ``jax.device_put(x, NamedSharding(mesh,
spec))``. One process drives the mesh, so what it returns is the operand
as each data row holds it, a tuple with one entry a row: a replicated
operand on the row's lead device, a ``ShardedScene`` under ``scene_shard_pspec`` with
shard ``d`` on the row's model column ``d``. Copies are made once per
distinct device: rows of a mesh of virtual devices share one copy.

The LM rules (``param_rules``, ``activation_rules``, ``make_constrain``,
``batch_specs``) are not ported yet (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.launch.mesh import RenderMesh
from repro_torch.utils import tree_map


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


def _data_axes(mesh: RenderMesh) -> Tuple[str, ...]:
    return ("data",)


def camera_batch_pspec(mesh: RenderMesh) -> PartitionSpec:
    """The camera-batch axis lays over the mesh's data axes: lanes go to
    the data rows contiguously. Pad batches to :func:`data_extent` first."""
    return P(_data_axes(mesh))


def data_extent(mesh: RenderMesh) -> int:
    """The number of camera lanes a render mesh provides: the product of
    its data-axis extents."""
    out = 1
    for a in _data_axes(mesh):
        out *= mesh.shape[a]
    return out


def render_replicated_pspec() -> PartitionSpec:
    """Fully replicated (the background, and a scene that is not
    sharded)."""
    return P()


def scene_shard_pspec(mesh: RenderMesh) -> PartitionSpec:
    """A ``ShardedScene``'s leading shard axis over the ``'model'`` axis;
    on a mesh without one the shard axis stays logical."""
    if "model" in mesh.axis_names:
        return P("model")
    return P()


def feature_shard_pspec(mesh: RenderMesh) -> PartitionSpec:
    """Per-camera projected features in the per-shard layout lay over
    ``'model'`` like the scene they come from: each device holds its own
    N/D feature rows (the budget model's 1/D feature term)."""
    return scene_shard_pspec(mesh)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where an operand goes: a mesh and a spec (``NamedSharding``)."""

    mesh: RenderMesh
    spec: PartitionSpec

    @property
    def has_cuda(self) -> bool:
        return "cuda" in self.mesh.device_types


def place(tree, mesh: RenderMesh, spec: PartitionSpec) -> Tuple[Any, ...]:
    """Copy ``tree`` to the mesh as ``spec`` lays it out (see the module
    docstring): entry ``r`` is the operand as data row ``r`` holds it (its
    lanes render against it). Under ``P('model')`` a ``ShardedScene`` whose shard count
    equals the model extent is split physically, shard ``d`` to column
    ``d``; with a model extent of 1 its shards stay logical on the lead
    device. Any other tree, or spec ``P()``, is replicated to each row's
    lead device."""
    from repro_torch.sharding.scene import ShardedScene

    copies: Dict[tuple, Any] = {}

    def to(key, x, device):
        k = (key, device)
        if k not in copies:
            copies[k] = tree_map(lambda t: t.to(device), x)
        return copies[k]

    rows = []
    physical = tuple(spec) == ("model",) and isinstance(tree, ShardedScene)
    if physical and mesh.columns not in (1, tree.num_shards):
        raise ValueError(
            f"a scene of {tree.num_shards} shards cannot lay over a model axis "
            f"of {mesh.columns}"
        )
    for r in range(mesh.rows):
        if physical and mesh.columns == tree.num_shards > 1:
            parts = tuple(to(("shard", d), tree.shard(d), mesh.grid[r][d])
                          for d in range(tree.num_shards))
            rows.append(ShardedScene(shards=parts, num_real=tree.num_real))
        else:
            rows.append(to("whole", tree, mesh.lead(r)))
    return tuple(rows)
