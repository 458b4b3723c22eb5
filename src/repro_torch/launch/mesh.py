"""Render-mesh policy (mirror of ``repro.launch.mesh``).

Only the pure shard-count policy is ported. Building a mesh over several
cards (``make_render_mesh``) comes with multi-GPU sharding (ROADMAP queue 1,
item 8); until then a sharded commit keeps its shard axis logical on one
device.
"""
from __future__ import annotations


def render_mesh_shards(n_devices: int, scene_shards: int) -> int:
    """The physical shard count a render mesh over ``n_devices`` can
    realize: ``scene_shards`` when it divides the device count, else 1 (the
    shard axis stays logical: the same results, no per-device memory
    saving)."""
    if scene_shards > 1 and n_devices % scene_shards == 0:
        return scene_shards
    return 1
