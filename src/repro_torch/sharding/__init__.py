"""The canonical scene-sharded layout and the render partition specs
(mirror of ``repro.sharding``).

Lazy re-exports, so importing ``repro_torch.sharding`` loads no render
code. Of the JAX package's ``policies`` the render specs and placement are
ported; the LM's sharding rules come with ROADMAP queue 1, item 13.
"""

_LAZY = {
    "ShardedScene": "repro_torch.sharding.scene",
    "shard_scene": "repro_torch.sharding.scene",
    "shard_scene_host": "repro_torch.sharding.scene",
    "scene_flat": "repro_torch.sharding.scene",
    "unshard_scene": "repro_torch.sharding.scene",
    "PartitionSpec": "repro_torch.sharding.policies",
    "Placement": "repro_torch.sharding.policies",
    "place": "repro_torch.sharding.policies",
    "camera_batch_pspec": "repro_torch.sharding.policies",
    "data_extent": "repro_torch.sharding.policies",
    "render_replicated_pspec": "repro_torch.sharding.policies",
    "scene_shard_pspec": "repro_torch.sharding.policies",
    "feature_shard_pspec": "repro_torch.sharding.policies",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
