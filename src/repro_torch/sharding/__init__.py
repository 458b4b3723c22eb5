"""The canonical scene-sharded layout (mirror of ``repro.sharding``).

Lazy re-exports, so importing ``repro_torch.sharding`` loads no render
code. The JAX package's ``policies`` (mesh partition specs and the LM's
sharding rules) are not ported yet: the render specs come with multi-GPU
sharding (ROADMAP queue 1, item 8), the LM rules with item 13.
"""

_LAZY = {
    "ShardedScene": "repro_torch.sharding.scene",
    "shard_scene": "repro_torch.sharding.scene",
    "shard_scene_host": "repro_torch.sharding.scene",
    "scene_flat": "repro_torch.sharding.scene",
    "unshard_scene": "repro_torch.sharding.scene",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
