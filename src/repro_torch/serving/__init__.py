"""Render serving: queue -> bucketing -> dispatch through engine handles.

``queue``, ``bucketing`` and ``stats`` are copies of the JAX package's
pure-Python modules (DESIGN.md §9): importing them touches no device. The
engine handle's futures front-end is built on them. ``sharded`` (batch
padding and the scene-layout cache) and ``server`` (``RenderServer``, a
multi-scene dispatch loop over shared handles with residency paging and
stream sessions) touch tensors and are re-exported lazily, so importing
``repro_torch.serving`` imports no torch and initialises no device.
"""
from repro_torch.serving.bucketing import (
    Bucket,
    BucketingScheduler,
    pad_indices,
    pad_indices_to,
    padded_size,
)
from repro_torch.serving.queue import QueueClosed, QueueFull, RenderRequest, RequestQueue
from repro_torch.serving.stats import BucketStats, ServingStats, cache_delta, percentile

_LAZY = {
    **{name: "repro_torch.serving.sharded"
       for name in ("acquire_scene_layout", "evict_scene_layouts", "pad_camera_batch",
                    "release_scene_layout", "shard_scene_cached")},
    **{name: "repro_torch.serving.server"
       for name in ("RenderServer", "RequestResult", "poisson_arrivals")},
}

__all__ = [
    "Bucket",
    "BucketStats",
    "BucketingScheduler",
    "QueueClosed",
    "QueueFull",
    "RenderRequest",
    "RequestQueue",
    "ServingStats",
    "cache_delta",
    "pad_indices",
    "pad_indices_to",
    "padded_size",
    "percentile",
    *sorted(_LAZY),
]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
