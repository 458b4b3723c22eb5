"""Render-serving primitives: queue -> bucketing, and batch padding.

``queue`` and ``bucketing`` are copies of the JAX package's pure-Python
modules (DESIGN.md §9): importing them touches no device. The engine
handle's futures front-end is built on them. ``pad_camera_batch`` touches
tensors and is re-exported lazily. The server, its stats and the
scene-sharded layout cache are not ported yet (ROADMAP queue 1, items 8
and 10).
"""
from repro_torch.serving.bucketing import (
    Bucket,
    BucketingScheduler,
    pad_indices,
    pad_indices_to,
    padded_size,
)
from repro_torch.serving.queue import QueueClosed, QueueFull, RenderRequest, RequestQueue

_LAZY = {"pad_camera_batch": "repro_torch.serving.sharded"}

__all__ = [
    "Bucket",
    "BucketingScheduler",
    "QueueClosed",
    "QueueFull",
    "RenderRequest",
    "RequestQueue",
    "pad_indices",
    "pad_indices_to",
    "padded_size",
    *sorted(_LAZY),
]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
