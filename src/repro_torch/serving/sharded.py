"""Serving-side scene staging (mirror of ``repro.serving.sharded``).

  * ``pad_camera_batch`` — the ragged-batch padding built on the
    ``pad_indices_to`` policy: the padded tail replicates the last camera
    and is sliced off after the dispatch (DESIGN.md §9);
  * the scene-layout cache (``shard_scene_cached``): the host-staged
    padded/sharded layout per (scene identity, D), registered as
    ``"scene_layout"`` with ``core.pipeline.register_render_cache`` so
    ``render_cache_clear()``/``render_cache_info()`` cover it. Engine
    handles hold layouts through the refcounted
    ``acquire_scene_layout``/``release_scene_layout`` pair (a layout frees
    when its last handle closes, never under another open handle), and
    ``evict_scene_layouts`` drops a scene's unreferenced layouts.

The deprecated ``render_batch_sharded`` raises (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.pipeline import CameraBatch, register_render_cache
from repro_torch.serving.bucketing import pad_indices_to
from repro_torch.sharding.scene import ShardedScene, shard_scene_host
from repro_torch.utils.misc import not_ported


def pad_camera_batch(batch: CameraBatch, target: int) -> CameraBatch:
    """Pad the batch axis up to ``target`` lanes by replicating the last
    camera (the ``pad_indices_to`` policy); identity when already there."""
    n = len(batch)
    idx = pad_indices_to(n, target)
    if len(idx) == n:
        return batch
    take = torch.as_tensor(idx, dtype=torch.int64, device=batch.R.device)
    return dataclasses.replace(
        batch,
        R=batch.R[take],
        t=batch.t[take],
        fx=batch.fx[take],
        fy=batch.fy[take],
        cx=batch.cx[take],
        cy=batch.cy[take],
    )


# ---------------------------------------------------------------------------
# Scene-layout cache (registered with the engine's cache registry)
# ---------------------------------------------------------------------------

_LAYOUT_CACHE_MAX = 16
_layout_cache: dict = {}           # (id(scene), D) -> ShardedScene
_layout_refs: dict = {}            # (id(scene), D) -> open-handle refcount
_layout_stats = {"hits": 0, "misses": 0}


def _layout_info() -> dict:
    return {
        "hits": _layout_stats["hits"],
        "misses": _layout_stats["misses"],
        "currsize": len(_layout_cache),
        "maxsize": _LAYOUT_CACHE_MAX,
    }


def _layout_clear() -> None:
    _layout_cache.clear()
    _layout_stats["hits"] = 0
    _layout_stats["misses"] = 0


register_render_cache("scene_layout", info=_layout_info, clear=_layout_clear)


def shard_scene_cached(scene: GaussianScene, num_shards: int) -> ShardedScene:
    """``shard_scene_host`` memoized per (scene identity, D).

    The layout is built at most once per scene and shard count and held as
    CPU tensors, so it pins no device memory; a handle moves it to its
    device. An entry goes when its source scene is garbage collected (a
    weakref finalizer: an id() key alone could alias a recycled object) or,
    first in first out, once the cache holds ``_LAYOUT_CACHE_MAX`` layouts;
    that eviction skips layouts an open handle references.
    """
    key = (id(scene), int(num_shards))
    hit = _layout_cache.get(key)
    if hit is not None:
        _layout_stats["hits"] += 1
        return hit
    _layout_stats["misses"] += 1
    out = shard_scene_host(scene, num_shards)
    if len(_layout_cache) >= _LAYOUT_CACHE_MAX:
        # The cache may pass its nominal size while that many layouts are
        # referenced: bounded by the open handles, not unbounded.
        for k in list(_layout_cache):
            if len(_layout_cache) < _LAYOUT_CACHE_MAX:
                break
            if _layout_refs.get(k, 0) <= 0:
                _layout_cache.pop(k)
    _layout_cache[key] = out
    weakref.finalize(scene, _drop_layout_key, key)
    return out


def _drop_layout_key(key) -> None:
    """Scene-GC finalizer: with the source scene gone no handle can hold
    its layout; drop both maps (its id() may be reused)."""
    _layout_cache.pop(key, None)
    _layout_refs.pop(key, None)


def acquire_scene_layout(scene: GaussianScene, num_shards: int) -> ShardedScene:
    """``shard_scene_cached`` plus a reference: the layout stays cached,
    and exempt from capacity eviction, until every acquirer releases it."""
    out = shard_scene_cached(scene, num_shards)
    key = (id(scene), int(num_shards))
    _layout_refs[key] = _layout_refs.get(key, 0) + 1
    return out


def release_scene_layout(scene: GaussianScene, num_shards: int) -> bool:
    """Drop one reference on ``(scene, num_shards)``; the last release
    evicts the cached layout. True when the layout was dropped."""
    key = (id(scene), int(num_shards))
    remaining = _layout_refs.get(key, 0) - 1
    if remaining > 0:
        _layout_refs[key] = remaining
        return False
    _layout_refs.pop(key, None)
    return _layout_cache.pop(key, None) is not None


def evict_scene_layouts(scene: GaussianScene) -> int:
    """Drop every unreferenced cached layout of ``scene``, at any shard
    count. Layouts that open handles reference stay (release those with
    :func:`release_scene_layout`). Returns the number dropped."""
    sid = id(scene)
    keys = [k for k in _layout_cache if k[0] == sid and _layout_refs.get(k, 0) <= 0]
    for k in keys:
        _layout_cache.pop(k, None)
    return len(keys)


render_batch_sharded = not_ported(
    "render_batch_sharded", "6: the JAX package's deprecated free functions"
)
