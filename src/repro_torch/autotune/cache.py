"""Autotune result cache: tuned tile params per scene, resolution and device
(mirror of ``repro.autotune.cache``).

Two layers:

  * an in-process dict keyed by :func:`autotune_signature`, registered with
    the render-cache registry (``core.pipeline.register_render_cache``)
    under ``"autotune"``, so ``render_cache_info()`` and
    ``render_cache_clear()`` cover it;
  * a best-effort JSON file (``REPRO_TORCH_AUTOTUNE_CACHE``, by default
    ``results/autotune_cache_torch.json``), so a tuned triple survives the
    process: a later ``engine.open(tile_params='auto')`` with the same
    signature reloads the winner instead of searching again.

The file and its variable are the port's own, not the JAX package's
(``REPRO_AUTOTUNE_CACHE``, ``results/autotune_cache.json``): the port's
times come from another machine, and it holds gstg past 32 member tiles
infeasible where the JAX package renders it. Neither package reads the
other's file.

The in-memory layer also records which scene object each entry was tuned
or looked up for, so ``Renderer.close()`` drops its handle's entries
(:func:`evict_autotune_entries`); the file keeps them.

A signature hashes geometry, not parameter values: the tuned trade-off
depends on how many gaussians cover how many pixels, so a retrained scene
of the same size reuses the tune. Its last field is the device the search
ran on (its type, and the card's name on CUDA; a mesh's lead device), and
beside it the mesh's shape when the mesh has more than one device, where
the JAX package keys on the mesh alone: a tune made on the CPU never serves
the card.
"""
from __future__ import annotations

import ast
import json
import os
import tempfile
import threading
from typing import Dict, Optional

import torch

from repro_torch.core.pipeline import RenderConfig, register_render_cache
from repro_torch.obs import get_registry
from repro_torch.sharding.scene import ShardedScene
from repro_torch.utils.misc import tree_device

_ENV_PATH = "REPRO_TORCH_AUTOTUNE_CACHE"
_DEFAULT_PATH = os.path.join("results", "autotune_cache_torch.json")
_SCHEMA = "repro_torch.autotune_cache/v1"
# In-memory bound (the registry wants bounded caches). FIFO on overflow; the
# file keeps everything, so an evicted signature reloads, never re-searches.
_CACHE_MAX = 64

_lock = threading.RLock()
_cache: Dict[tuple, dict] = {}
_by_scene: Dict[int, set] = {}
_stats = {"hits": 0, "misses": 0}
_disk_loaded = False


def cache_path() -> str:
    return os.environ.get(_ENV_PATH) or _DEFAULT_PATH


def _device_key(device) -> tuple:
    """The signature's device field: ``(type,)``, plus the card's name on
    CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return (dev.type, torch.cuda.get_device_name(dev))
    return (dev.type,)


def autotune_signature(scene, width: int, height: int, cfg: RenderConfig,
                       device=None, mesh=None) -> tuple:
    """The cache key: (scene geometry, resolution, config, device).

    Scene geometry is the gaussian count (and the shard layout of a
    pre-sharded scene). The config gives every knob that changes which
    candidate wins, except the swept ones (tile, group, tile_capacity: the
    result, not the key) and group_capacity, which the search derives from
    them. ``device`` defaults to the scene's, or to the lead device of
    ``mesh``, whose shape joins the device field when it has more than one
    device."""
    if isinstance(scene, ShardedScene):
        geom = ("sharded", scene.num_shards, scene.shard_size)
    else:
        geom = ("scene", int(scene.num_gaussians))
    if device is None:
        device = mesh.lead(0) if mesh is not None else tree_device(scene)
    where = _device_key(device)
    if mesh is not None and mesh.size > 1:
        where += tuple(sorted(dict(mesh.shape).items()))
    return (
        geom,
        int(width), int(height),
        cfg.backend, cfg.mode,
        cfg.boundary_group, cfg.boundary_tile,
        cfg.span, cfg.chunk, cfg.early_exit,
        cfg.scene_shards, cfg.feature_gather,
        where,
    )


# -- disk layer (best-effort) -------------------------------------------------


def _load_disk() -> None:
    """Merge the file into memory once per process (or after a clear or an
    eviction). A missing or corrupt file counts as empty."""
    global _disk_loaded
    if _disk_loaded:
        return
    _disk_loaded = True
    try:
        with open(cache_path()) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return
    entries = doc.get("entries", {}) if isinstance(doc, dict) else {}
    for key, entry in entries.items():
        try:
            sig = ast.literal_eval(key)      # a repr'd tuple of literals
        except (ValueError, SyntaxError):
            continue
        if isinstance(sig, tuple) and isinstance(entry, dict):
            _cache.setdefault(sig, dict(entry, source="disk"))


def _save_disk() -> None:
    """Rewrite the file from the in-memory entries (temporary file, then
    rename). Failures are swallowed: a read-only checkout still tunes, and
    tunes again in the next process."""
    path = cache_path()
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        entries = {
            repr(sig): {k: v for k, v in e.items() if k != "source"}
            for sig, e in _cache.items()
        }
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump({"schema": _SCHEMA, "entries": entries}, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


# -- in-memory layer ----------------------------------------------------------


def lookup(sig: tuple, scene=None) -> Optional[dict]:
    """The cached entry for ``sig`` (memory, then the file), or None. Counts
    a hit or a miss; a hit with ``scene`` given is attributed to that scene
    object for close()-time eviction."""
    with _lock:
        _load_disk()
        entry = _cache.get(sig)
        if entry is None:
            _stats["misses"] += 1
            get_registry().counter("autotune.cache_misses_total").inc()
            return None
        _stats["hits"] += 1
        get_registry().counter("autotune.cache_hits_total").inc()
        if scene is not None:
            _by_scene.setdefault(id(scene), set()).add(sig)
        return dict(entry)


def store(sig: tuple, entry: dict, scene=None, persist: bool = True) -> None:
    """Record a tuned result. ``entry`` must be JSON-serializable (the file
    round-trips it); ``persist=False`` keeps it in memory only."""
    with _lock:
        _load_disk()
        get_registry().counter("autotune.stores_total").inc()
        _cache[sig] = dict(entry)
        if scene is not None:
            _by_scene.setdefault(id(scene), set()).add(sig)
        if persist:
            _save_disk()
        while len(_cache) > _CACHE_MAX:   # FIFO; the file keeps them all
            _cache.pop(next(iter(_cache)))


def evict_autotune_entries(scene) -> int:
    """Drop every in-memory entry attributed to ``scene``: the
    ``Renderer.close()`` hook, so per-scene state does not outlive its
    handle. The file keeps the entries, so a re-open reloads the tune
    instead of searching. Returns the number of entries dropped."""
    global _disk_loaded
    with _lock:
        sigs = _by_scene.pop(id(scene), set())
        n = sum(_cache.pop(sig, None) is not None for sig in sigs)
        if n:
            # The file may still hold the dropped signatures: merge it again
            # at the next lookup instead of searching.
            _disk_loaded = False
        return n


def _info() -> dict:
    with _lock:
        return {
            "hits": _stats["hits"],
            "misses": _stats["misses"],
            "currsize": len(_cache),
            "maxsize": _CACHE_MAX,
        }


def _clear() -> None:
    global _disk_loaded
    with _lock:
        _cache.clear()
        _by_scene.clear()
        _stats["hits"] = 0
        _stats["misses"] = 0
        _disk_loaded = False   # the next lookup merges the file again


register_render_cache("autotune", info=_info, clear=_clear)
