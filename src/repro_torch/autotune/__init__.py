"""Autotuned tile grouping (mirror of ``repro.autotune``).

Sweeps the paper's core trade-off, ``tile x group x tile_capacity``, for a
committed scene: a cost-model phase over stats-only frontend passes, then
real wall time of the survivors through the engine handle's render, on the
search's device. Winners are cached per (scene geometry, resolution,
config, device) signature in the render-cache registry and in the port's
own file (``REPRO_TORCH_AUTOTUNE_CACHE``, by default
``results/autotune_cache_torch.json``); ``engine.open(...,
tile_params='auto')`` consults the cache and commits the tuned config.
"""
from repro_torch.autotune.cache import (
    autotune_signature,
    cache_path,
    evict_autotune_entries,
)
from repro_torch.autotune.search import (
    DEFAULT_CAPACITIES,
    DEFAULT_GROUP_FACTORS,
    DEFAULT_TILES,
    AutotuneResult,
    Candidate,
    autotune,
    candidate_grid,
    config_for,
    cost_phase,
    measure_phase,
    stats_pass,
    sweep,
)

__all__ = [
    "AutotuneResult",
    "Candidate",
    "DEFAULT_CAPACITIES",
    "DEFAULT_GROUP_FACTORS",
    "DEFAULT_TILES",
    "autotune",
    "autotune_signature",
    "cache_path",
    "candidate_grid",
    "config_for",
    "cost_phase",
    "evict_autotune_entries",
    "measure_phase",
    "stats_pass",
    "sweep",
]
