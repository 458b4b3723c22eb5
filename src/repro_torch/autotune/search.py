"""Cost-model-guided (tile x group x tile_capacity) search (mirror of
``repro.autotune.search``).

GS-TG's contribution is a trade-off knob: sort at the group, rasterize the
small tiles through bitmasks. Its best setting shifts with scene scale and
resolution, so this module picks it for a committed scene, in two phases:

  phase 1 (``cost_phase``)    — for every candidate, one stats pass
      (``core.pipeline.frontend_stats``: project, identify, bin, bitmask and
      compact, no rasterization) feeds ``core.cost_model.estimate``.
      Candidates whose tables overflow are infeasible (a cut list breaks
      losslessness); so is a gstg candidate past 32 member tiles a group,
      which ``check_config`` refuses, without a stats pass. The rest are
      ranked by modelled total seconds.
  phase 2 (``measure_phase``) — the top-k survivors are timed through the
      production path (``engine.open`` -> ``Renderer.render``) on the
      search's device, warm-up excluded (the first render of a process
      builds the kernels), each render fenced, median of ``reps``. The
      winner is the measured minimum.

Losslessness: group and tile_capacity change no per-tile list when nothing
overflows, so on the card (sequential blend) the image is bitwise the
same; the tile changes the raster partition, and images then agree to fp
reassociation. ``autotune(verify=True)`` checks the guarantee against the
base config after a fresh search. Selecting the triple through
``tile_params='auto'`` always renders bitwise like committing it fixed.

Everything runs on the search's ``device``: CUDA unless the caller names
another, never a quiet fallback; or, for a handle's ``tile_params='auto'``,
over the handle's mesh.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.autotune.cache import autotune_signature, lookup, store
from repro_torch.core.cost_model import GSTG_ASIC, HardwareConfig, estimate
from repro_torch.core.pipeline import (
    RenderConfig,
    RenderStats,
    frontend_stats,
    too_many_member_tiles,
)
from repro_torch.utils.misc import fence, resolve_device

# The default sweep: 3 tiles x 3 group factors = 9 (tile, group) points,
# each at two capacities (the JAX package's grid).
DEFAULT_TILES: Tuple[int, ...] = (8, 16, 32)
DEFAULT_GROUP_FACTORS: Tuple[int, ...] = (2, 4, 8)
DEFAULT_CAPACITIES: Tuple[int, ...] = (256, 512)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the paper's trade-off grid."""

    tile: int
    group: int
    tile_capacity: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AutotuneResult:
    """The winner plus the search's trajectory.

    ``trajectory`` holds one dict per swept candidate: the knobs, the
    verdict (``feasible`` and its ``reason``), the phase-1 estimate
    (``est``, ``StageCosts.as_dict()``) and, for measured candidates, the
    phase-2 ``measured_ms`` median. ``source`` is ``"search"`` for a fresh
    search, ``"cache"`` or ``"disk"`` when the signature hit the cache.
    """

    tile: int
    group: int
    tile_capacity: int
    measured_ms: Optional[float]
    source: str
    signature: tuple
    trajectory: list

    @property
    def candidate(self) -> Candidate:
        return Candidate(self.tile, self.group, self.tile_capacity)


def candidate_grid(
    tiles: Sequence[int] = DEFAULT_TILES,
    group_factors: Sequence[int] = DEFAULT_GROUP_FACTORS,
    capacities: Sequence[int] = DEFAULT_CAPACITIES,
) -> list:
    """The sweep grid: group = tile x factor, so every candidate is a legal
    GridSpec (group a multiple of tile)."""
    return [
        Candidate(tile=int(t), group=int(t * f), tile_capacity=int(c))
        for t in tiles for f in group_factors for c in capacities
    ]


def config_for(base: RenderConfig, cand: Candidate) -> RenderConfig:
    """The base config with one candidate's knobs committed.
    ``group_capacity`` is floored at the candidate's tile capacity (entries
    are compacted into tiles from the group table)."""
    return dataclasses.replace(
        base,
        tile=cand.tile,
        group=cand.group,
        tile_capacity=cand.tile_capacity,
        group_capacity=max(base.group_capacity, cand.tile_capacity),
    )


def stats_pass(scene, cam, cfg: RenderConfig) -> RenderStats:
    """One eager stats pass on the scene's device (phase 1), its counters
    brought to the host as 0-d int64 tensors."""
    with torch.inference_mode():
        counts = frontend_stats(scene, cam, cfg).as_dict()
    return RenderStats(**{k: torch.tensor(v) for k, v in counts.items()})


def cost_phase(
    scene,
    cam,
    base_cfg: RenderConfig,
    candidates: Sequence[Candidate],
    hw: HardwareConfig = GSTG_ASIC,
) -> list:
    """Rank candidates by the cost model; flag the infeasible ones.

    Returns one trajectory entry per candidate, in the order given: the
    knobs, ``feasible`` and ``reason`` (None, ``"overflow"`` for a cut
    list, or ``"member_tiles"`` for gstg past 32 member tiles a group,
    which gets no stats pass and no estimate), the estimate and the raw
    counters. Ranking reads ``est_total_s``.
    """
    execution = "asic" if base_cfg.mode == "gstg" else "gpu"
    entries = []
    for cand in candidates:
        cfg = config_for(base_cfg, cand)
        if too_many_member_tiles(cfg):
            entries.append({
                **cand.as_dict(), "feasible": False, "reason": "member_tiles",
                "overflow": None, "est": None, "est_total_s": None, "n_visible": None,
                "n_pairs_sort": None, "tile_entries": None, "measured_ms": None,
            })
            continue
        s = stats_pass(scene, cam, cfg)
        est = estimate(
            s, hw,
            boundary_group=cfg.boundary_group,
            boundary_tile=cfg.boundary_tile,
            mode=cfg.mode,
            execution=execution,
        )
        overflow = int(s.overflow) + int(s.span_overflow)
        entries.append({
            **cand.as_dict(),
            "feasible": overflow == 0,
            "reason": None if overflow == 0 else "overflow",
            "overflow": overflow,
            "est": est.as_dict(),
            "est_total_s": est.total_s,
            "n_visible": int(s.n_visible),
            "n_pairs_sort": float(s.n_pairs_sort),
            "tile_entries": float(s.tile_entries),
            "measured_ms": None,
        })
    return entries


def measure_phase(
    scene,
    cam,
    base_cfg: RenderConfig,
    candidates: Sequence[Candidate],
    device=None,
    warmup: int = 1,
    reps: int = 3,
    mesh=None,
) -> dict:
    """Median wall time (ms) per candidate through the production path: a
    handle committed on ``device`` (or over ``mesh``) renders ``warmup``
    frames, then ``reps`` timed ones, each fenced (``torch.cuda.synchronize``
    on every card of the frame). Each handle is closed before the next
    opens, so the search holds one extra copy of the scene at most."""
    from repro_torch import engine

    where = {"mesh": mesh} if mesh is not None else {"device": device}
    out = {}
    for cand in candidates:
        with engine.open(scene, config_for(base_cfg, cand), **where) as r:
            for _ in range(max(warmup, 1)):
                fence(r.render(cam).image)
            times = []
            for _ in range(max(reps, 1)):
                t0 = time.perf_counter()
                fence(r.render(cam).image)
                times.append((time.perf_counter() - t0) * 1e3)
        out[cand] = statistics.median(times)
    return out


def autotune(
    scene,
    cam,
    base_cfg: RenderConfig,
    *,
    device=None,
    mesh=None,
    tiles: Sequence[int] = DEFAULT_TILES,
    group_factors: Sequence[int] = DEFAULT_GROUP_FACTORS,
    capacities: Sequence[int] = DEFAULT_CAPACITIES,
    top_k: Optional[int] = 3,
    warmup: int = 1,
    reps: int = 3,
    hw: HardwareConfig = GSTG_ASIC,
    use_cache: bool = True,
    persist: bool = True,
    verify: bool = False,
) -> AutotuneResult:
    """The two-phase search for one (scene, camera, config) commit on
    ``device`` (CUDA unless the caller names another) or over ``mesh`` (a
    handle's: the stats passes run on its lead device, the measured frames
    and the verify through handles over the mesh).

    ``top_k=None`` measures every feasible candidate (the sweep); otherwise
    the k best by modelled cost. With ``use_cache`` the signature is looked
    up first (memory, then the file) and a fresh result is stored back
    (``persist`` controls the file). ``verify`` renders the winner and the
    base config once and checks the losslessness guarantee (bitwise when
    the tile is unchanged, allclose at 1e-5 across tiles).
    """
    if device is not None and mesh is not None:
        raise ValueError("pass device or mesh, not both")
    dev = mesh.lead(0) if mesh is not None else resolve_device(device)
    sig = autotune_signature(scene, cam.width, cam.height, base_cfg, dev, mesh)
    if use_cache:
        hit = lookup(sig, scene=scene)
        if hit is not None:
            return AutotuneResult(
                tile=int(hit["tile"]),
                group=int(hit["group"]),
                tile_capacity=int(hit["tile_capacity"]),
                measured_ms=hit.get("measured_ms"),
                source=hit.get("source", "cache"),
                signature=sig,
                trajectory=[],
            )

    # The stats passes run on the search's device (a scene already there is
    # not copied).
    entries = cost_phase(
        scene.to(dev), cam, base_cfg,
        candidate_grid(tiles, group_factors, capacities), hw,
    )
    feasible = [e for e in entries if e["feasible"]]
    if not feasible:
        raise ValueError(
            "no feasible autotune candidate (every swept point overflowed or "
            "exceeded 32 member tiles a group); raise the capacity axis, "
            "group_capacity or span"
        )
    ranked = sorted(feasible, key=lambda e: e["est_total_s"])
    survivors = ranked if top_k is None else ranked[: max(top_k, 1)]

    def cand_of(e):
        return Candidate(e["tile"], e["group"], e["tile_capacity"])

    measured = measure_phase(
        scene, cam, base_cfg, [cand_of(e) for e in survivors],
        device=dev, warmup=warmup, reps=reps, mesh=mesh,
    )
    for e in survivors:
        e["measured_ms"] = measured[cand_of(e)]
    win = min(survivors, key=lambda e: e["measured_ms"])
    result = AutotuneResult(
        tile=win["tile"],
        group=win["group"],
        tile_capacity=win["tile_capacity"],
        measured_ms=win["measured_ms"],
        source="search",
        signature=sig,
        trajectory=entries,
    )
    if verify:
        _verify_lossless(scene, cam, base_cfg, result.candidate, dev, mesh)
    if use_cache:
        store(
            sig,
            {
                "tile": result.tile,
                "group": result.group,
                "tile_capacity": result.tile_capacity,
                "measured_ms": result.measured_ms,
            },
            scene=scene,
            persist=persist,
        )
    return result


def sweep(scene, cam, base_cfg: RenderConfig, **kw) -> AutotuneResult:
    """Measure every feasible grid point (the trajectory mode): the selected
    triple's measured time is at most every other swept point's. Never
    reads or writes the cache: a benchmark measures again."""
    kw.setdefault("top_k", None)
    return autotune(scene, cam, base_cfg, use_cache=False, persist=False, **kw)


def _verify_lossless(scene, cam, base_cfg: RenderConfig, cand: Candidate, device,
                     mesh=None) -> None:
    """Check the knobs' losslessness for this scene, winner against base
    config through the same handle path: bitwise when the tile is unchanged
    (group and capacity reorder nothing), allclose at 1e-5 across tiles (fp
    reassociation of the raster partition). The two handles open one after
    the other."""
    from repro_torch import engine

    where = {"mesh": mesh} if mesh is not None else {"device": device}
    images = []
    for cfg in (base_cfg, config_for(base_cfg, cand)):
        with engine.open(scene, cfg, **where) as r:
            images.append(r.render(cam).image.cpu())
    a, b = images
    if cand.tile == base_cfg.tile:
        if not torch.equal(a, b):
            raise AssertionError(
                f"autotuned {cand} is not bitwise-identical to the base config "
                f"(tile unchanged: group and capacity must be lossless)"
            )
    elif not torch.allclose(a, b, atol=1e-5, rtol=1e-5):
        raise AssertionError(
            f"autotuned {cand} diverges from the base config beyond fp "
            f"reassociation tolerance"
        )
