"""The port's tile-parameter autotune (repro_torch.autotune) against the JAX
package's (repro.autotune, tests/test_autotune.py), on the CPU with the
200-gaussian tiny scene at 128x128:

  * the 14 tests of tests/test_autotune.py on the port's objects: the
    signature, the grid, both cache layers, the two-phase search, the sweep
    and the engine handle's ``'auto'`` path (bitwise a fixed open);
  * parity: ``frontend_stats`` counters equal the JAX package's by value
    (gstg and tile_baseline, on the ``reference`` and ``cuda`` backends),
    ``candidate_grid`` and ``config_for`` identical, ``cost_phase`` entries
    with equal counters and verdicts and estimates within rtol 1e-6,
    except gstg past 32 member tiles, which the port holds infeasible;
  * the port's own rules: that verdict (no stats pass), the device field of
    the signature, a cache file apart from the JAX package's, and
    ``'auto'`` through ``render_batch``, a stream and ``submit``.

Scenes come from the reference (``repro.core.random_scene``, numpy to
torch). Every test points both packages' cache files at its own tmp_path.
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from repro.autotune import autotune_signature as jax_autotune_signature
from repro.autotune import cache as jax_cache
from repro.autotune import candidate_grid as jax_candidate_grid
from repro.autotune import config_for as jax_config_for
from repro.autotune import cost_phase as jax_cost_phase
from repro.autotune import stats_pass as jax_stats_pass
from repro.core import make_camera as jax_make_camera
from repro.core.pipeline import RenderConfig as JConfig
from repro_torch import engine
from repro_torch.autotune import (
    DEFAULT_CAPACITIES,
    DEFAULT_GROUP_FACTORS,
    DEFAULT_TILES,
    Candidate,
    autotune,
    autotune_signature,
    candidate_grid,
    config_for,
    cost_phase,
    sweep,
)
from repro_torch.autotune import cache as at_cache
from repro_torch.autotune import search as at_search
from repro_torch.core.camera import make_camera
from repro_torch.core.gaussians import scene_from_numpy
from repro_torch.core.pipeline import RenderConfig, frontend_stats, render, render_cache_info
from repro_torch.serving import RenderRequest, RenderServer
from torch_parity import assert_counters_equal, single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

# A small grid keeps each search to two stats passes and one measured
# candidate.
TINY_OPTS = dict(
    tiles=(16,), group_factors=(2, 4), capacities=(256,),
    top_k=1, warmup=1, reps=1,
)
CAM = dict(eye=(0.0, 1.0, 4.5), target=(0, 0, 0), width=128, height=128)
RESULT_TIMEOUT = 60


@pytest.fixture(autouse=True)
def isolated_autotune_cache(tmp_path, monkeypatch):
    """Each package's file in this test's tmp_path, both memory layers
    empty before and after."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at_torch.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at_jax.json"))
    at_cache._clear()
    jax_cache._clear()
    yield
    at_cache._clear()
    jax_cache._clear()


@pytest.fixture(scope="module")
def scene(tiny_scene):
    return scene_from_numpy(tiny_scene, "cpu")


@pytest.fixture(scope="module")
def cam():
    return make_camera(**CAM)


def _cfg(**kw):
    kw.setdefault("mode", "gstg")
    kw.setdefault("span", 6)
    return RenderConfig(tile=16, group=64, group_capacity=256, tile_capacity=256, **kw)


def _jcfg(cfg: RenderConfig) -> JConfig:
    """The JAX package's config of the same knobs (backend: its reference)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(JConfig)}
    return JConfig(**dict(kw, backend="reference"))


def _assert_bitwise(a, b):
    assert torch.equal(a.image, b.image)
    assert a.stats.as_dict() == b.stats.as_dict()


# -- signature ----------------------------------------------------------------


def test_signature_excludes_swept_knobs(scene):
    a = autotune_signature(scene, 128, 128, _cfg())
    b = autotune_signature(
        scene, 128, 128,
        dataclasses.replace(_cfg(), tile=8, group=32, tile_capacity=512, group_capacity=512),
    )
    assert a == b  # tile/group/capacities are the result, not the key


def test_signature_keys_on_geometry_resolution_backend(scene, small_scene):
    base = autotune_signature(scene, 128, 128, _cfg())
    assert autotune_signature(scene, 128, 96, _cfg()) != base
    assert autotune_signature(scene, 128, 128, _cfg(backend="cuda")) != base
    assert autotune_signature(scene, 128, 128, _cfg(mode="tile_baseline")) != base
    small = scene_from_numpy(small_scene, "cpu")
    assert autotune_signature(small, 128, 128, _cfg()) != base
    # Same geometry, other parameter values: the same key (a retrained
    # scene reuses the tune).
    clone = dataclasses.replace(scene, means3d=scene.means3d + 0.1)
    assert autotune_signature(clone, 128, 128, _cfg()) == base


def test_signature_device_field(scene, tiny_scene, monkeypatch):
    """The JAX package's fields in its order, with the device in place of
    the mesh: a tune made on the CPU never serves the card."""
    cpu = autotune_signature(scene, 128, 128, _cfg(), "cpu")
    assert cpu[-1] == ("cpu",)
    assert autotune_signature(scene, 128, 128, _cfg()) == cpu   # the scene's device
    want = jax_autotune_signature(tiny_scene, 128, 128, _jcfg(_cfg()))
    assert cpu[:-1] == want[:-1] and want[-1] == ()
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Card X")
    card = autotune_signature(scene, 128, 128, _cfg(), "cuda")
    assert card[-1] == ("cuda", "Card X") and card[:-1] == cpu[:-1]
    at_cache.store(cpu, {"tile": 16, "group": 32, "tile_capacity": 256})
    assert at_cache.lookup(card) is None
    if not torch.cuda.is_available():
        # CUDA unless the caller names another device; never a fallback.
        with pytest.raises(RuntimeError, match="CUDA"):
            autotune(scene, make_camera(**CAM), _cfg(), **TINY_OPTS)


# -- grid / config derivation -------------------------------------------------


def test_candidate_grid_is_legal_and_covers_the_floor():
    grid = candidate_grid()
    assert len(grid) == len(DEFAULT_TILES) * len(DEFAULT_GROUP_FACTORS) * len(DEFAULT_CAPACITIES)
    assert len({(c.tile, c.group) for c in grid}) >= 9
    for c in grid:
        assert c.group % c.tile == 0  # legal GridSpec

    cfg = config_for(_cfg(), Candidate(8, 64, 512))
    assert (cfg.tile, cfg.group, cfg.tile_capacity) == (8, 64, 512)
    assert cfg.group_capacity >= cfg.tile_capacity


def test_candidate_grid_and_config_for_match_jax():
    ours = candidate_grid()
    theirs = jax_candidate_grid()
    assert [c.as_dict() for c in ours] == [c.as_dict() for c in theirs]
    grid = dict(tiles=(4, 12), group_factors=(1, 3), capacities=(64, 1024))
    assert ([c.as_dict() for c in candidate_grid(**grid)]
            == [c.as_dict() for c in jax_candidate_grid(**grid)])
    for base in (_cfg(), _cfg(mode="tile_baseline"), dataclasses.replace(_cfg(), group_capacity=8)):
        for c, jc in zip(ours, theirs):
            got, want = config_for(base, c), jax_config_for(_jcfg(base), jc)
            assert {f.name: getattr(got, f.name) for f in dataclasses.fields(JConfig)} == \
                dict(dataclasses.asdict(want), backend=base.backend)


# -- cache layers -------------------------------------------------------------


def test_cache_store_lookup_and_disk_round_trip(scene):
    sig = autotune_signature(scene, 128, 128, _cfg())
    assert at_cache.lookup(sig) is None
    at_cache.store(sig, {"tile": 16, "group": 32, "tile_capacity": 256, "measured_ms": 1.5},
                   scene=scene)
    hit = at_cache.lookup(sig, scene=scene)
    assert hit["tile"] == 16 and hit["measured_ms"] == 1.5
    # Survive a process restart: clear memory, reload from the file.
    at_cache._clear()
    hit = at_cache.lookup(sig)
    assert hit is not None and hit["source"] == "disk"
    assert hit["group"] == 32
    with open(at_cache.cache_path()) as f:
        doc = json.load(f)
    assert doc["schema"] == "repro_torch.autotune_cache/v1"
    assert len(doc["entries"]) == 1


def test_eviction_drops_memory_keeps_disk(scene):
    sig = autotune_signature(scene, 128, 128, _cfg())
    at_cache.store(sig, {"tile": 16, "group": 64, "tile_capacity": 256}, scene=scene)
    assert at_cache.evict_autotune_entries(scene) == 1
    assert at_cache._info()["currsize"] == 0   # memory gone...
    at_cache._clear()
    assert at_cache.lookup(sig)["source"] == "disk"  # ...the file survives
    assert "autotune" in render_cache_info()


def test_the_packages_keep_separate_cache_files(scene, tiny_scene, tmp_path, monkeypatch):
    """Both variables set: a store in one package misses in the other, and
    neither file holds the other's entry. Unset, the defaults differ."""
    assert at_cache.cache_path() != jax_cache.cache_path()
    ours = autotune_signature(scene, 128, 128, _cfg(), "cpu")
    theirs = jax_autotune_signature(tiny_scene, 128, 128, _jcfg(_cfg()))
    at_cache.store(ours, {"tile": 16, "group": 32, "tile_capacity": 256})
    assert jax_cache.lookup(theirs) is None and jax_cache.lookup(ours) is None
    assert not (tmp_path / "at_jax.json").exists()
    jax_cache.store(theirs, {"tile": 8, "group": 16, "tile_capacity": 512})
    at_cache._clear()
    assert at_cache.lookup(theirs) is None
    assert at_cache.lookup(ours)["group"] == 32
    jax_cache._clear()
    assert jax_cache.lookup(ours) is None and jax_cache.lookup(theirs)["group"] == 16
    for path, schema in (("at_torch.json", "repro_torch"), ("at_jax.json", "repro")):
        doc = json.loads((tmp_path / path).read_text())
        assert doc["schema"] == f"{schema}.autotune_cache/v1" and len(doc["entries"]) == 1
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert at_cache.cache_path() == "results/autotune_cache_torch.json"
    assert jax_cache.cache_path() == "results/autotune_cache.json"


# -- frontend_stats and the cost phase against the JAX package ----------------


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("mode", ["gstg", "tile_baseline"])
def test_frontend_stats_matches_jax(scene, cam, tiny_scene, mode, backend):
    """Counters equal the JAX package's frontend_stats by value, and the
    frontend counters equal the port's render of the same config."""
    cfg = _cfg(mode=mode, backend=backend)
    got = frontend_stats(scene, cam, cfg).as_dict()
    want = jax_stats_pass(tiny_scene, jax_make_camera(**CAM), _jcfg(cfg))
    assert_counters_equal(got, want)
    assert got["blend_ops"] == 0 and got["alpha_ops"] == got["tile_entries"] * 16 * 16
    full = render(scene, cam, cfg).stats.as_dict()
    assert {k: v for k, v in got.items() if k not in ("alpha_ops", "blend_ops")} == \
        {k: v for k, v in full.items() if k not in ("alpha_ops", "blend_ops")}


@pytest.mark.parametrize("mode,grid", [
    ("gstg", dict(tiles=(8, 16), group_factors=(2, 8), capacities=(8, 256))),
    ("tile_baseline", dict(tiles=(8, 16), group_factors=(8,), capacities=(8, 256))),
])
def test_cost_phase_matches_jax(scene, cam, tiny_scene, mode, grid):
    """Equal counters, verdicts and estimates (rtol 1e-6), except gstg past
    32 member tiles: the JAX package stats it (and renders it wrong), the
    port holds it infeasible."""
    cfg = _cfg(mode=mode)
    ours = cost_phase(scene, cam, cfg, candidate_grid(**grid))
    theirs = jax_cost_phase(tiny_scene, jax_make_camera(**CAM), _jcfg(cfg),
                            jax_candidate_grid(**grid))
    assert len(ours) == len(theirs) == len(candidate_grid(**grid))
    refused = 0
    for a, b in zip(ours, theirs):
        assert (a["tile"], a["group"], a["tile_capacity"]) == \
            (b["tile"], b["group"], b["tile_capacity"])
        if mode == "gstg" and (a["group"] // a["tile"]) ** 2 > 32:
            assert (a["feasible"], a["reason"], a["est"]) == (False, "member_tiles", None)
            refused += 1
            continue
        for k in ("feasible", "overflow", "n_visible", "n_pairs_sort", "tile_entries",
                  "measured_ms"):
            assert a[k] == b[k], (k, a, b)
        assert a["reason"] == (None if a["feasible"] else "overflow")
        assert a["est_total_s"] == pytest.approx(b["est_total_s"], rel=1e-6)
        assert a["est"] == pytest.approx(b["est"], rel=1e-6)
    assert refused == (4 if mode == "gstg" else 0)
    assert any(not e["feasible"] and e["reason"] == "overflow" for e in ours)


def test_member_tiles_infeasible_without_stats_pass(scene, cam, monkeypatch):
    """gstg past 32 member tiles is infeasible with its reason and gets no
    stats pass; the baselines are held to overflow alone."""
    calls = []
    real = at_search.stats_pass
    monkeypatch.setattr(at_search, "stats_pass",
                        lambda s, c, cfg: calls.append((cfg.tile, cfg.group)) or real(s, c, cfg))
    grid = candidate_grid(tiles=(8, 16), group_factors=(2, 8), capacities=(256,))
    entries = cost_phase(scene, cam, _cfg(), grid)
    verdicts = {(e["tile"], e["group"]): (e["feasible"], e["reason"]) for e in entries}
    assert verdicts == {(8, 16): (True, None), (8, 64): (False, "member_tiles"),
                        (16, 32): (True, None), (16, 128): (False, "member_tiles")}
    assert calls == [(8, 16), (16, 32)]
    calls.clear()
    base = cost_phase(scene, cam, _cfg(mode="tile_baseline"), grid)
    assert all(e["feasible"] and e["reason"] is None for e in base) and len(calls) == 4
    with pytest.raises(ValueError, match="no feasible autotune candidate"):
        autotune(scene, cam, _cfg(), device="cpu", tiles=(8,), group_factors=(8,),
                 capacities=(256,))
    with pytest.raises(ValueError, match="member tiles"):
        engine.open(scene, _cfg(), device="cpu", tile_params=(8, 64, 256))


# -- the search ---------------------------------------------------------------


def test_cost_phase_counts_and_feasibility(scene, cam):
    cands = candidate_grid(tiles=(16,), group_factors=(2, 4), capacities=(8, 256))
    entries = cost_phase(scene, cam, _cfg(), cands)
    assert len(entries) == len(cands)
    by_knobs = {(e["tile"], e["group"], e["tile_capacity"]): e for e in entries}
    # Capacity 8 overflows a 200-gaussian scene at 128 px; 256 does not.
    assert not by_knobs[(16, 32, 8)]["feasible"]
    assert by_knobs[(16, 32, 256)]["feasible"]
    for e in entries:
        assert e["est_total_s"] > 0
        assert e["measured_ms"] is None  # phase 1 never times anything


def test_autotune_search_caches_and_rehits(scene, cam):
    cfg = _cfg()
    res = autotune(scene, cam, cfg, device="cpu", **TINY_OPTS)
    assert res.source == "search"
    assert res.measured_ms is not None and res.measured_ms > 0
    assert len(res.trajectory) == 2  # full grid recorded, pruned or not
    again = autotune(scene, cam, cfg, device="cpu", **TINY_OPTS)
    assert again.source in ("cache", "disk")
    assert again.candidate == res.candidate


def test_autotune_verify_holds_on_the_reference_backend(scene, cam):
    """verify=True: bitwise the base config when the tile is unchanged
    (here the reference backend, which rasterizes the compacted lists),
    allclose at 1e-5 across tiles."""
    for tiles in ((16,), (8,)):
        res = autotune(scene, cam, _cfg(), device="cpu", verify=True, use_cache=False,
                       **dict(TINY_OPTS, tiles=tiles, top_k=None))
        assert res.tile == tiles[0]


def test_plain_fused_raster_is_not_bitwise_across_group_sizes(scene, cam):
    """A known difference (ROADMAP queue 3): on the CPU the ``cuda``
    backend's plain fused raster blends per-chunk cumprods over the group
    list, and another group size moves a tile's entries across chunk
    boundaries, so images agree to fp reassociation but not bitwise. The
    reference backend (per-tile lists) is bitwise; so are the CUDA kernels,
    which blend sequentially (tests/test_torch_cuda_kernels.py)."""
    imgs = {}
    for backend in ("reference", "cuda"):
        imgs[backend] = [render(scene, cam, dataclasses.replace(_cfg(backend=backend), group=g))
                         .image for g in (16, 32, 64)]
    assert all(torch.equal(imgs["reference"][0], x) for x in imgs["reference"])
    diffs = [float((imgs["cuda"][0] - x).abs().max()) for x in imgs["cuda"][1:]]
    assert max(diffs) > 0 and max(diffs) <= 1e-6
    for x in imgs["cuda"]:
        torch.testing.assert_close(x, imgs["reference"][0], atol=1e-5, rtol=1e-5)


def test_sweep_winner_is_measured_minimum(scene, cam):
    res = sweep(scene, cam, _cfg(), device="cpu", tiles=(16,), group_factors=(2, 4),
                capacities=(256,), warmup=1, reps=1)
    measured = [e for e in res.trajectory if e["measured_ms"] is not None]
    assert len(measured) == 2  # top_k=None measures every feasible point
    assert res.measured_ms <= min(e["measured_ms"] for e in measured)
    # A sweep writes no cache (benchmarks measure again).
    assert at_cache._info()["currsize"] == 0


# -- the engine-handle 'auto' path --------------------------------------------


def _fixed(scene, cfg, triple, cam):
    with engine.open(scene, cfg, device="cpu", tile_params=triple) as rf:
        return rf.render(cam)


def test_open_auto_bitwise_matches_fixed(scene, cam):
    cfg = _cfg()
    with engine.open(scene, cfg, device="cpu", tile_params="auto",
                     autotune_opts=TINY_OPTS) as ra:
        assert ra.tile_params == "auto (pending)"
        out = ra.render(cam)
        tuned = ra.tile_params
        assert isinstance(tuned, tuple)
        assert ra.stats()["tile_params"] == tuned
    _assert_bitwise(out, _fixed(scene, cfg, tuned, cam))


def test_open_auto_bitwise_matches_fixed_cuda_backend(scene, cam):
    cfg = _cfg(backend="cuda")
    with engine.open(scene, cfg, device="cpu", tile_params="auto",
                     autotune_opts=TINY_OPTS) as ra:
        out = ra.render(cam)
        tuned = ra.tile_params
    _assert_bitwise(out, _fixed(scene, cfg, tuned, cam))


def test_open_explicit_triple_and_validation(scene, cam):
    cfg = _cfg()
    with engine.open(scene, cfg, device="cpu", tile_params=(16, 32, 512)) as r:
        assert r.tile_params == (16, 32, 512)
        assert r.stats()["config"].group == 32
        assert r.stats()["config"].group_capacity == 512
        r.render(cam)
    with pytest.raises(ValueError):
        engine.open(scene, cfg, device="cpu", tile_params=(16, 32))
    with pytest.raises(ValueError):
        engine.open(scene, cfg, device="cpu", tile_params="fastest")


def test_close_evicts_autotune_entries_disk_survives(scene, cam):
    cfg = _cfg()
    with engine.open(scene, cfg, device="cpu", tile_params="auto",
                     autotune_opts=TINY_OPTS) as r:
        r.render(cam)
        assert at_cache._info()["currsize"] == 1
    assert at_cache._info()["currsize"] == 0   # close() evicted (memory)
    # A re-open skips the search: the file answers the lookup.
    sig = autotune_signature(scene, 128, 128, cfg, "cpu")
    with engine.open(scene, cfg, device="cpu", tile_params="auto",
                     autotune_opts=TINY_OPTS) as r2:
        r2.render(cam)
        assert isinstance(r2.tile_params, tuple)
        assert at_cache._cache[sig]["source"] == "disk"
    assert render_cache_info()["autotune"]["hits"] >= 1


def test_render_server_autotune_path(scene, cam):
    """RenderServer(autotune=True): the first dispatch tunes, the handle
    serves the committed triple, bitwise like render under it."""
    cfg = _cfg()
    with RenderServer({"s": scene}, device="cpu", autotune=True, autotune_opts=TINY_OPTS,
                      max_batch=2, max_wait=0.01) as srv:
        for i in range(2):
            assert srv.submit(RenderRequest(i, "s", cam, cfg))
        srv.drain()
        assert len(srv.results) == 2
        tuned = srv.commit("s", cfg).tile_params
        assert isinstance(tuned, tuple)
        results = dict(srv.results)
    want = _fixed(scene, cfg, tuned, cam).image
    for res in results.values():
        assert torch.equal(res.image, want)


def test_auto_render_batch_resolves_from_lane0(scene, cam):
    cfg = _cfg()
    cams = [cam, make_camera(**dict(CAM, eye=(0.3, 1.0, 4.5)))]
    with engine.open(scene, cfg, device="cpu", tile_params="auto",
                     autotune_opts=TINY_OPTS) as r:
        out = r.render_batch(cams, pad_to=3)
        tuned = r.tile_params
        assert isinstance(tuned, tuple)
        assert out.image.shape[0] == 2
    with engine.open(scene, cfg, device="cpu", tile_params=tuned) as rf:
        for i, c in enumerate(cams):
            _assert_bitwise(out.map(lambda x, i=i: x[i]), rf.render(c))


def test_auto_stream_and_submit_bitwise_like_fixed(scene, cam):
    """A stream opened on a pending 'auto' handle and the submit worker each
    reach the resolution first, and render bitwise like a fixed open."""
    cfg = _cfg()
    for path in ("stream", "submit"):
        at_cache._clear()
        with engine.open(scene, cfg, device="cpu", tile_params="auto",
                         autotune_opts=TINY_OPTS, max_batch=2) as r:
            if path == "stream":
                with r.open_stream(speculate=False) as s:
                    assert r.tile_params == "auto (pending)"
                    outs = [s.render(cam), s.render(cam)]
                    assert s.stats()["hits"] == 1
            else:
                futs = [r.submit(cam), r.submit(cam)]
                outs = [f.result(timeout=RESULT_TIMEOUT) for f in futs]
            tuned = r.tile_params
            assert isinstance(tuned, tuple)
        want = _fixed(scene, cfg, tuned, cam)
        for out in outs:
            _assert_bitwise(out, want)
