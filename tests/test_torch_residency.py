"""The port's paged scene residency (repro_torch.residency) against the JAX
package's (tests/test_residency.py), on the CPU with tiny scenes at 64x64:

  * the manager's LRU paging, refcounts and budget eviction, and the same
    page-in / page-out / eviction sequence as the JAX manager on one round
    robin, with every entry's static MB equal to the JAX handle's;
  * paging is bitwise invisible: a round robin at twice the budget renders
    every frame bitwise like an unbudgeted handle, and the residency
    counters equal the residency/* spans;
  * the backing store is a copy: changing the caller's scene in place
    after the commit changes no paged-in render;
  * the stream frontend caches are charged against the budget;
  * a budgeted server evicts instead of failing, prefetches at admission,
    and closes terminally.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.core import random_scene as jax_random_scene
from repro.core.pipeline import RenderConfig as JConfig
from repro.residency import ResidencyManager as JaxResidencyManager
from repro_torch import engine
from repro_torch.core.camera import make_camera, orbit_cameras
from repro_torch.core.gaussians import scene_from_numpy
from repro_torch.core.pipeline import RenderConfig
from repro_torch.obs import (
    Tracer,
    get_registry,
    get_tracer,
    set_tracer,
    validate_residency_trace,
)
from repro_torch.residency import ResidencyManager
from torch_parity import single_thread  # noqa: F401

CFG_KW = dict(tile=16, group=64, group_capacity=256, tile_capacity=256)
CPU = torch.device("cpu")


@pytest.fixture()
def cfg():
    return RenderConfig(**CFG_KW)


@pytest.fixture(scope="module")
def jax_scenes():
    return [jax_random_scene(jax.random.key(10 + i), 200, extent=2.5) for i in range(4)]


@pytest.fixture(scope="module")
def scenes(jax_scenes):
    return [scene_from_numpy(s, "cpu") for s in jax_scenes]


def _cam():
    return make_camera((0.0, 1.0, 4.5), (0, 0, 0), 64, 64)


def _counter(name: str) -> int:
    return get_registry().snapshot()["counters"].get(name, 0)


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.standard_normal((64, 3)).astype(np.float32))}


def _cost(handle) -> float:
    st = handle.stats()
    return st["scene_mb_per_device"] + st["feature_mb_per_device"]


# -- the manager alone ------------------------------------------------------------


def test_manager_register_acquire_release():
    mgr = ResidencyManager(budget_mb=None)
    entry = mgr.register("k", _tree(0), CPU, static_mb=1.0)
    assert not entry.resident
    dev = mgr.acquire(entry)
    assert entry.resident
    assert torch.equal(dev["x"], _tree(0)["x"])
    assert mgr.acquire(entry) is dev           # a resident acquire is a hit
    s = mgr.stats()
    assert s["page_ins"] == 1 and s["hits"] == 1 and s["page_outs"] == 0
    mgr.release(entry)
    assert mgr.stats()["entries"] == 0
    assert mgr.stats()["page_outs"] == 1       # release pages out


def test_manager_shared_entry_refcount():
    """Two registrants of one key share ONE entry (and device copy); the
    entry survives until the last release."""
    mgr = ResidencyManager()
    a = mgr.register("k", _tree(1), CPU, static_mb=1.0)
    b = mgr.register("k", _tree(1), CPU, static_mb=2.0)
    assert a is b
    assert a.static_mb == 2.0                  # conservative max
    assert mgr.acquire(a) is mgr.acquire(b)
    mgr.release(a)
    assert mgr.stats()["entries"] == 1 and a.resident
    mgr.release(b)
    assert mgr.stats()["entries"] == 0


def test_manager_lru_eviction_against_budget():
    """Page-in past the budget evicts the least recently acquired resident;
    a re-acquire of the victim pages it back in (evicting in turn)."""
    mgr = ResidencyManager(budget_mb=2.5)
    ea, eb, ec = (mgr.register(k, _tree(i), CPU, static_mb=1.0)
                  for i, k in enumerate("abc", start=2))
    mgr.acquire(ea)
    mgr.acquire(eb)
    assert ea.resident and eb.resident
    mgr.acquire(ec)                            # over budget: evict LRU = a
    assert not ea.resident and eb.resident and ec.resident
    assert mgr.stats()["evictions"] == 1
    mgr.acquire(eb)                            # touch b: c becomes LRU
    mgr.acquire(ea)                            # page a back: evicts c
    assert ea.resident and eb.resident and not ec.resident
    assert mgr.stats()["page_ins"] == 4 and mgr.stats()["evictions"] == 2
    for e in (ea, eb, ec):
        mgr.release(e)


def test_manager_single_entry_over_budget_still_serves():
    """With nothing left to evict, the active entry pages in anyway and the
    violation is counted."""
    mgr = ResidencyManager(budget_mb=0.5)
    e = mgr.register("big", _tree(5), CPU, static_mb=1.0)
    assert mgr.acquire(e) is not None and e.resident
    assert mgr.stats()["over_budget"] == 1
    mgr.release(e)


def test_manager_reused_id_gets_its_own_entry():
    """A key names its scene by id(): when another object registers under a
    key whose entry was filed for a different, still referenced source
    (an id the allocator reused), the old entry moves to a key of its own
    and keeps serving its handles, and the newcomer gets a fresh entry."""
    class Source:
        pass

    a, b = Source(), Source()
    mgr = ResidencyManager()
    ea = mgr.register("k", _tree(6), CPU, static_mb=1.0, source=a)
    assert mgr.register("k", _tree(6), CPU, static_mb=1.0, source=a) is ea
    eb = mgr.register("k", _tree(7), CPU, static_mb=1.0, source=b)
    assert eb is not ea and eb.key == "k" and ea.key != "k"
    assert torch.equal(mgr.acquire(ea)["x"], _tree(6)["x"])
    assert torch.equal(mgr.acquire(eb)["x"], _tree(7)["x"])
    for e in (ea, ea, eb):
        mgr.release(e)
    assert mgr.stats()["entries"] == 0


def test_manager_sequence_matches_jax_manager():
    """The same registrations and acquires (a round robin over five entries
    of different sizes, then prefetches) give the JAX manager's counters
    and resident set after every step."""
    sizes = [1.0, 2.0, 1.5, 0.5, 2.5]
    ours, theirs = ResidencyManager(budget_mb=4.0), JaxResidencyManager(budget_mb=4.0)
    eo = [ours.register(i, _tree(i), CPU, static_mb=m) for i, m in enumerate(sizes)]
    ej = [theirs.register(i, {"x": _tree(i)["x"].numpy()}, None, static_mb=m)
          for i, m in enumerate(sizes)]
    order = [0, 1, 2, 3, 4, 0, 2, 4, 1, 3, 3, 0]
    for i in order:
        ours.acquire(eo[i])
        theirs.acquire(ej[i])
        assert ours.stats() == theirs.stats(), i
        assert sorted(ours.resident_keys()) == sorted(theirs.resident_keys())
    for i in (1, 4, 2):
        assert ours.prefetch(eo[i]) == theirs.prefetch(ej[i])
        assert ours.stats() == theirs.stats()
    for a, b in zip(eo, ej):
        ours.release(a)
        theirs.release(b)
    assert ours.stats() == theirs.stats()


# -- inside the engine handle -----------------------------------------------------


def test_thrash_round_robin_bitwise_and_counters_match_spans(
        jax_scenes, scenes, cfg, single_thread):
    """Commit 4 scenes at 2x the budget and render round robin for two laps:
    every image is bitwise an unbudgeted handle's, eviction happened, the
    counters equal the residency/* spans, and the page-in/page-out sequence
    and each entry's static MB equal the JAX manager's under the JAX
    handles' acquires of the same order."""
    cam = _cam()
    refs = []
    for s in scenes:
        with engine.open(s, cfg, device="cpu") as h:
            refs.append(h.render(cam).image)
            budget = 2.2 * _cost(h)

    c0 = {k: _counter(f"residency.{k}_total") for k in ("page_ins", "page_outs")}
    prev = set_tracer(Tracer(enabled=True))
    jmgr = JaxResidencyManager(budget_mb=budget, name="thrash")
    jhandles = [jax_engine.open(s, JConfig(**CFG_KW), residency=jmgr) for s in jax_scenes]
    try:
        mgr = ResidencyManager(budget_mb=budget, name="thrash")
        handles = [engine.open(s, cfg, device="cpu", residency=mgr) for s in scenes]
        assert mgr.stats() == jmgr.stats()
        for h, jh in zip(handles, jhandles):
            assert h._res_entry.static_mb == jh._res_entry.static_mb
        for lap in range(2):
            for i, (h, jh) in enumerate(zip(handles, jhandles)):
                img = h.render(cam).image
                jh._scene                       # the JAX render's one acquire
                assert torch.equal(img, refs[i]), f"scene {i} lap {lap} diverged after paging"
                assert mgr.stats() == jmgr.stats(), (lap, i)
        s = mgr.stats()
        assert s["page_outs"] > 0, "thrash at 2x budget never evicted"
        assert s["page_ins"] > len(handles), "no scene ever paged back in"
        assert s["resident_mb"] <= budget + 1e-9

        names = [e.name for e in get_tracer().events()]
        assert names.count("residency/page_in") == (
            _counter("residency.page_ins_total") - c0["page_ins"])
        assert names.count("residency/page_out") == (
            _counter("residency.page_outs_total") - c0["page_outs"])
        for h in handles:
            h.close()
        assert mgr.stats()["entries"] == 0
    finally:
        for jh in jhandles:
            jh.close()
        set_tracer(prev)


def test_backing_is_a_copy_of_the_callers_scene(scenes, cfg, single_thread):
    """The backing store never aliases the caller's tensors: a scene changed
    in place after the commit renders, after an eviction and a page-in, as
    it was at the commit."""
    src = scene_from_numpy({k: v.numpy() for k, v in vars(scenes[0]).items()}, "cpu")
    cam = _cam()
    mgr = ResidencyManager()
    with engine.open(src, cfg, device="cpu", residency=mgr) as h:
        want = h.render(cam).image
        backing = vars(h._res_entry.backing).values()
        assert all(b.data_ptr() != a.data_ptr() for a, b in zip(vars(src).values(), backing))
        src.means3d.add_(0.5)
        src.opacity.fill_(-10.0)
        mgr.budget_mb = 1.5 * _cost(h)           # holds one scene: the next commit evicts
        with engine.open(scenes[1], cfg, device="cpu", residency=mgr):
            assert not h.resident
            assert torch.equal(h.render(cam).image, want)


def test_open_via_manager_single_scene_over_budget_raises(scenes, cfg):
    """A scene that cannot fit the budget even alone refuses to commit under
    a shared manager (paging cannot help)."""
    mgr = ResidencyManager(budget_mb=1e-4)
    with pytest.raises(ValueError, match="over the"):
        engine.open(scenes[0], cfg, device="cpu", residency=mgr)


def test_frontend_cache_counted_against_budget(scenes, cfg, single_thread):
    """Stream sessions' frontend caches hold device memory: they show in
    stats()['frontend_cache_mb'] and in the residency entry's dynamic cost,
    and a closed stream drops them."""
    with engine.open(scenes[0], cfg, device="cpu") as h:
        assert h.stats()["frontend_cache_mb"] == 0.0
        stream = h.open_stream(cache_frames=4, speculate=False)
        for cam in orbit_cameras(3, 4.5, 64, 64):
            stream.render(cam)
        mb = h.stats()["frontend_cache_mb"]
        assert mb > 0.0, "cached FrontendResults invisible to the budget"
        assert mb == pytest.approx(stream.cache_bytes() / 2**20)
        assert stream.stats()["cache_bytes"] == stream.cache_bytes()
        entry = h._res_entry
        assert entry.cost_mb() == pytest.approx(entry.static_mb + mb)
        stream.close()
        assert h.stats()["frontend_cache_mb"] == 0.0


# -- inside the server ------------------------------------------------------------


def test_server_overbudget_commit_evicts_instead_of_failing(scenes, cfg, single_thread):
    """A server budgeted for ~1 scene commits and serves 3: commits evict
    cold scenes, every request completes bitwise like an unbudgeted run,
    and the eviction counters are nonzero."""
    from repro_torch.serving import RenderRequest, RenderServer

    named = {f"s{i}": scenes[i] for i in range(3)}
    cam = _cam()
    with engine.open(named["s0"], cfg, device="cpu") as probe:
        cost = _cost(probe)

    def load():
        return [(0.0, RenderRequest(i, f"s{i % 3}", cam, cfg)) for i in range(6)]

    prev = set_tracer(Tracer(enabled=True))
    c0 = get_registry().snapshot()["counters"]
    try:
        with RenderServer(named, device="cpu", device_budget_mb=1.5 * cost,
                          max_batch=2, max_wait=0.0) as budgeted:
            res = budgeted.run(load(), realtime=False)
            assert sorted(res) == list(range(6))
            s = budgeted.residency.stats()
            assert s["evictions"] > 0 and s["page_outs"] > 0
            assert len(budgeted.resident_scene_ids) < len(budgeted.committed_scene_ids)
        c1 = get_registry().snapshot()["counters"]
        delta = {k: v - c0.get(k, 0) for k, v in c1.items() if k.startswith("residency.")}
        assert validate_residency_trace(get_tracer().chrome_trace(), delta) == []
    finally:
        set_tracer(prev)

    with RenderServer(named, device="cpu", max_batch=2, max_wait=0.0) as unbudgeted:
        ref = unbudgeted.run(load(), realtime=False)
        assert unbudgeted.residency.stats()["page_outs"] == 0
    for i in ref:
        assert torch.equal(res[i].image, ref[i].image), f"request {i}: paging moved pixels"


def test_server_admission_prefetch_pages_in(scenes, cfg):
    """An admitted request for a committed but paged-out scene pages it back
    in at admission, counted as a prefetch."""
    from repro_torch.serving import RenderRequest, RenderServer

    named = {"a": scenes[0], "b": scenes[1]}
    with engine.open(named["a"], cfg, device="cpu") as probe:
        cost = _cost(probe)
    server = RenderServer(named, device="cpu", device_budget_mb=1.5 * cost)
    try:
        server.commit("a", cfg)
        server.commit("b", cfg)                # evicts a (the budget holds one)
        assert server.resident_scene_ids == frozenset({"b"})
        pre = server.residency.stats()["prefetches"]
        assert server.submit(RenderRequest(0, "a", _cam(), cfg))
        assert "a" in server.resident_scene_ids, "admission did not prefetch"
        assert server.residency.stats()["prefetches"] == pre + 1
    finally:
        server.close()


def test_server_close_is_terminal(scenes, cfg):
    from repro_torch.serving import RenderServer

    server = RenderServer({"scene": scenes[0]}, device="cpu")
    server.commit("scene", cfg)
    server.close()
    assert server._renderers == {}
    with pytest.raises(RuntimeError, match="closed"):
        server.commit("scene", cfg)
    server.close()                             # idempotent
