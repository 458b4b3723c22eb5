"""Port parity end to end: repro_torch render against repro.core.pipeline
render (image atol/rtol 1e-5 — looser than per stage because projection
drifts by ulps between XLA and torch — and integer counters equal), the
losslessness of gstg on the port, the engine handle, and import isolation."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import GaussianScene as JScene, make_camera, random_scene
from repro.core.pipeline import RenderConfig as JConfig
from repro_torch import engine
from repro_torch.core import camera, pipeline
from repro_torch.core.gaussians import scene_from_numpy
from torch_parity import IMAGE_TOL as TOL
from torch_parity import assert_counters_equal, n, single_thread  # noqa: F401

GOLDEN = Path(__file__).resolve().parent / "golden"
SMALL_CAM = dict(eye=(0.0, 1.0, 4.5), target=(0.0, 0.0, 0.0), width=96, height=96)
SMALL_CFG = dict(group_capacity=256, tile_capacity=256)


def _golden(name):
    data = np.load(GOLDEN / f"{name}.npz")
    scene = JScene(**{f.name: data[f"scene_{f.name}"] for f in dataclasses.fields(JScene)})
    cam_kw = json.loads(bytes(data["camera_json"]).decode())
    cfg_kw = json.loads(bytes(data["config_json"]).decode())
    return scene, cam_kw, cfg_kw


def _check_against_reference(jit_render_fn, jscene, cam_kw, cfg_kw, backend):
    want = jit_render_fn(jscene, make_camera(**cam_kw), JConfig(**cfg_kw))
    got = pipeline.render(
        scene_from_numpy(jscene, "cpu"), camera.make_camera(**cam_kw),
        pipeline.RenderConfig(backend=backend, **cfg_kw),
    )
    np.testing.assert_allclose(n(got.image), np.asarray(want.image), **TOL)
    assert_counters_equal(got.stats.as_dict(), want.stats)
    assert got.stats.as_dict()["overflow"] == 0
    return got, want


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("name", ["mini_gstg", "aabb_lossless", "tile_base"])
def test_render_matches_reference_on_golden_scenes(jit_render_fn, name, backend):
    _check_against_reference(jit_render_fn, *_golden(name), backend)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("mode", ["gstg", "tile_baseline", "group_baseline"])
def test_render_matches_reference_small_scene(jit_render_fn, mode, backend):
    jscene = random_scene(jax.random.key(5), 400, extent=3.0)
    _check_against_reference(jit_render_fn, jscene, SMALL_CAM,
                             dict(mode=mode, **SMALL_CFG), backend)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_cut_lists_break_losslessness_in_both_packages(jit_render_fn, backend):
    """With span_overflow > 0 the static span window drops group-aligned bins
    in gstg and tile-aligned bins in tile_baseline, so the two modes lose
    different entries and their images differ. That is the JAX package's own
    behaviour, and the port reproduces it mode by mode."""
    jscene = random_scene(jax.random.key(5), 400, extent=3.0)
    cam_kw = dict(SMALL_CAM, eye=(0.0, 0.5, 2.5))
    images = {}
    for mode in ("gstg", "tile_baseline"):
        got, want = _check_against_reference(
            jit_render_fn, jscene, cam_kw, dict(mode=mode, span=1, **SMALL_CFG), backend)
        assert float(want.stats.span_overflow) > 0
        images[mode] = (np.asarray(want.image), n(got.image))
    (jax_gstg, port_gstg), (jax_tile, port_tile) = images["gstg"], images["tile_baseline"]
    assert np.abs(jax_gstg - jax_tile).max() > 0.1
    assert np.abs(port_gstg - port_tile).max() > 0.1


# Tile 8 in groups of 64: 64 member tiles a group, past the 32-bit tile mask.
GF8_CAM = dict(eye=(0.0, 1.1, 4.6), target=(0.0, 0.0, 0.0), width=64, height=64)
GF8_CFG = dict(tile=8, group=64, group_capacity=512, tile_capacity=512, span=8)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("mode", ["tile_baseline", "group_baseline"])
def test_baselines_render_with_64_member_tiles(jit_render_fn, mode, backend):
    """The baselines take no member-tile mask, so they still render where
    gstg is refused, and match the JAX package there."""
    jscene = random_scene(jax.random.key(7), 400, extent=3.0)
    _check_against_reference(jit_render_fn, jscene, GF8_CAM, dict(mode=mode, **GF8_CFG),
                             backend)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_gstg_refuses_more_than_32_member_tiles(small_scene, backend):
    """One mask bit per member tile: gstg at 64 tiles a group raises on every
    backend and entry point, CPU tensors included, instead of rendering wrong
    masks (the JAX package drops member tiles 32 and up there)."""
    cfg = pipeline.RenderConfig(backend=backend, **GF8_CFG)
    cam = camera.make_camera(**GF8_CAM)
    front = pipeline.render_frontend(small_scene, cam,
                                     dataclasses.replace(cfg, mode="tile_baseline"))
    calls = (
        lambda: pipeline.render(small_scene, cam, cfg),
        lambda: pipeline.render_frontend(small_scene, cam, cfg),
        lambda: pipeline.render_backend(front, cam, cfg),
        lambda: engine.open(small_scene, cfg, device="cpu"),
    )
    for call in calls:
        with pytest.raises(ValueError, match="32-bit tile mask"):
            call()
    ok = dataclasses.replace(cfg, tile=16)  # 16 member tiles a group
    assert pipeline.render(small_scene, cam, ok).stats.as_dict()["overflow"] == 0


@pytest.fixture(scope="module")
def small_scene():
    return scene_from_numpy(random_scene(jax.random.key(7), 400, extent=3.0), "cpu")


def test_gstg_bitwise_equals_tile_baseline_on_the_port(small_scene):
    """The paper's losslessness on the port's reference backend: with no
    list cut (overflow and span_overflow 0) the images are bitwise equal."""
    cam = camera.make_camera((0.0, 1.1, 4.6), (0, 0, 0), 128, 128)
    cfg = pipeline.RenderConfig(group_capacity=512, tile_capacity=512)
    ours = pipeline.render(small_scene, cam, cfg)
    base = pipeline.render(small_scene, cam, dataclasses.replace(cfg, mode="tile_baseline"))
    for stats in (ours.stats.as_dict(), base.stats.as_dict()):
        assert stats["overflow"] == 0 and stats["span_overflow"] == 0
    assert torch.equal(ours.image, base.image)
    assert ours.stats.as_dict()["n_pairs_sort"] < base.stats.as_dict()["n_pairs_sort"]


def test_frontend_backend_compose_to_render(small_scene):
    cam = camera.make_camera(**SMALL_CAM)
    cfg = pipeline.RenderConfig(backend="cuda", **SMALL_CFG)
    whole = pipeline.render(small_scene, cam, cfg)
    split = pipeline.render_backend(pipeline.render_frontend(small_scene, cam, cfg), cam, cfg)
    assert torch.equal(whole.image, split.image)
    assert whole.stats.as_dict() == split.stats.as_dict()


def test_engine_open_on_cpu_equals_render(small_scene):
    cam = camera.make_camera(**SMALL_CAM)
    cfg = pipeline.RenderConfig(backend="cuda", **SMALL_CFG)
    bg = [0.2, 0.1, 0.0]
    want = pipeline.render(small_scene, cam, cfg, torch.tensor(bg))
    with engine.open(small_scene, cfg, device="cpu") as r:
        got = r.render(cam, background=bg)
        assert torch.equal(got.image, want.image)
        assert got.stats.as_dict() == want.stats.as_dict()
        assert torch.equal(r.render_batch([cam], background=bg).image[0], want.image)
        assert r.stats()["device"] == "cpu"
    with pytest.raises(RuntimeError):
        r.render(cam)
    # residency= (once unported) commits through a shared manager: a second
    # commit over a budget that holds one evicts the first, which renders
    # bitwise after its page-in.
    from repro_torch.residency import ResidencyManager

    mgr = ResidencyManager()
    with engine.open(small_scene, cfg, device="cpu", residency=mgr) as r:
        st = r.stats()
        mgr.budget_mb = 1.5 * (st["scene_mb_per_device"] + st["feature_mb_per_device"])
        with engine.open(small_scene, cfg, device="cpu", scene_shards=2, residency=mgr):
            assert not r.resident and mgr.stats()["evictions"] == 1
            assert torch.equal(r.render(cam, background=bg).image, want.image) and r.resident


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_scene_shards_config_renders_like_one_shard(small_scene, backend):
    """scene_shards=2 (once an unported config) renders bitwise like one
    shard through render, render_batch and engine.open, which commits the
    two shards and reports them."""
    cam = camera.make_camera(**SMALL_CAM)
    cfg = pipeline.RenderConfig(backend=backend, **SMALL_CFG)
    want = pipeline.render(small_scene, cam, cfg)
    two = dataclasses.replace(cfg, scene_shards=2)
    outs = [pipeline.render(small_scene, cam, two),
            pipeline.render_batch(small_scene, [cam], two).map(lambda x: x[0])]
    with engine.open(small_scene, two, device="cpu") as r:
        outs.append(r.render(cam))
        assert (r.scene_shards, r.stats()["scene_shards"], r.stats()["feature_gather"]) == (
            2, 2, "index")
    for got in outs:
        assert torch.equal(got.image, want.image)
        assert got.stats.as_dict() == want.stats.as_dict()


@pytest.mark.parametrize("change", [dict(timing=True)])
def test_unported_config_raises(small_scene, change, single_thread):
    """A config the port once refused (timing=True, ROADMAP item 9) now
    renders bitwise like the plain config through render and engine.open,
    on both backends, and the JAX package's counters agree."""
    from repro.core.pipeline import render as jax_render

    cam = camera.make_camera(**SMALL_CAM)
    jscene = random_scene(jax.random.key(7), 400, extent=3.0)
    for backend in ("reference", "cuda"):
        plain = pipeline.RenderConfig(backend=backend, **SMALL_CFG)
        cfg = dataclasses.replace(plain, **change)
        want = pipeline.render(small_scene, cam, plain)
        outs = [pipeline.render(small_scene, cam, cfg)]
        with engine.open(small_scene, cfg, device="cpu") as r:
            outs.append(r.render(cam))
        for got in outs:
            assert torch.equal(got.image, want.image)
            assert got.stats.as_dict() == want.stats.as_dict()
    ref = jax_render(jscene, make_camera(**SMALL_CAM), JConfig(**SMALL_CFG, **change))
    np.testing.assert_allclose(n(want.image), np.asarray(ref.image), **TOL)
    assert_counters_equal(want.stats.as_dict(), ref.stats)


def test_unknown_feature_gather_raises_in_both_packages(small_scene):
    """Both packages refuse an unknown feature_gather with the same
    ValueError, at every entry point of the port."""
    from repro.core.pipeline import render as jax_render

    jscene = random_scene(jax.random.key(7), 400, extent=3.0)
    with pytest.raises(ValueError, match="unknown feature_gather") as want:
        jax_render(jscene, make_camera(**SMALL_CAM), JConfig(feature_gather="bogus"))
    cam = camera.make_camera(**SMALL_CAM)
    for backend in ("reference", "cuda"):
        cfg = pipeline.RenderConfig(backend=backend, feature_gather="bogus", **SMALL_CFG)
        front = pipeline.render_frontend(
            small_scene, cam, dataclasses.replace(cfg, feature_gather="auto"))
        calls = (
            lambda: pipeline.render(small_scene, cam, cfg),
            lambda: pipeline.render_frontend(small_scene, cam, cfg),
            lambda: pipeline.render_backend(front, cam, cfg),
            lambda: pipeline.render_batch(small_scene, [cam], cfg),
            lambda: engine.open(small_scene, cfg, device="cpu"),
        )
        for call in calls:
            with pytest.raises(ValueError) as got:
                call()
            assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_every_feature_gather_renders_alike(small_scene, backend):
    """With one shard every strategy is the flat gather: auto, index, psum
    and flat render the same image and counters."""
    cam = camera.make_camera(**SMALL_CAM)
    outs = [pipeline.render(small_scene, cam, pipeline.RenderConfig(
        backend=backend, feature_gather=fg, **SMALL_CFG)) for fg in ("auto", "index", "psum", "flat")]
    for out in outs[1:]:
        assert torch.equal(out.image, outs[0].image)
        assert out.stats.as_dict() == outs[0].stats.as_dict()


def test_core_exports_every_reference_name():
    """Every name of repro.core.__all__ imports from repro_torch.core;
    ``frontend_stats`` (once unported, item 11) gives the JAX package's
    counters by value, and the deprecated free functions are the pipeline's
    shims."""
    import repro.core
    import repro_torch.core
    from repro.autotune import stats_pass as jax_stats_pass

    missing = [name for name in repro.core.__all__ if name not in repro_torch.core.__all__]
    assert not missing, missing
    for name in repro.core.__all__:
        assert getattr(repro_torch.core, name) is not None
    jscene = random_scene(jax.random.key(5), 400, extent=3.0)
    cfg_kw = dict(SMALL_CFG, span=6)
    got = repro_torch.core.frontend_stats(
        scene_from_numpy(jscene, "cpu"), camera.make_camera(**SMALL_CAM),
        pipeline.RenderConfig(**cfg_kw))
    assert_counters_equal(got.as_dict(), jax_stats_pass(jscene, make_camera(**SMALL_CAM),
                                                        JConfig(**cfg_kw)))
    assert repro_torch.core.render_jit is pipeline.render_jit
    assert repro_torch.core.render_image is pipeline.render_image


def test_entry_points_default_to_cuda(small_scene):
    """Without a device the entry points go to CUDA, and raise when it is
    missing rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from repro_torch.core.gaussians import random_scene as port_random_scene
    from repro_torch.core.gaussians import scene_like_paper

    with pytest.raises(RuntimeError, match="CUDA"):
        engine.open(small_scene, pipeline.RenderConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        port_random_scene(10)
    with pytest.raises(RuntimeError, match="CUDA"):
        scene_like_paper("train", 10)
    cpu = scene_like_paper("train", 64, device="cpu")
    assert cpu.device.type == "cpu" and cpu.num_gaussians == 64


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.engine, repro_torch.configs\n"
        "import repro_torch.kernels.bitmask_gen, repro_torch.kernels.raster_tile\n"
        "import repro_torch.kernels.bitonic_sort, repro_torch.obs, repro_torch.serving\n"
        "import repro_torch.serving.sharded, repro_torch.utils\n"
        "import repro_torch.sharding, repro_torch.sharding.scene, repro_torch.launch.mesh\n"
        "from repro_torch.sharding import ShardedScene\n"
        "import repro_torch.optim, repro_torch.core.train, repro_torch.core.metrics\n"
        "import repro_torch.core.cost_model, repro_torch.examples.train_gaussians\n"
        "import repro_torch.launch.render, repro_torch.launch.render_serve\n"
        "import repro_torch.residency, repro_torch.engine.stream\n"
        "import repro_torch.serving.stats, repro_torch.serving.server\n"
        "import repro_torch.autotune, repro_torch.autotune.cache, repro_torch.autotune.search\n"
        "import repro_torch.ft, repro_torch.checkpoint, repro_torch.launch.render_gateway\n"
        "import repro_torch.gateway, repro_torch.gateway.worker, repro_torch.gateway.transport\n"
        "import repro_torch.gateway.worker_main, repro_torch.sharding.policies\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    subprocess.run([sys.executable, "-c", code], check=True, env={"PYTHONPATH": str(src)},
                   timeout=120)
