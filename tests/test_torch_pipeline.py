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
from torch_parity import assert_counters_equal, n

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.open(small_scene, cfg, device="cpu", residency=object())


@pytest.mark.parametrize("change", [dict(scene_shards=2), dict(timing=True)])
def test_unported_config_raises(small_scene, change):
    cfg = pipeline.RenderConfig(**change)
    cam = camera.make_camera(**SMALL_CAM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.render(small_scene, cam, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.open(small_scene, cfg, device="cpu")


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
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    subprocess.run([sys.executable, "-c", code], check=True, env={"PYTHONPATH": str(src)},
                   timeout=120)
