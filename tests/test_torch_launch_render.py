"""The port's one-shot render CLI (``python -m repro_torch.launch.render``,
the counterpart of ``repro.launch.render``) on the CPU at 1,200 gaussians,
96x96, capacity 256: the printed counters equal an ``engine.open`` render of
the same scene and config, the PPM is written, ``--trace-json`` writes a
trace that validates with every stage span, ``--stats`` lists the
``timed_stage`` cache, ``--autotune`` prints the tuned triple and renders
at it, and ``configs.scene_and_camera`` gives the JAX helper's camera."""
from __future__ import annotations

import json
import re

import numpy as np
import pytest

from repro_torch import engine
from repro_torch.configs import scene_and_camera
from repro_torch.core.pipeline import RenderConfig
from repro_torch.launch import render as cli
from repro_torch.obs import Tracer, set_tracer, validate_chrome_trace
from torch_parity import single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")
SMALL = ["--device", "cpu", "--gaussians", "1200", "--width", "96", "--height", "96",
         "--capacity", "256"]
PRINTED = {"visible gaussians": "n_visible", "sort keys": "n_pairs_sort",
           "alpha ops": "alpha_ops", "overflow": "overflow"}


@pytest.fixture(autouse=True)
def fresh_tracer(tmp_path, monkeypatch):
    """Each run in its own working directory, on its own tracer."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    prev = set_tracer(Tracer(enabled=False))
    yield
    set_tracer(prev)


def _printed_counters(text: str) -> dict:
    return {key: int(re.search(rf"{name}\s*: (\d+)", text).group(1))
            for name, key in PRINTED.items()}


def _want(backend: str, mode: str = "gstg") -> dict:
    scene, cam = scene_and_camera("train", 1200, 96, 96, device="cpu")
    cfg = RenderConfig(mode=mode, tile_capacity=256, group_capacity=256, span=6,
                       backend=backend)
    with engine.open(scene, cfg, device="cpu") as r:
        stats = r.render(cam).stats.as_dict()
    return {key: stats[key] for key in PRINTED.values()}


@pytest.mark.parametrize("flags,backend", [
    (["--backend", "reference"], "reference"),
    (["--backend", "cuda"], "cuda"),
    (["--use-kernels"], "cuda"),
])
def test_cli_counters_match_engine_render(capsys, tmp_path, flags, backend):
    cli.main(SMALL + flags)
    out = capsys.readouterr().out
    assert _printed_counters(out) == _want(backend)
    assert "accelerator model : total=" in out
    ppm = tmp_path / "results" / f"render_train_gstg_{backend}.ppm"
    data = ppm.read_bytes()
    assert data.startswith(b"P6\n96 96\n255\n") and len(data) == 13 + 96 * 96 * 3


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_cli_trace_json_and_stats(capsys, tmp_path, backend):
    """--trace-json turns fenced timing on: the measured render's trace
    validates with all seven stage spans, and the counters are the untimed
    render's."""
    path = tmp_path / "trace" / "t.json"
    cli.main(SMALL + ["--backend", backend, "--stats", "--trace-json", str(path)])
    out = capsys.readouterr().out
    assert _printed_counters(out) == _want(backend)
    assert re.search(r"render cache \[timed_stage *\] : hits=\d+ misses=\d+", out)
    assert "per-stage device time (fenced, steady-state)" in out
    doc = json.loads(path.read_text())
    assert validate_chrome_trace(doc) == []
    stages = [e["name"] for e in doc["traceEvents"] if e.get("cat") == "stage"]
    assert len(set(stages)) >= 7 and stages.count("stage/render") == 1   # warm one cleared


def test_cli_repro_trace_env_times_tile_baseline(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "1")
    cli.main(SMALL + ["--backend", "cuda", "--mode", "tile_baseline", "--stats"])
    out = capsys.readouterr().out
    assert _printed_counters(out) == _want("cuda", "tile_baseline")
    assert "stage/rasterize" in out and "stage/bitmask" not in out


def test_cli_autotune_raises_naming_item_11(capsys, tmp_path, monkeypatch):
    """--autotune (once unported, item 11): the first render tunes, the first
    line names the triple, and the printed counters are an engine.open
    render's at that triple."""
    from repro_torch.autotune import cache as at_cache

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    at_cache._clear()
    try:
        cli.main(SMALL + ["--autotune"])
    finally:
        at_cache._clear()
    out = capsys.readouterr().out
    triple = tuple(int(x) for x in re.search(r"tile_params=\((\d+), (\d+), (\d+)\)",
                                             out).groups())
    scene, cam = scene_and_camera("train", 1200, 96, 96, device="cpu")
    cfg = RenderConfig(tile_capacity=256, group_capacity=256, span=6)
    with engine.open(scene, cfg, device="cpu", tile_params=triple) as r:
        stats = r.render(cam).stats.as_dict()
    assert _printed_counters(out) == {key: stats[key] for key in PRINTED.values()}
    assert (tmp_path / "at.json").exists()


def test_scene_and_camera_matches_jax_helper():
    from benchmarks.common import scene_and_camera as jax_scene_and_camera

    for width, height in ((None, None), (96, 64)):
        jscene, jcam = jax_scene_and_camera("truck", 64, width=width, height=height)
        scene, cam = scene_and_camera("truck", 64, width, height, device="cpu")
        assert scene.num_gaussians == 64 and scene.device.type == "cpu"
        assert (cam.width, cam.height) == (jcam.width, jcam.height)
        for f in ("R", "t", "fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(np.asarray(getattr(cam, f), np.float64),
                                       np.asarray(getattr(jcam, f), np.float64),
                                       rtol=0, atol=1e-6)
