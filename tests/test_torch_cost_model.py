"""Port of tests/test_cost_model.py: the port's copy of the analytic cost
model (repro_torch.core.cost_model) on the port's counters. On the scene
and camera of the reference's tests, the port's counters equal the JAX
package's, and the port's estimate on them equals the reference's
StageCosts exactly (the same float64 arithmetic on equal counters). The
model's outputs are estimates for the paper's ASIC, not measured times."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from conftest import jit_render
from repro.core import cost_model as jcm
from repro.core.pipeline import RenderConfig as JConfig
from repro_torch.core import pipeline
from repro_torch.core.cost_model import GSTG_ASIC, GSTG_GPU_MODEL, StageCosts, estimate
from repro_torch.core.gaussians import scene_from_numpy
from repro_torch.core.camera import make_camera
from torch_parity import assert_counters_equal

MODES = ("gstg", "tile_baseline", "group_baseline")


@pytest.fixture(scope="module")
def stats(small_scene, cam256):
    """(port stats, JAX stats) per mode, on the reference tests' scene and
    camera (800 gaussians, 256x192) and its default capacities."""
    port_scene = scene_from_numpy(small_scene, "cpu")
    port_cam = make_camera((0.0, 1.2, 5.0), (0, 0, 0), 256, 192)
    assert np.array_equal(port_cam.R, cam256.R) and port_cam.fx == cam256.fx
    out = {}
    for mode in MODES:
        want = jit_render(small_scene, cam256, JConfig(mode=mode)).stats
        got = pipeline.render(port_scene, port_cam, pipeline.RenderConfig(mode=mode)).stats
        out[mode] = (got, want)
    return out


@pytest.mark.parametrize("execution", ["asic", "gpu"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hw", ["asic", "gpu_model"])
def test_estimate_on_port_counters_equals_reference(stats, mode, execution, hw):
    got, want = stats[mode]
    assert_counters_equal(got.as_dict(), want)
    port_hw, ref_hw = {"asic": (GSTG_ASIC, jcm.GSTG_ASIC),
                       "gpu_model": (GSTG_GPU_MODEL, jcm.GSTG_GPU_MODEL)}[hw]
    assert dataclasses.asdict(port_hw) == dataclasses.asdict(ref_hw)
    mine = estimate(got, port_hw, mode=mode, execution=execution)
    ref = jcm.estimate(want, ref_hw, mode=mode, execution=execution)
    assert mine.as_dict() == ref.as_dict()
    assert all(isinstance(v, float) for v in mine.as_dict().values())


def test_gstg_faster_than_tile_baseline(stats):
    cb = estimate(stats["tile_baseline"][0], GSTG_ASIC, mode="tile_baseline")
    co = estimate(stats["gstg"][0], GSTG_ASIC, mode="gstg", execution="asic")
    assert co.total_s < cb.total_s
    # the win comes from sorting, not rasterization
    assert co.sort_s < cb.sort_s
    assert abs(co.raster_s - cb.raster_s) / max(cb.raster_s, 1e-12) < 0.35


def test_asic_overlap_beats_gpu_serialization(stats):
    ours = stats["gstg"][0]
    asic = estimate(ours, GSTG_ASIC, mode="gstg", execution="asic")
    gpu = estimate(ours, GSTG_ASIC, mode="gstg", execution="gpu")
    assert asic.total_s <= gpu.total_s


def test_energy_positive_and_gstg_wins(stats):
    eb = estimate(stats["tile_baseline"][0], GSTG_ASIC, mode="tile_baseline").energy_j
    eo = estimate(stats["gstg"][0], GSTG_ASIC, mode="gstg").energy_j
    assert eb > 0 and eo > 0
    assert eo < eb


def test_group_baseline_raster_penalty(stats):
    """Fig 13: large-tile baseline sorts less but rasterizes much more."""
    cb = estimate(stats["group_baseline"][0], GSTG_ASIC, mode="group_baseline")
    cs = estimate(stats["tile_baseline"][0], GSTG_ASIC, mode="tile_baseline")
    assert cb.sort_s < cs.sort_s
    assert cb.raster_s > cs.raster_s


def _fake_stats(tensors=False, **kw):
    base = dict(
        n_visible=1_000,
        n_candidate_tests=4_000,
        n_pairs_sort=8_000,
        sort_ops=6.0e5,
        n_bit_tests=16_000,
        fifo_ops=2_000,
        alpha_ops=5.0e5,
        tile_entries=3_000,
    )
    base.update(kw)
    if tensors:  # the port's counters: int64 tensors
        base = {k: torch.tensor(int(v), dtype=torch.int64) for k, v in base.items()}
    return types.SimpleNamespace(**base)


def test_estimate_takes_tensor_counters():
    """Counters as tensors (the port's) or as Python numbers give the same
    StageCosts."""
    for execution in ("asic", "gpu"):
        a = estimate(_fake_stats(tensors=True), GSTG_ASIC, mode="gstg", execution=execution)
        b = estimate(_fake_stats(), GSTG_ASIC, mode="gstg", execution=execution)
        assert a == b
        assert a.as_dict() == jcm.estimate(_fake_stats(), jcm.GSTG_ASIC, mode="gstg",
                                           execution=execution).as_dict()


def test_estimate_monotone_in_sort_ops():
    lo = estimate(_fake_stats(), GSTG_ASIC, mode="gstg", execution="gpu")
    hi = estimate(
        _fake_stats(sort_ops=6.0e8, n_pairs_sort=8.0e5),
        GSTG_ASIC, mode="gstg", execution="gpu",
    )
    assert hi.sort_s > lo.sort_s
    assert hi.total_s > lo.total_s
    assert hi.energy_j > lo.energy_j


def test_estimate_monotone_in_bit_tests():
    lo = estimate(_fake_stats(), GSTG_ASIC, mode="gstg", execution="gpu")
    hi = estimate(
        _fake_stats(n_bit_tests=1.6e8),
        GSTG_ASIC, mode="gstg", execution="gpu",
    )
    assert hi.bitmask_s > lo.bitmask_s
    assert hi.total_s > lo.total_s
    # the ASIC overlaps BGM with GSM, so bitmask growth must never cost MORE
    # there than under GPU serialization
    hi_asic = estimate(
        _fake_stats(n_bit_tests=1.6e8),
        GSTG_ASIC, mode="gstg", execution="asic",
    )
    assert hi_asic.total_s <= hi.total_s


def test_stage_costs_dict_round_trip():
    c = estimate(_fake_stats(), GSTG_ASIC, mode="gstg", execution="asic")
    d = c.as_dict()
    assert StageCosts.from_dict(d) == c
    # serialization drift fails loudly, never zero-fills
    with pytest.raises(ValueError):
        StageCosts.from_dict({**d, "bogus_stage_s": 1.0})
    short = dict(d)
    short.pop("sort_s")
    with pytest.raises(ValueError):
        StageCosts.from_dict(short)
