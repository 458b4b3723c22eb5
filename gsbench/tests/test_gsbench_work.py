"""The work counts behind the roofline shares and ``frame_mfu``."""
import re

import pytest
import torch

from gsbench import work
from gsbench.cell import TraceData, scene_bytes
from gsbench.harness import BENCH, ROOT, load_metric, load_spec
from gsbench.reference import render as ref
from gsbench.scene import orbit_camera, scene_for, to_program, to_program_scene

TINY = {"name": "train", "gaussians": 3000, "extent": 5.0, "width": 96, "height": 64}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_counts_depend_only_on_the_inputs():
    """The same scene and camera give the same operations and bytes
    whichever program backend rendered the frame: the counts are the
    reference's, and they agree with both backends' counters."""
    from repro_torch.core.pipeline import RenderConfig, render

    scene = scene_for(TINY, 99, "cpu")
    cam = orbit_camera(TINY, 15.0)
    counts = ref.render(scene, cam).counts
    again = ref.render(scene, cam).counts
    assert counts == again
    nb = scene_bytes(scene)
    for backend in ("reference", "cuda"):
        cfg = RenderConfig(mode="gstg", group_capacity=4096, tile_capacity=4096, span=16,
                           backend=backend)
        with torch.inference_mode():
            stats = render(to_program_scene(scene), to_program(cam), cfg).stats.as_dict()
        assert stats["n_pairs_sort"] == counts["group_entries"]
        assert stats["n_bit_tests"] >= counts["entry_tile_tests"]
        assert work.frame(counts, nb, 96, 64) == work.frame(again, nb, 96, 64)


@pytest.mark.parametrize("metric", ["frame_mfu", "roofline.bgm", "roofline.fused_rm"])
def test_shares_stay_at_or_below_100_at_the_bound(metric):
    counts = ref.render(scene_for(TINY, 5, "cpu"), orbit_camera(TINY, 0.0)).counts
    nb = 3000 * 14 * 4
    least = {"frame_mfu": work.frame(counts, nb, 96, 64),
             "roofline.bgm": work.bgm(counts),
             "roofline.fused_rm": work.fused_rm(counts, 96, 64)}[metric]
    t = work.least_seconds(*least)[0]
    reader = load_metric(metric)
    kernel = getattr(reader, "KERNEL", "k")

    def trace_at(seconds):
        frame = {"wall_s": seconds, "window": (0.0, 1.0), "counts": counts}
        return TraceData(width=96, height=64, scene_bytes=nb, frames_a=[frame],
                         ops=[(0.0, seconds, f"void {kernel}<4>(float*)")])

    assert reader.read(trace_at(t)) == pytest.approx(100.0)
    assert reader.read(trace_at(t * 1.5)) < 100.0
    assert reader.read(TraceData(frames_a=[{"wall_s": 1.0, "window": (0, 1), "counts": None}])) is None


def test_peaks_and_least_time():
    assert work.least_seconds(3.35e12, 0) == (1.0, "bytes")
    assert work.least_seconds(0, 67e12) == (1.0, "operations")


def test_names_and_units_use_allowed_characters():
    spec = load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for path in BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path
