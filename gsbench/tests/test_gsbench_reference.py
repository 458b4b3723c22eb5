"""The plain reference against the port's ``reference`` backend at a tiny
size on the CPU, and its lists against no lists at all."""
import dataclasses

import pytest
import torch

from gsbench import check
from gsbench.reference import render as ref
from gsbench.scene import orbit_camera, scene_for, to_program, to_program_scene

TINY = {"name": "train", "gaussians": 4000, "extent": 5.0, "width": 96, "height": 64}


def program_frame(scene, cam, backend="reference", **kw):
    from repro_torch.core.pipeline import RenderConfig, render

    cfg = RenderConfig(mode="gstg", tile=16, group=64, boundary_group="ellipse",
                       boundary_tile="ellipse", group_capacity=4096, tile_capacity=4096,
                       span=16, chunk=32, backend=backend, **kw)
    with torch.inference_mode():
        return render(to_program_scene(scene), to_program(cam), cfg)


@pytest.mark.parametrize("azimuth", [0.0, 37.0, 211.5])
def test_reference_matches_the_ports_reference_backend(azimuth):
    scene = scene_for(TINY, 12345, "cpu")
    cam = orbit_camera(TINY, azimuth)
    want = ref.render(scene, cam)
    got = program_frame(scene, cam)
    stats = got.stats.as_dict()
    assert stats["overflow"] == 0 and stats["span_overflow"] == 0
    gap = check.image_gap(got.image, want.image)
    # Independent float32 code: features agree to a few ulps, and a splat
    # sitting on a cut-off (q = 9 or alpha = 1/255) may appear on one side
    # only, about 1/255 of one pixel's colour.
    assert gap["rmse"] < 1e-4 and gap["max_abs"] < 1e-2, gap
    c = want.counts
    assert c["visible"] == stats["n_visible"]
    assert c["group_entries"] == stats["n_pairs_sort"]
    assert c["tile_entries"] == stats["tile_entries"]
    assert abs(c["alpha_tests"] - stats["alpha_ops"]) <= 1e-3 * stats["alpha_ops"]
    assert abs(c["blends"] - stats["blend_ops"]) <= 1e-3 * stats["blend_ops"]


def piled_scene(n: int) -> dict:
    """``n`` small opaque-ish gaussians around one point, all on one tile's
    list, more than the program's capacities below hold."""
    g = torch.Generator().manual_seed(7)
    means = torch.zeros(n, 3) + torch.randn(n, 3, generator=g) * 0.01
    return {"means3d": means, "log_scales": torch.full((n, 3), -3.5),
            "quats": torch.randn(n, 4, generator=g), "opacity": torch.full((n,), -1.0),
            "sh": ((torch.rand(n, 1, 3, generator=g) - 0.5) / ref.SH_C0)}


def test_reference_lists_are_never_cut():
    scene = piled_scene(3000)
    cam = orbit_camera({**TINY, "extent": 1.0}, 0.0)
    frame = ref.render(scene, cam)
    # Every visible gaussian sits on the centre tile's list.
    assert frame.counts["longest_tile_list"] == frame.counts["visible"] > 2048
    # No lists at all: every gaussian tested at every pixel, one at a time.
    dense = ref.dense_render(scene, cam)
    assert check.image_gap(frame.image, dense)["max_abs"] < 1e-5
    # The program agrees with capacities that hold the list, and drops
    # entries and misses with capacities that do not.
    whole = program_frame(scene, cam)
    assert check.image_gap(whole.image, frame.image)["max_abs"] < 1e-4
    from repro_torch.core.pipeline import RenderConfig, render

    cfg = dataclasses.replace(RenderConfig(), group_capacity=1024, tile_capacity=512, span=16)
    with torch.inference_mode():
        cut = render(to_program_scene(scene), to_program(cam), cfg)
    assert cut.stats.as_dict()["overflow"] > 0
    assert check.image_gap(cut.image, frame.image)["max_abs"] > 1e-3


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -2.5, float("inf")])
    y = ref.round_tf32(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -2.5, float("inf")]
