"""The check fails what it must: the TF32 control in the program's place,
and the program broken underneath the timed path, each driven through the
rest of a run on the CPU at a small size (the look for a card skipped)."""
import dataclasses
import time

import pytest
import torch

from gsbench.cell import Cell, run_cell
from gsbench.check import judge
from gsbench.reference import render as ref

TINY = {"config": {"gaussians": 3000, "width": 96, "height": 64,
                   "render": {"group_capacity": 4096, "tile_capacity": 2048, "span": 16}},
        # A loaded CPU can take many seconds a dispatch: the minute of grace
        # past the window is the card's.
        "traffic": {"rate_hz": 4.0, "server": {"max_batch": 2}, "warm": 1, "grace_s": 600.0,
                    "trace": {"profiled_frames": 3, "timed_frames": 2,
                              "profiled_seconds": 1.0, "span_seconds": 1.0}}}
# TF32's error grows with the focal length in pixels and the splats a
# pixel blends: at 96x64 it reads about the limit, at 384x256 with 20,000
# gaussians 1.7x over it, at the cells' own sizes 2.7x over it (PERF.md).
# The control's image is the reference's, whatever the program's lists.
CONTROL = {**TINY, "config": {**TINY["config"], "gaussians": 20000, "width": 384,
                              "height": 256}}
CPU = torch.device("cpu")
SEED = 2 ** 35 + 11


def run(cell, seconds=1.5, trace=False, overrides=TINY):
    torch.set_num_threads(2)
    return run_cell(cell, SEED, seconds, trace, CPU, t_start=time.perf_counter(),
                    overrides=overrides)


@pytest.mark.parametrize("cell", ["train.view", "train.pause", "train.serve"])
def test_sound_runs_are_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]


def tf32_frame(c, real):
    """The program's frame call with its image replaced by the reference's
    image of the same camera computed in TF32."""
    def control(cam):
        out = real(cam)
        img = ref.render(c.scene, ref.camera_of(cam), tf32=True).image
        return dataclasses.replace(out, image=img)

    return control


@pytest.mark.parametrize("cell", ["train.view", "train.pause", "train.serve"])
def test_the_tf32_control_fails_the_limits(cell, monkeypatch):
    """The reference computed in TF32 stands in the program's place: every
    frame (or served lane) the window drives is the control's image of its
    camera."""
    torch.set_num_threads(2)
    c = Cell(cell, SEED, CPU, overrides=CONTROL)
    c.setup()
    if cell == "train.serve":
        from repro_torch.engine import handle

        real = handle.Renderer.render_batch

        def control(self, cams, pad_to=None, background=None):
            out = real(self, cams, pad_to, background)
            img = out.image.clone()
            for i in range(len(cams)):
                img[i] = ref.render(c.scene, ref.camera_of(cams.camera(i)), tf32=True).image
            return dataclasses.replace(out, image=img)

        monkeypatch.setattr(handle.Renderer, "render_batch", control)
    else:
        c.loop.frame = tf32_frame(c, c.loop.frame)
    out = c.measure(1.5)
    correct, table = judge(out["readings"], c.config["limits"])
    assert table["rmse"]["value"] > table["rmse"]["limit"] and not correct, table


@pytest.fixture
def broken(monkeypatch):
    """Plant a fault under the timed path by name."""
    from repro_torch.engine import handle, stream

    def altered(real):
        def wrapper(self, *args, **kw):
            out = real(self, *args, **kw)
            img = out.image.clone()
            img[..., 16:32, 16:32, :] += 0.25
            return dataclasses.replace(out, image=img)

        return wrapper

    def plant(kind):
        if kind == "state_unchanged":      # every frame returns the first frame's answer
            first = {}
            real = handle.Renderer.render

            def stale(self, cam, background=None):
                return first.setdefault("out", real(self, cam, background))

            monkeypatch.setattr(handle.Renderer, "render", stale)
        elif kind == "stream_state_unchanged":   # the frontend cache ignores the pose
            monkeypatch.setattr(stream, "pose_key", lambda cam: b"one pose")
        elif kind == "answer_altered":
            monkeypatch.setattr(handle.Renderer, "render", altered(handle.Renderer.render))
        elif kind == "stream_answer_altered":
            monkeypatch.setattr(handle.Renderer, "render_backend",
                                altered(handle.Renderer.render_backend))
        elif kind == "lane_answer_altered":
            monkeypatch.setattr(handle.Renderer, "render_batch",
                                altered(handle.Renderer.render_batch))
        elif kind == "half_batch_left_out":      # the later half of the requests' lanes
            real = handle.Renderer.render_batch  # come back black (a lone request's too)

            def half(self, cams, pad_to=None, background=None):
                out = real(self, cams, pad_to, background)
                img = out.image.clone()
                img[len(cams) // 2:len(cams)] = 0.0
                return dataclasses.replace(out, image=img)

            monkeypatch.setattr(handle.Renderer, "render_batch", half)
        elif kind == "wrong_request":      # each request gets the one served before it
            from repro_torch.serving.server import RenderServer

            real = RenderServer._record
            carry = []

            def shifted(self, bucket, images, *args, **kw):
                carry.extend(images)
                moved = [torch.zeros_like(images[0])] + carry[:-1]
                return real(self, bucket, moved[-len(images):], *args, **kw)

            monkeypatch.setattr(RenderServer, "_record", shifted)

    return plant


# Every frame moves 5 degrees, so that a stale answer shows from the second
# frame on; a window that returns its state unchanged gets long enough for
# a second frame on a loaded CPU.
MOVES = {"step_deg": 5.0, "hold_share": 0.0, "hold_block": 1}


@pytest.mark.parametrize("cell,fault,seconds", [
    ("train.view", "state_unchanged", 15.0),
    ("train.view", "answer_altered", 4.0),
    ("train.pause", "stream_state_unchanged", 15.0),
    ("train.pause", "stream_answer_altered", 4.0),
    ("train.serve", "half_batch_left_out", 4.0),
    ("train.serve", "wrong_request", 4.0),
    ("train.serve", "lane_answer_altered", 4.0),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, seconds, broken):
    broken(fault)
    out = run(cell, seconds=seconds,
              overrides={**TINY, "traffic": {**TINY["traffic"], **MOVES}})
    # A stale state shows from the second frame on.
    stale = fault.endswith("state_unchanged")
    assert not out["correct"] and (not stale or out["attempted"] >= 2), \
        (out["attempted"], out["checks"])


def test_a_cut_list_is_not_correct():
    small = {**TINY, "config": {**TINY["config"],
                                "render": {"group_capacity": 64, "tile_capacity": 32, "span": 2}}}
    out = run("train.view", overrides=small)
    assert out["checks"]["cut_entries"]["value"] > 0 and not out["correct"]


def test_a_traced_run_checks_too(broken):
    broken("answer_altered")
    out = run("train.view", trace=True)
    assert not out["correct"] and set(out["metrics"]) >= {"stage_ms.project", "glue_ms",
                                                          "sort_keys", "frame_mfu"}
