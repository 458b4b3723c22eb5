"""The harness finds every part by name, its generators are fixed by the
seed, and it refuses to run without a card."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gsbench import drive
from gsbench.harness import BENCH, ROOT, load_spec, per_layer_for, resolve

SPEC = load_spec()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_its_parts_by_name(cell):
    parts = resolve(SPEC, cell)
    assert parts["config"]["name"] == parts["workload"]["config"]
    assert parts["traffic"]["name"] == parts["workload"]["traffic"]
    assert callable(parts["loop"].Loop)
    names = {m["name"] for m, _ in parts["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for meta, reader in parts["end_to_end"]:
        assert (reader is None) == (meta["name"] == "setup_s")
        assert reader is None or reader.UNIT == meta["unit"]
    assert parts["per_layer"], cell
    for meta, reader in parts["per_layer"]:
        assert (reader.UNIT, reader.MOVES, reader.LAYER) == (meta["unit"], meta["moves"],
                                                            meta["layer"])
        assert meta["moves"] in names
    cfg = parts["config"]
    for key in ("gaussians", "width", "height", "render", "limits", "source"):
        assert key in cfg
    assert set(cfg["reduced"]) <= set(cfg)


def test_each_config_file_is_listed_once():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_a_new_cell_is_found_without_editing_a_file(tmp_path):
    bench = tmp_path / "gsbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    config = json.loads((bench / "configs" / "train.json").read_text())
    (bench / "configs" / "train_small.json").write_text(json.dumps({**config, "gaussians": 500}))
    (bench / "traffic" / "orbit_fast.json").write_text(
        json.dumps({**json.loads((bench / "traffic" / "orbit.json").read_text()), "step_deg": 2.0}))
    (bench / "metrics" / "frames_traced.py").write_text(
        'LAYER = "whole frame"\nUNIT = "frames"\nMOVES = "fps"\n\n\n'
        "def read(trace):\n    return len(trace.frames_b) or None\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "train_small.fast", "config": "train_small",
                              "traffic": "orbit_fast", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                              "source": "program_span", "layer": "whole frame", "moves": "fps",
                              "workloads": ["train_small.fast"]})
    parts = resolve(spec, "train_small.fast", bench)
    assert parts["config"]["gaussians"] == 500 and parts["traffic"]["step_deg"] == 2.0
    assert [m["name"] for m, _ in parts["per_layer"]] == ["frames_traced"]
    assert [m["name"] for m in per_layer_for(spec, "train.view")] == \
        [m["name"] for m in per_layer_for(SPEC, "train.view")]
    for p, data in before.items():
        assert p.read_bytes() == data, p


# A mix with a loop of its own (one viewer who never moves the camera,
# rendering through ``render_batch`` one lane at a time) and an end-to-end
# metric of its own, in files that a later change adds.
STILL_LOOP = '''
import time

from gsbench.drive import Sample, Window, sync


class Loop:
    def __init__(self, cell):
        from repro_torch import engine

        self.cell = cell
        self.handle = engine.open(cell.scene_p, cell.cfg, device=cell.device)
        self.ref_cam, self.cam = cell.cams(float(cell.traffic["azimuth_deg"]))

    def close(self):
        self.handle.close()

    def window(self, seconds):
        times, out = [], None
        start = time.perf_counter()
        while not times or time.perf_counter() - start < seconds:
            t0 = time.perf_counter()
            out = self.handle.render_batch([self.cam])
            sync(self.cell.device)
            times.append(time.perf_counter() - t0)
        sample = Sample(len(times) - 1, float(self.cell.traffic["azimuth_deg"]), out.image[0])
        return Window(latency_s=times, span_s=time.perf_counter() - start, samples=[sample])
'''
MEAN_READER = '''
UNIT = "ms"


def read(window):
    return 1e3 * sum(window.latency_s) / len(window.latency_s) if window.latency_s else None
'''


def test_a_new_loop_and_end_to_end_metric_run_without_editing_a_file(tmp_path):
    """A mix whose loop and end-to-end metric are new files runs one cell
    through the whole harness, on the CPU at a tiny size."""
    import time

    import torch

    from gsbench.cell import run_cell

    bench = tmp_path / "gsbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "loops" / "still.py").write_text(STILL_LOOP)
    (bench / "metrics" / "frame_mean_ms.py").write_text(MEAN_READER)
    (bench / "traffic" / "still.json").write_text(json.dumps(
        {"loop": "still", "azimuth_deg": 30.0, "check": {"answers": 1}}))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "train.still", "config": "train", "traffic": "still",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "frame_mean_ms", "unit": "ms", "better": "lower",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["train.still"]})
    tiny = {"config": {"gaussians": 2000, "width": 64, "height": 64,
                       "render": {"group_capacity": 4096, "tile_capacity": 2048, "span": 16}}}
    torch.set_num_threads(2)
    out = run_cell("train.still", 2 ** 34 + 3, 0.5, False, torch.device("cpu"),
                   t_start=time.perf_counter(), spec=spec, bench=bench, overrides=tiny)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"frame_mean_ms", "setup_s"}
    assert out["metrics"]["frame_mean_ms"]["value"] > 0 and out["attempted"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p


def take(it, n):
    return [next(it) for _ in range(n)]


def test_orbit_is_fixed_by_the_seed_and_moves_every_frame():
    traffic = resolve(SPEC, "train.view")["traffic"]
    a = take(drive.viewer_azimuths(traffic, 2 ** 33 + 5), 500)
    assert a == take(drive.viewer_azimuths(traffic, 2 ** 33 + 5), 500)
    assert a != take(drive.viewer_azimuths(traffic, 2 ** 33 + 6), 500)
    steps = np.diff(np.unwrap(np.radians(a)))
    assert np.allclose(np.degrees(steps), traffic["step_deg"])


def test_pause_orbit_holds_three_quarters_of_the_frames():
    traffic = resolve(SPEC, "train.pause")["traffic"]
    cycle = traffic["hold_cycle"] * traffic["hold_block"]
    a = take(drive.viewer_azimuths(traffic, 123), cycle + 1)
    assert a == take(drive.viewer_azimuths(traffic, 123), cycle + 1)
    held = np.asarray(a[1:]) == np.asarray(a[:-1])
    # Binomial sampling error of 2,048 draws at 3/4 is 0.01.
    assert abs(held.mean() - 0.75) < 0.03
    moved = np.degrees(np.diff(np.unwrap(np.radians(a))))
    assert np.allclose(moved[moved != 0], traffic["step_deg"])
    # Another seed: another start and another order of the same holds (a
    # whole cycle, the second: frame 0 moves for no seed).
    a = take(drive.viewer_azimuths(traffic, 123), 2 * cycle + 1)
    b = take(drive.viewer_azimuths(traffic, 2 ** 40 + 9), 2 * cycle + 1)
    one, other = (np.diff(x)[cycle - 1:2 * cycle - 1] == 0 for x in (a, b))
    assert a[0] != b[0] and one.sum() == other.sum() and (one != other).any()


def test_serve_arrivals_have_the_traffic_files_rate():
    traffic = resolve(SPEC, "train.serve")["traffic"]
    seconds = 30.0
    sched = drive.arrivals(traffic, 77, seconds)
    assert sched == drive.arrivals(traffic, 77, seconds)
    assert sched != drive.arrivals(traffic, 78, seconds)
    due = np.asarray([d for d, _ in sched])
    assert np.all(np.diff(due) > 0) and due[-1] < seconds
    rate = traffic["rate_hz"]
    assert abs(len(due) / seconds - rate) / rate < 0.02
    gaps = np.diff(due)
    # Exponential gaps: mean 1/rate, coefficient of variation 1.
    assert abs(gaps.mean() * rate - 1) < 0.05 and abs(gaps.std() / gaps.mean() - 1) < 0.15
    az = np.asarray([a for _, a in sched])
    assert 0 <= az.min() and az.max() < 360 and abs(az.mean() - 180) < 30


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "gsbench/run.py", "--workload", "train.view",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """One short run of the first cell on the card: a result line that is
    correct, with every end-to-end metric of the cell."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "gsbench/run.py", "--workload", "train.view",
                          "--seed", "2718281828459", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"fps", "frame_p95_ms", "setup_s"}
