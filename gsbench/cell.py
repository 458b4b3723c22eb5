"""One run of one cell: set-up, the measured window (``trace=0``) or the
traced run (``trace=1``), then the check against the plain reference.

Set-up makes the scene on the device from the seed, builds or loads the
program's kernels, and sets up the loop that the cell's traffic mix names
(``gsbench/loops/<loop>.py``), which opens the program's entry point and
warms up this cell's shapes; its seconds, from the process's start, are
``setup_s``. The loop's window is read by the cell's end-to-end readers,
its traced run by the per-layer readers (``gsbench/metrics/<name>.py``).
The reference runs after the window has closed, after the memory peak was
read and the program's state was freed.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from gsbench import check, devtrace, drive
from gsbench.harness import BENCH, SETUP_S, load_spec, resolve
from gsbench.reference import render as reference
from gsbench.scene import scene_for, to_program_scene

KERNEL_SOURCES = ("bitmask_gen", "raster_tile")


@dataclasses.dataclass
class TraceData:
    """What the per-layer readers (``gsbench/metrics/*.py``) read; the loop
    fills it in its traced run.

    ``frames_a``: the profiled frames, each ``{"wall_s", "window": (t0,
    t1), "counts"}`` with the reference's work counts where the frame was
    checked (else None); ``events`` and ``ops``: that trace's events and
    its device operations; ``busy_s``/``window_s``: the device's busy time
    in the traced window ``[w0, w1]``. ``frames_b``: the timed frames, each
    ``{"wall_s", "spans": {stage: seconds}, "stats"}``. ``queue_s``,
    ``dispatch_s`` and ``lanes``: the served requests' wait from their due
    time to their dispatch, each dispatch's span and the lanes rendered and
    padded. A loop with readers of its own sets attributes of its own."""

    width: int = 0
    height: int = 0
    scene_bytes: int = 0
    frames_a: List[dict] = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    ops: list = dataclasses.field(default_factory=list)
    w0: float = 0.0
    w1: float = 0.0
    busy_s: float = 0.0
    window_s: float = 0.0
    frames_b: List[dict] = dataclasses.field(default_factory=list)
    queue_s: List[float] = dataclasses.field(default_factory=list)
    dispatch_s: List[float] = dataclasses.field(default_factory=list)
    lanes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def kernel_seconds(self, frame: dict, match: str) -> float:
        return devtrace.kernel_seconds(self.ops, *frame["window"], match)


def render_config(config: dict):
    from repro_torch.core.pipeline import RenderConfig

    return RenderConfig(**config["render"])


def build_kernels(device: torch.device) -> None:
    """Build (first run in a checkout) or find the program's kernel
    libraries, all at once, in the program's fixed build directory."""
    if device.type == "cuda":
        from repro_torch.kernels import build

        build.build(KERNEL_SOURCES)


def scene_bytes(scene: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in scene.values())


def references(scene, config: dict, cams: drive.Cameras, samples, *, tf32: bool = False):
    """The reference's frame of each sample's camera."""
    r = config["render"]
    return [reference.render(scene, cams(s.azimuth)[0], group=r["group"], tile=r["tile"],
                             tf32=tf32) for s in samples]


def free_device(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


class Cell:
    """One cell's program under its traffic, driven by the loop the mix
    names."""

    def __init__(self, cell: str, seed: int, device: torch.device, *, spec=None,
                 bench=BENCH, overrides: Optional[dict] = None):
        parts = resolve(spec or load_spec(), cell, bench)
        self.name, self.seed, self.device = cell, seed, device
        # ``overrides`` (tests on the CPU: tiny sizes) updates the
        # configuration's and the traffic's keys, one level deep.
        self.config, self.traffic = dict(parts["config"]), dict(parts["traffic"])
        for part, where in (("config", self.config), ("traffic", self.traffic)):
            for k, v in (overrides or {}).get(part, {}).items():
                where[k] = {**where.get(k, {}), **v} if isinstance(v, dict) else v
        self.loop_module = parts["loop"]
        self.end_to_end = parts["end_to_end"]
        self.per_layer = parts["per_layer"]
        self.cams = drive.Cameras(self.config)
        self.check_k = int(self.traffic["check"]["answers"])
        self.phases: Dict[str, float] = {}

    def setup(self) -> None:
        """The scene, the kernels and the loop, each phase's end stamped on
        the host clock (``phases``)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._stamp("start")
        self.scene = scene_for(self.config, self.seed, self.device)
        self.scene_p = to_program_scene(self.scene)
        self.cfg = render_config(self.config)
        drive.sync(self.device)
        self._stamp("scene")
        build_kernels(self.device)
        self._stamp("kernels")
        self.loop = self.loop_module.Loop(self)
        drive.sync(self.device)
        self._stamp("loop")

    def _stamp(self, phase: str) -> None:
        self.phases[phase] = time.perf_counter()

    def close(self) -> None:
        if hasattr(self, "loop"):
            self.loop.close()
        for name in ("loop", "scene_p"):
            self.__dict__.pop(name, None)
        free_device(self.device)

    def measure(self, seconds: float) -> dict:
        """The end-to-end metrics, the memory peak and the check."""
        w = self.loop.window(seconds)
        values = read_all(self.end_to_end, w)
        peak = memory_peak(self.device)
        self.close()
        readings = {**self._compare(w.samples), **w.readings}
        return {"values": values, "attempted": len(w.latency_s), "failed": w.failed,
                "memory_peak_bytes": peak, "readings": readings}

    def trace(self, seconds: float) -> dict:
        """The loop's traced run (its parts are the loop's), then the
        per-layer metrics and the check."""
        td = TraceData(width=self.config["width"], height=self.config["height"],
                       scene_bytes=scene_bytes(self.scene))
        w = self.loop.trace(td)
        peak = memory_peak(self.device)
        self.close()
        readings = {**self._compare(w.samples), **w.readings}
        return {"values": read_all(self.per_layer, td), "attempted": len(w.latency_s),
                "failed": w.failed, "memory_peak_bytes": peak, "readings": readings,
                "busy_s": td.busy_s, "window_s": td.window_s,
                "breakdown": {"device_ops": devtrace.top_ops(td.ops, td.w0, td.w1),
                              "idle_gaps": devtrace.idle_gaps(td.events, td.ops, td.w0,
                                                              td.w1)}}

    def _compare(self, samples) -> Dict[str, float]:
        """The worst checked answer's gap from the reference; a checked
        traced frame takes the reference's work counts."""
        gaps = []
        self.checked = list(zip(samples, references(self.scene, self.config, self.cams, samples)))
        for s, ref in self.checked:
            gaps.append({"rmse": check.image_gap(s.image, ref.image)["rmse"]})
            if s.frame is not None:
                s.frame["counts"] = ref.counts
        return check.worst(gaps) if gaps else {"rmse": math.nan}


def read_all(metrics, data) -> Dict[str, float]:
    """Each metric's reading of ``data``; a reader that finds nothing to
    read returns None and its metric is left out. ``setup_s`` (no reader)
    is the harness's own."""
    values = {}
    for m, reader in metrics:
        if reader is None:
            continue
        v = reader.read(data)
        if v is not None:
            values[m["name"]] = v
    return values


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: torch.device, *,
             t_start: float, spec=None, bench=BENCH, overrides: Optional[dict] = None,
             phases: Optional[Dict[str, float]] = None) -> dict:
    """One run; returns the numbers of the result line (see run.py).
    ``phases``: host-clock stamps taken before the cell's set-up (imports,
    the look for a card), printed with the set-up's own."""
    spec = spec or load_spec()
    c = Cell(cell, seed, device, spec=spec, bench=bench, overrides=overrides)
    c.setup()
    setup_s = time.perf_counter() - t_start
    print("setup phases (s): " + ", ".join(
        f"{k} {v - t_start:.3f}" for k, v in {**(phases or {}), **c.phases}.items()),
        file=sys.stderr, flush=True)
    out = c.trace(seconds) if trace else c.measure(seconds)
    correct, table = check.judge(out["readings"], c.config["limits"])
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in out["values"].items()}
    if not trace:
        metrics[SETUP_S] = {"value": setup_s, "unit": units[SETUP_S]}
    return {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "memory_peak_bytes": out["memory_peak_bytes"],
            "busy_s": out.get("busy_s"), "window_s": out.get("window_s"),
            "breakdown": out.get("breakdown"), "checks": table}
