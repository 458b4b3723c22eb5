"""The general traffic generator, the record of a window, and the viewer's
closed loop that the loops under ``gsbench/loops/`` share.

A traffic mix is a data file (``gsbench/traffic/<name>.json``) of
parameters; its ``loop`` names the module (``gsbench/loops/<loop>.py``)
that opens the program's entry point and drives it with them. The
parameters this module reads:

  * a viewer's poses: each frame's camera lies on the configuration's
    orbit: a start azimuth drawn from the seed, then per frame the pose is
    held (with probability ``hold_share``) or advanced by ``step_deg``. The
    holds form ``hold_cycle`` blocks of ``hold_block`` frames, drawn once
    for the mix, the same for every seed; each seed orders the blocks
    anew in every cycle;
  * arrivals: requests at ``rate_hz`` with exponential gaps (a Poisson
    process): every seed draws the same ``rate_hz x seconds`` gaps, the
    exponential's quantiles at (i + 1/2) / n, in its own order, so each
    seed offers the same load. Each request is a camera on the orbit at an
    azimuth uniform in [0, 360) from the seed.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from gsbench import devtrace
from gsbench.harness import rng


def viewer_azimuths(traffic: dict, seed: int, salt: str = "") -> Iterator[float]:
    """The closed loop's azimuth, frame after frame (degrees, in [0, 360))."""
    r = rng(seed, f"{traffic['name']}{salt}:poses")
    az = float(r.uniform(0.0, 360.0))
    step = float(traffic["step_deg"])
    block = int(traffic.get("hold_block", 1))
    cycle = int(traffic.get("hold_cycle", 1))
    # The cycle's holds are drawn once, from the mix's name alone, so every
    # seed holds the same frames of the same blocks; the seed orders them.
    held = rng(0, f"{traffic['name']}:holds").random((cycle, block)) < float(
        traffic.get("hold_share", 0.0))
    first = True
    while True:
        for i in r.permutation(cycle):
            for hold in held[i]:
                if not first and not hold:
                    az = (az + step) % 360.0
                first = False
                yield az


def warm_azimuths(seed: int) -> Iterator[float]:
    """Poses for the warm-up, apart from the window's."""
    return viewer_azimuths({"name": "warm", "step_deg": 7.0}, seed)


def arrivals(traffic: dict, seed: int, seconds: float, salt: str = "") -> List[tuple]:
    """``(due_s, azimuth_deg)`` of every request due in ``[0, seconds)``."""
    rate = float(traffic["rate_hz"])
    n = int(round(rate * seconds))
    r = rng(seed, f"{traffic['name']}{salt}:arrivals")
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    r.shuffle(gaps)
    due = np.cumsum(gaps)
    az = r.uniform(0.0, 360.0, size=n)
    return [(float(d), float(a)) for d, a in zip(due, az) if d < seconds]


class Cameras:
    """Orbit cameras by azimuth, each made once: the reference's camera and
    the program's, the same numbers."""

    def __init__(self, config: dict):
        from gsbench.scene import orbit_camera, to_program

        self._make, self._convert = orbit_camera, to_program
        self._config = config
        self._cache: Dict[float, tuple] = {}

    def __call__(self, az: float):
        hit = self._cache.get(az)
        if hit is None:
            ref = self._make(self._config, az)
            hit = self._cache[az] = (ref, self._convert(ref))
        return hit


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Sample:
    """One answer kept for the check: its position, azimuth and image;
    ``frame``, the traced frame's record it came from, takes the
    reference's work counts once checked."""

    index: int
    azimuth: float
    image: torch.Tensor
    frame: Optional[dict] = None


class Reservoir:
    """``k`` items drawn uniformly, from the seed, out of a stream of
    unknown length (reservoir sampling); ``make`` is called only for an
    item that goes in, so a clone is made only then."""

    def __init__(self, k: int, r: np.random.Generator):
        self.k, self.r, self.items, self.seen = k, r, [], 0

    def offer(self, make: Callable[[], Sample]) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.r.integers(0, self.seen))
        if j < self.k:
            self.items[j] = make()


@dataclasses.dataclass
class Window:
    """What a loop's window leaves for the end-to-end readers
    (``gsbench/metrics/<name>.py``) and the check.

    ``latency_s``: every answer due in the window, in order, on the host
    clock (a frame from the call to the synchronise that ends it; a request
    from its due time to its image on the host), infinite where none came;
    ``span_s``: the window's seconds; ``samples``: the answers drawn for the
    check; ``readings``: the numbers the check compares beside the images;
    ``queue_s``: each served request's due time to the start of its
    dispatch."""

    latency_s: List[float]
    span_s: float
    samples: List[Sample]
    readings: Dict[str, Optional[float]] = dataclasses.field(default_factory=dict)
    queue_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def failed(self) -> int:
        return sum(1 for t in self.latency_s if math.isinf(t))


def viewer_window(frame: Callable, azimuths: Iterator[float], cams: Cameras, seconds: float,
                  device: torch.device, check: Reservoir, *,
                  frames: Optional[int] = None) -> Window:
    """Closed loop for ``seconds`` (or ``frames`` frames): each frame timed
    on the host clock from the call to the synchronise that ends it.
    ``cut_entries``: the entries the program's lists dropped over every
    frame (capacity and candidate-window overflow)."""
    times: List[float] = []
    cut = None
    start = time.perf_counter()
    end = start
    i = 0
    while (frames is None and end - start < seconds) or (frames is not None and i < frames):
        az = next(azimuths)
        _, cam = cams(az)
        t0 = time.perf_counter()
        out = frame(cam)
        sync(device)
        end = time.perf_counter()
        times.append(end - t0)
        s = out.stats
        cut = s.overflow + s.span_overflow if cut is None else cut + s.overflow + s.span_overflow
        check.offer(lambda: Sample(i, az, out.image.clone()))
        i += 1
    return Window(latency_s=times, span_s=end - start, samples=check.items,
                  readings={"cut_entries": int(cut) if cut is not None else None})


class ClosedLoop:
    """One viewer, closed loop: frame after frame on the orbit, the next
    frame called when the last one's image is complete on the card. A loop
    that drives another entry point of the engine subclasses it and says
    how to open that entry (``open_frame``).

    Set-up opens the engine on the committed scene and warms the entry up
    on poses apart from the window's. The traced run (``trace``): (a)
    untimed frames under torch.profiler, for the device's idle share, the
    kernels' times by name and each frame's wall time; (b) frames of the
    same entry on an engine opened with ``RenderConfig(timing=True)``, for
    the program's fenced stage spans and its ``RenderStats``."""

    def __init__(self, cell):
        from repro_torch import engine

        self.cell = cell
        self.handle = engine.open(cell.scene_p, cell.cfg, device=cell.device)
        self.frame = self.warmed(self.handle, warm_azimuths(cell.seed),
                                 int(cell.traffic.get("warm", 3)))

    def open_frame(self, handle) -> Callable:
        """The entry point: a callable from a program camera to a frame."""
        raise NotImplementedError

    def warmed(self, handle, azimuths: Iterator[float], n: int) -> Callable:
        frame = self.open_frame(handle)
        self.warm(frame, azimuths, n)
        return frame

    def warm(self, frame: Callable, azimuths: Iterator[float], n: int) -> None:
        for _ in range(n):
            frame(self.cell.cams(next(azimuths))[1])
        sync(self.cell.device)

    def close(self) -> None:
        self.handle.close()

    def window(self, seconds: float) -> Window:
        c = self.cell
        pick = Reservoir(c.check_k, rng(c.seed, "check"))
        return viewer_window(self.frame, viewer_azimuths(c.traffic, c.seed), c.cams, seconds,
                             c.device, pick)

    def trace(self, td) -> Window:
        c = self.cell
        t = c.traffic["trace"]
        pick = Reservoir(c.check_k, rng(c.seed, "trace-check"))
        azimuths = viewer_azimuths(c.traffic, c.seed)
        holder = {}

        def part_a(annotate):
            n = 0

            def frame(cam):
                nonlocal n
                with annotate(f"gsbench/frame{n}"):
                    out = self.frame(cam)
                    sync(c.device)
                n += 1
                return out

            holder["w"] = viewer_window(frame, azimuths, c.cams, 0.0, c.device, pick,
                                        frames=int(t["profiled_frames"]))

        td.events = devtrace.run_profiled(part_a)
        w = holder["w"]
        td.ops = devtrace.device_ops(td.events)
        spans = devtrace.annotations(td.events, "gsbench/frame")
        td.w0, td.w1 = spans[0][0], spans[-1][1]
        td.busy_s, td.window_s = devtrace.busy(td.ops, td.w0, td.w1), td.w1 - td.w0
        td.frames_a = [{"wall_s": wall, "window": (a, b), "counts": None}
                       for wall, (a, b, _) in zip(w.latency_s, spans)]
        for s in w.samples:
            s.frame = td.frames_a[s.index]
        self.timed_frames(td, azimuths, int(t["timed_frames"]))
        return w

    def timed_frames(self, td, azimuths: Iterator[float], n: int) -> None:
        from repro_torch import engine
        from repro_torch.obs import get_tracer

        c = self.cell
        timed = engine.open(c.scene_p, dataclasses.replace(c.cfg, timing=True), device=c.device)
        frame = self.open_frame(timed)
        self.warm(frame, azimuths, 1)
        tracer = get_tracer()
        tid = tracer.current_tid()
        tracer.clear()
        bounds = []
        stats = []
        for _ in range(n):
            cam = c.cams(next(azimuths))[1]
            t0 = tracer.clock()
            out = frame(cam)
            sync(c.device)
            bounds.append((t0, tracer.clock()))
            stats.append(out.stats.as_dict())
        events = [e for e in tracer.events() if e.tid == tid and e.name.startswith("stage/")]
        for (t0, t1), st in zip(bounds, stats):
            per: Dict[str, float] = {}
            for e in events:
                if e.t0 >= t0 and e.t1 <= t1 and e.name != "stage/render":
                    key = e.name.split("/", 1)[1]
                    per[key] = per.get(key, 0.0) + e.duration_s
            td.frames_b.append({"wall_s": t1 - t0, "spans": per, "stats": st})
        timed.close()
