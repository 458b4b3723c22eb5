"""Reduction of a ``torch.profiler`` trace of the card: the device's busy
time in a window (the union of its kernel, copy and memset intervals), each
kernel's time by name, the time of each kernel inside each annotated frame,
and the idle gaps named by what the host was doing during them."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def run_profiled(fn):
    """Run ``fn(annotate)`` under torch.profiler (CPU and CUDA activity);
    ``annotate(name)`` is ``record_function``. Returns the trace's events,
    read back from a Chrome trace written to, and removed from, a temporary
    directory."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(record_function)
    with tempfile.TemporaryDirectory(prefix="gsbench-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _interval(e) -> Tuple[float, float]:
    t0 = float(e["ts"]) * 1e-6
    return t0, t0 + float(e.get("dur", 0.0)) * 1e-6


def device_ops(events) -> List[Tuple[float, float, str]]:
    return sorted((*_interval(e), e.get("name", "?")) for e in events
                  if e.get("cat") in DEVICE_CATS)


def annotations(events, prefix: str) -> List[Tuple[float, float, str]]:
    """Host intervals of the ``record_function`` ranges whose name starts
    with ``prefix``, in time order."""
    return sorted((*_interval(e), e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name", "").startswith(prefix))


def busy(ops, w0: float, w1: float) -> float:
    """Seconds of ``[w0, w1]`` in which some device operation ran."""
    total, end = 0.0, w0
    for a, b, _ in ops:
        a, b = max(a, w0), min(b, w1)
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def kernel_seconds(ops, w0: float, w1: float, match: str) -> float:
    """Seconds of the device operations whose name holds ``match`` and that
    start inside ``[w0, w1]``."""
    return sum(b - a for a, b, name in ops if match in name and w0 <= a <= w1)


def top_ops(ops, w0: float, w1: float, n: int = 10) -> List[list]:
    """The ``n`` device operations that took most time, summed by name."""
    by: Dict[str, float] = defaultdict(float)
    for a, b, name in ops:
        if w0 <= a <= w1:
            by[name] += b - a
    return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, ops, w0: float, w1: float, n: int = 10) -> List[list]:
    """The device's idle gaps in ``[w0, w1]``, summed by the innermost host
    operation running at each gap's middle (``idle`` where none ran)."""
    host = sorted(_interval(e) + (e.get("name", "?"),) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation"))
    gaps, end = [], w0
    for a, b, _ in ops:
        if a > end and a <= w1:
            gaps.append((end, min(a, w1)))
        end = max(end, b)
    if end < w1:
        gaps.append((end, w1))
    starts = [h[0] for h in host]
    by: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        # Host ranges nest: of those holding ``mid`` the innermost is the
        # one that started last.
        name = "idle"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[j][1] >= mid:
                name = host[j][2][:200]
                break
        by[name] += g1 - g0
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
