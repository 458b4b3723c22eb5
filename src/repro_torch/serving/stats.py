"""Per-bucket serving statistics: latency, throughput, cache hits (a copy
of the JAX package's ``repro.serving.stats``).

Pure Python (no torch): the server records one ``record_dispatch`` per
batch with walltimes measured around the actual device work, and folds in
the engine's renderer-cache deltas (``render_cache_info`` dicts) so the
serving counters and the CLI output agree on what a "cache hit" is: a
dispatch that reused a cached renderer.

Latency is request-level (completion - enqueue), so it includes queueing
and batching delay, not just device time.

Memory + concurrency (DESIGN.md §14): latencies live in bounded reservoir
histograms (``repro_torch.obs.metrics.Histogram``: exact percentiles up to
the reservoir cap, uniform sampling beyond it), and ALL mutation goes
through one lock. Every fold also publishes into the process metrics
registry (``serving.*`` counters/histograms), which is what
``--metrics-json`` snapshots.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import Dict, List, Optional

from repro_torch.obs.metrics import Histogram, MetricsRegistry, get_registry

#: Reservoir capacity for latency histograms: percentiles are EXACT for any
#: bucket that has seen up to this many requests, sampled (uniformly, with a
#: deterministic seed) beyond it.
LATENCY_RESERVOIR = 4096


def percentile(values: List[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]); nan for no samples.

    NOTE the empty-input contract differs from ``repro_torch.obs.metrics
    .percentile`` (0.0): serving percentiles must be NON-finite when nothing
    completed — launch/render_serve.py's exit contract keys on a finite
    p99, and an empty run reporting 0.0 would pass it.
    """
    if not values:
        return math.nan
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _latency_histogram() -> Histogram:
    return Histogram(cap=LATENCY_RESERVOIR)


@dataclasses.dataclass
class BucketStats:
    """Counters for one executable signature."""

    signature: tuple
    requests: int = 0
    batches: int = 0
    padded: int = 0              # wasted lanes added for device divisibility
    render_s: float = 0.0        # device walltime across dispatches
    latency: Histogram = dataclasses.field(default_factory=_latency_histogram)
    cache_hits: int = 0          # dispatches that reused a compiled renderer
    cache_misses: int = 0        # dispatches that compiled

    @property
    def latencies_s(self) -> List[float]:
        """The latency RESERVOIR (bounded view; the full stream once the
        bucket exceeds LATENCY_RESERVOIR requests — ``latency.count`` keeps
        the exact total)."""
        return self.latency.values()

    @property
    def mean_batch(self) -> float:
        return self.requests / self.batches if self.batches else math.nan

    def to_dict(self) -> dict:
        lat = self.latency.values()
        return {
            "signature": repr(self.signature),
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch": self.mean_batch,
            "padded": self.padded,
            "render_s": self.render_s,
            "p50_ms": percentile(lat, 50) * 1e3,
            "p99_ms": percentile(lat, 99) * 1e3,
            "latency_count": self.latency.count,
            "latency_sampled": self.latency.sampled,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
        }


def cache_delta(before: dict, after: dict) -> Dict[str, int]:
    """hits/misses deltas summed over EVERY renderer cache reported by
    ``render_cache_info()`` — the single/batch executable caches plus any
    registered auxiliary cache (e.g. the sharded scene-layout cache).
    Tolerates caches that registered between the two snapshots."""
    return {
        key: sum(
            after[kind].get(key, 0) - before.get(kind, {}).get(key, 0)
            for kind in after
        )
        for key in ("hits", "misses")
    }


class ServingStats:
    """Aggregates BucketStats across the server's lifetime.

    Thread-safe: one lock guards every mutator — dispatch folds can arrive
    from a dispatch loop and the futures worker concurrently, and the old
    reject-only lock left ``record_dispatch`` racy. Each fold/rejection also
    publishes ``serving.*`` counters and histograms into ``registry``
    (default: the process-wide ``repro_torch.obs.get_registry()``).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.buckets: Dict[tuple, BucketStats] = {}
        self.rejected = 0
        self.deadline_misses = 0
        self.wall_s: Optional[float] = None   # stamped by the dispatch loop
        # Cross-bucket request latencies (bounded reservoir; the per-bucket
        # histograms keep exact counts, this one feeds the aggregate p50/p99).
        self.latency = _latency_histogram()
        self._registry = registry if registry is not None else get_registry()
        self._lock = threading.RLock()

    def count_rejected(self) -> None:
        with self._lock:
            self.rejected += 1
        self._registry.counter("serving.rejected_total").inc()

    def count_deadline_miss(self) -> None:
        with self._lock:
            self.deadline_misses += 1
        self._registry.counter("serving.deadline_misses_total").inc()

    def bucket(self, signature: tuple) -> BucketStats:
        with self._lock:
            if signature not in self.buckets:
                self.buckets[signature] = BucketStats(signature)
            return self.buckets[signature]

    def record_dispatch(
        self,
        signature: tuple,
        batch_size: int,
        padded_size: int,
        render_s: float,
        latencies_s: List[float],
        cache_before: Optional[dict] = None,
        cache_after: Optional[dict] = None,
    ) -> None:
        delta = None
        if cache_before is not None and cache_after is not None:
            delta = cache_delta(cache_before, cache_after)
        with self._lock:
            b = self.bucket(signature)
            b.requests += batch_size
            b.batches += 1
            b.padded += padded_size - batch_size
            b.render_s += render_s
            b.latency.observe_many(latencies_s)
            self.latency.observe_many(latencies_s)
            if delta is not None:
                b.cache_hits += delta["hits"]
                b.cache_misses += delta["misses"]
        reg = self._registry
        reg.counter("serving.requests_total").inc(batch_size)
        reg.counter("serving.batches_total").inc()
        reg.counter("serving.padded_lanes_total").inc(
            padded_size - batch_size)
        if delta is not None:
            reg.counter("serving.cache_hits_total").inc(max(delta["hits"], 0))
            reg.counter("serving.cache_misses_total").inc(
                max(delta["misses"], 0))
        reg.histogram("serving.render_s").observe(render_s)
        lat_h = reg.histogram("serving.latency_s")
        lat_h.observe_many(latencies_s)

    # -- aggregate views ----------------------------------------------------

    @property
    def completed(self) -> int:
        with self._lock:
            return sum(b.requests for b in self.buckets.values())

    def all_latencies(self) -> List[float]:
        """The aggregate latency RESERVOIR (exact below LATENCY_RESERVOIR
        total requests, a uniform sample beyond — ``self.latency.count`` has
        the exact total)."""
        return self.latency.values()

    def fps(self) -> float:
        if not self.wall_s:
            return math.nan
        return self.completed / self.wall_s

    def summary(self) -> dict:
        with self._lock:
            buckets = list(self.buckets.values())
            lat = self.latency.values()
            return {
                "completed": sum(b.requests for b in buckets),
                "rejected": self.rejected,
                "deadline_misses": self.deadline_misses,
                "batches": sum(b.batches for b in buckets),
                "padded": sum(b.padded for b in buckets),
                "cache_hits": sum(b.cache_hits for b in buckets),
                "cache_misses": sum(b.cache_misses for b in buckets),
                "p50_ms": percentile(lat, 50) * 1e3,
                "p99_ms": percentile(lat, 99) * 1e3,
                "wall_s": self.wall_s,
                "fps": self.fps(),
                "buckets": [b.to_dict() for b in buckets],
            }

    def to_json(self, **extra) -> str:
        return json.dumps({**self.summary(), **extra}, indent=2)

    def format(self) -> str:
        s = self.summary()
        wall = f"{s['wall_s']:.2f}s" if s["wall_s"] is not None else "n/a"
        lines = [
            f"served {s['completed']} requests in {s['batches']} batches "
            f"({s['rejected']} rejected, {s['padded']} padded lanes)",
            f"  latency p50={s['p50_ms']:.1f}ms p99={s['p99_ms']:.1f}ms  "
            f"throughput={s['fps']:.1f} fps  wall={wall}",
            f"  executable cache: {s['cache_hits']} hits / "
            f"{s['cache_misses']} misses",
        ]
        for d in sorted(s["buckets"], key=lambda d: -d["requests"]):
            lines.append(
                f"  bucket {d['signature'][:72]}: {d['requests']} reqs / "
                f"{d['batches']} batches (mean {d['mean_batch']:.1f}), "
                f"p99={d['p99_ms']:.1f}ms"
            )
        return "\n".join(lines)
