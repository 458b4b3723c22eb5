"""Metrics registry: named counters / gauges / reservoir histograms (a
copy of the JAX package's ``repro.obs.metrics``, DESIGN.md §14).

One process-wide :class:`MetricsRegistry` sits behind every stats surface
of the port — ``Renderer.stats()`` and the render-cache registry (via a
collector) — so cache hit rates and futures counters coexist in ONE
schema-versioned snapshot (``registry.snapshot()``).

Instruments are cheap and individually locked, safe to update from the
serving dispatch loop, the futures worker thread, and test threads at once.

:class:`Histogram` is a bounded reservoir (algorithm R, deterministic
seed): exact count/sum/min/max always; percentiles exact while the sample
count is within the reservoir capacity, and an unbiased uniform sample
above it (``sampled`` flags the switch). This is what bounds
``BucketStats`` latency memory on a long-lived server.
"""
from __future__ import annotations

import math
import random
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

SCHEMA = "repro.metrics/v1"

#: Default reservoir capacity: exact percentiles for any bucket that has
#: seen up to this many observations.
DEFAULT_RESERVOIR = 4096


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank-with-interpolation percentile; 0.0 on empty input.

    (``serving.stats.percentile`` is the same interpolation with a
    DIFFERENT empty-input contract — nan — because the serving CI exit
    check keys on a finite p99; this one feeds :class:`Histogram`
    snapshots, which must stay JSON-plain.)
    """
    if not values:
        return 0.0
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


class Counter:
    """Monotonic counter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("Counter.inc is monotonic; got n=%r" % (n,))
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value: float = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded-reservoir value distribution (algorithm R).

    ``count``/``sum``/``min``/``max`` are exact over every observation.
    Percentiles come from the reservoir: exact while ``count <= cap``,
    a uniform random sample of the stream beyond that (deterministic
    seeded RNG so snapshots are reproducible under a fixed arrival
    order). ``sampled`` in the snapshot says which regime you're in.
    """

    def __init__(self, cap: int = DEFAULT_RESERVOIR, seed: int = 0) -> None:
        if cap < 1:
            raise ValueError("Histogram cap must be >= 1")
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._values: List[float] = []
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._values) < self.cap:
                self._values.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.cap:
                    self._values[j] = v

    def observe_many(self, values: Sequence[float]) -> None:
        for v in values:
            self.observe(v)

    @property
    def sampled(self) -> bool:
        """True once percentiles are reservoir-sampled rather than exact."""
        with self._lock:
            return self.count > self.cap

    def values(self) -> List[float]:
        """A copy of the reservoir (NOT the full stream once sampled)."""
        with self._lock:
            return list(self._values)

    def percentile(self, q: float) -> float:
        return percentile(self.values(), q)

    def snapshot(self) -> dict:
        with self._lock:
            vals = list(self._values)
            count, total = self.count, self.sum
            vmin, vmax = self.min, self.max
        return {
            "count": count,
            "sum": total,
            "min": vmin,
            "max": vmax,
            "mean": (total / count) if count else 0.0,
            "p50": percentile(vals, 50),
            "p90": percentile(vals, 90),
            "p99": percentile(vals, 99),
            "reservoir": len(vals),
            "cap": self.cap,
            "sampled": count > self.cap,
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of named instruments + lazy collectors.

    Collectors run at :meth:`snapshot` time and publish derived state
    (e.g. the render-cache registry's hit/miss tables) into the registry,
    so surfaces that already keep their own counters don't need a write
    on every event — they're scraped, Prometheus-style.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, Tuple[str, Any]] = {}
        self._collectors: Dict[str, Callable[["MetricsRegistry"], None]] = {}

    def _get(self, kind: str, name: str, factory: Callable[[], Any]):
        with self._lock:
            entry = self._instruments.get(name)
            if entry is None:
                entry = (kind, factory())
                self._instruments[name] = entry
            elif entry[0] != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {entry[0]}, "
                    f"requested {kind}")
            return entry[1]

    def counter(self, name: str) -> Counter:
        return self._get("counter", name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name, Gauge)

    def histogram(self, name: str, cap: int = DEFAULT_RESERVOIR) -> Histogram:
        return self._get("histogram", name, lambda: Histogram(cap=cap))

    def drop(self, prefix: str) -> int:
        """Remove every instrument whose name starts with ``prefix`` —
        lifecycle hygiene for per-handle gauges (``Renderer.close()``)."""
        with self._lock:
            stale = [n for n in self._instruments if n.startswith(prefix)]
            for n in stale:
                del self._instruments[n]
            return len(stale)

    # -- collectors -----------------------------------------------------------

    def register_collector(self, name: str,
                           fn: Callable[["MetricsRegistry"], None]) -> None:
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors.values())
        for fn in collectors:
            fn(self)

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """Schema-versioned dump: ``{schema, time_s, counters, gauges,
        histograms}`` with plain-JSON values throughout."""
        self._run_collectors()
        with self._lock:
            items = sorted(self._instruments.items())
        counters: Dict[str, int] = {}
        gauges: Dict[str, float] = {}
        histograms: Dict[str, dict] = {}
        for name, (kind, inst) in items:
            if kind == "counter":
                counters[name] = inst.value
            elif kind == "gauge":
                gauges[name] = inst.value
            else:
                histograms[name] = inst.snapshot()
        return {
            "schema": SCHEMA,
            "time_s": time.time(),
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }

    def prometheus_text(self) -> str:
        """Prometheus exposition-format dump of the same snapshot."""
        snap = self.snapshot()
        lines: List[str] = []
        for name, v in snap["counters"].items():
            n = _prom_name(name)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {v}")
        for name, v in snap["gauges"].items():
            n = _prom_name(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_prom_value(v)}")
        for name, h in snap["histograms"].items():
            n = _prom_name(name)
            lines.append(f"# TYPE {n} summary")
            for q in (50, 90, 99):
                lines.append(
                    f'{n}{{quantile="0.{q}"}} {_prom_value(h[f"p{q}"])}')
            lines.append(f"{n}_sum {_prom_value(h['sum'])}")
            lines.append(f"{n}_count {h['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every instrument and collector (tests)."""
        with self._lock:
            self._instruments.clear()
            self._collectors.clear()


def _prom_name(name: str) -> str:
    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return n if not n[:1].isdigit() else "_" + n


def _prom_value(v: float) -> str:
    return repr(float(v))


# -- process-wide registry ----------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide registry every stats surface publishes into."""
    global _global
    with _global_lock:
        if _global is None:
            _global = MetricsRegistry()
        return _global
