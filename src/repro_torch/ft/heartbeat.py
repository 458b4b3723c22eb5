"""Straggler detection via per-host step heartbeats (a copy of
``repro.ft.heartbeat``).

At scale every host reports (host_id, step, wall_time) after each step; the
monitor flags hosts whose step latency exceeds a robust threshold
(median + k * IQR over a sliding window) — the standard straggler-mitigation
trigger (re-scheduling, checkpoint-evict, or slice replacement upstream).
Pure-python and unit-testable; at deployment the transport is the cluster's
control plane, not this class's concern.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    stragglers: List[int]          # host ids
    slow_factor: Dict[int, float]  # host -> latency / median
    median_s: float


class HeartbeatMonitor:
    def __init__(
        self,
        n_hosts: int,
        window: int = 16,
        iqr_k: float = 3.0,
        min_factor: float = 1.5,
        miss_timeout_s: float = 60.0,
    ):
        self.n_hosts = n_hosts
        self.window = window
        self.iqr_k = iqr_k
        self.min_factor = min_factor
        self.miss_timeout_s = miss_timeout_s
        self._lat: Dict[int, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self._last_seen: Dict[int, float] = {}

    def report(self, host: int, step: int, latency_s: float, now_s: float):
        self._lat[host].append(latency_s)
        self._last_seen[host] = now_s

    def dead_hosts(self, now_s: float) -> List[int]:
        """Hosts that stopped heartbeating entirely (node failure)."""
        return [
            h
            for h in range(self.n_hosts)
            if now_s - self._last_seen.get(h, -1e18) > self.miss_timeout_s
        ]

    def check(self, step: int) -> Optional[StragglerReport]:
        latest = {
            h: d[-1] for h, d in self._lat.items() if len(d) > 0
        }
        if len(latest) < max(2, self.n_hosts // 2):
            return None
        vals = sorted(latest.values())
        med = statistics.median(vals)
        q1 = vals[len(vals) // 4]
        q3 = vals[(3 * len(vals)) // 4]
        iqr = max(q3 - q1, 1e-9)
        thresh = max(med + self.iqr_k * iqr, med * self.min_factor)
        stragglers = sorted(h for h, v in latest.items() if v > thresh)
        if not stragglers:
            return None
        return StragglerReport(
            step=step,
            stragglers=stragglers,
            slow_factor={h: latest[h] / med for h in stragglers},
            median_s=med,
        )
