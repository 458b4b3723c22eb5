"""Resolution-bucketed batching scheduler (a copy of the JAX package's
``repro.serving.bucketing``, DESIGN.md §9).

Groups pending ``RenderRequest``s into buckets keyed by the static render
signature (scene id, RenderConfig, camera geometry) so that every dispatch
hits one cached renderer from core/pipeline.py — a batch never mixes
resolutions, backends, or tile/group configs.

Flush policy (the classic batching latency/throughput dial):
  * a bucket flushes immediately when it reaches ``max_batch`` requests;
  * otherwise it flushes once its OLDEST request has waited ``max_wait``
    seconds (checked by ``poll``), bounding the batching delay any single
    request pays.

Pure Python: the scheduler manipulates request lists and timestamps only.
The clock is injectable so tests drive time deterministically. The
ragged-batch padding arithmetic lives here too (``padded_size``/
``pad_indices``) so it is testable without devices; the tensor-level
padding built on it is ``serving.pad_camera_batch``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.serving.queue import RenderRequest


@dataclasses.dataclass
class Bucket:
    """Requests sharing one executable signature, oldest first."""

    signature: tuple
    requests: List[RenderRequest]
    created_at: float           # arrival of the oldest (first) request

    def __len__(self) -> int:
        return len(self.requests)

    def age(self, now: float) -> float:
        return now - self.created_at


class BucketingScheduler:
    """Accumulates requests into signature buckets; emits flush-ready ones.

    Not thread-safe by itself: the one dispatch loop is the single
    producer/consumer (the thread-safe boundary is the RequestQueue).
    """

    def __init__(
        self,
        max_batch: int = 8,
        max_wait: float = 0.05,
        clock: Optional[Callable[[], float]] = None,
    ):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._clock = clock or time.monotonic
        self._buckets: Dict[tuple, Bucket] = {}

    @property
    def pending(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def add(self, req: RenderRequest, now: Optional[float] = None) -> List[Bucket]:
        """File a request under its signature; returns the buckets this add
        made full (at most one) so the caller can dispatch without waiting
        for the next poll."""
        now = self._clock() if now is None else now
        sig = req.signature()
        bucket = self._buckets.get(sig)
        if bucket is None:
            bucket = self._buckets[sig] = Bucket(sig, [], now)
        stamps = getattr(req, "stamps", None)   # duck-typed request stubs
        if stamps is not None:
            stamps.setdefault("batch_form", now)
        bucket.requests.append(req)
        if len(bucket) >= self.max_batch:
            del self._buckets[sig]
            return [bucket]
        return []

    def poll(self, now: Optional[float] = None) -> List[Bucket]:
        """Flush every bucket whose oldest request has waited max_wait."""
        now = self._clock() if now is None else now
        due = [sig for sig, b in self._buckets.items() if b.age(now) >= self.max_wait]
        return [self._buckets.pop(sig) for sig in due]

    def flush_all(self) -> List[Bucket]:
        """Flush everything (shutdown / drain)."""
        out = list(self._buckets.values())
        self._buckets.clear()
        return out


# ---------------------------------------------------------------------------
# Ragged-batch padding arithmetic (device sharding support)
# ---------------------------------------------------------------------------


def padded_size(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n (n >= 1): the batch size a 1-D
    device mesh of that many devices can split evenly."""
    if n <= 0:
        raise ValueError(f"batch size must be positive, got {n}")
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((n + multiple - 1) // multiple) * multiple


def pad_indices_to(n: int, target: int) -> List[int]:
    """Index vector padding n lanes to exactly ``target``: [0..n-1] + [n-1]*pad.

    Replicating the LAST real camera (rather than inventing a null pose)
    keeps the padded rows inside the numerically-exercised envelope; the
    padded tail is sliced off after the dispatch, so correctness needs only
    the round-trip ``pad_indices_to(n, t)[:n] == list(range(n))`` — which
    makes padding mask-correct by construction. This is THE pad policy:
    ``pad_camera_batch`` builds its tensor-level gather from this vector."""
    if n <= 0:
        raise ValueError(f"batch size must be positive, got {n}")
    if target < n:
        raise ValueError(f"cannot pad {n} lanes down to {target}")
    return list(range(n)) + [n - 1] * (target - n)


def pad_indices(n: int, multiple: int) -> List[int]:
    """``pad_indices_to`` with the target rounded up to ``multiple``."""
    return pad_indices_to(n, padded_size(n, multiple))
