"""The LRU residency manager: paged scene storage under a device budget
(mirror of ``repro.residency.manager``, DESIGN.md §17).

  * ``register()`` files one :class:`ResidencyEntry` per committed
    ``(scene identity, shard layout, mesh)``, with a HOST copy of the
    staged layout as its paging backing store, so a page-out never loses
    the scene. The copy is taken at registration and never aliases the
    caller's tensors: a torch scene is mutable in place, and the entry must
    keep the bits the commit saw. When the placement holds a CUDA device it
    lives in pinned memory, so a page-in is one DMA per tensor. Entries are refcounted:
    every handle over the same layout shares ONE entry, and therefore one
    device copy.
  * ``acquire()`` returns the device-resident scene, paging it in on a
    miss. Page-in evicts least-recently-ACQUIRED resident entries until the
    aggregate cost fits the budget. Eviction drops the manager's device
    reference; an in-flight render keeps its own reference to the tensors
    it was handed, so paging can never corrupt a dispatch.
  * The placement is a device (the scene goes there whole) or a
    ``sharding/policies.py::Placement`` (a mesh and a spec, as the JAX
    manager takes a ``NamedSharding``): a page-in then copies each shard of
    the backing to its devices (``place``).
  * Paging is bitwise-invisible: a page-in copies the bits the commit saw,
    so a paged-out-then-reloaded scene renders exactly as one that never
    moved.
  * Entry cost = the handle's static per-device model (scene parameters +
    per-camera projected features, DESIGN.md §12) PLUS dynamic cost
    callbacks: the handles' stream frontend caches
    (``Renderer.frontend_cache_mb``).

A page-out frees the tensors, not the device memory: PyTorch's caching
allocator keeps the freed blocks for this process to reuse, so
``torch.cuda.memory_allocated`` drops at a page-out while
``memory_reserved`` does not. The next page-in, or any other allocation of
the process, reuses those blocks.

Observability: ``residency.*`` counters and ``residency/page_in`` /
``residency/page_out`` spans are recorded together in one critical
section, so ``obs.validate_residency_trace`` can cross-check them exactly.
"""
from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.obs import get_registry, get_tracer
from repro_torch.sharding.policies import Placement, place
from repro_torch.utils import pytree_bytes, tree_map


def _host_backing(tree, pinned: bool):
    """A host copy of a staged scene: the paging backing store. Always a
    copy (``clone`` for CPU tensors: the caller may change its scene in
    place after the commit); pinned when the placement holds a CUDA
    device."""
    if pinned:
        return tree_map(lambda x: x.detach().cpu().pin_memory(), tree)
    return tree_map(lambda x: x.detach().cpu().clone(), tree)


class ResidencyEntry:
    """One committed scene layout: host backing + (maybe) a device copy.

    All mutation happens under the owning manager's lock; handles hold the
    entry object itself and go through :meth:`ResidencyManager.acquire` for
    every device use.
    """

    __slots__ = (
        "key", "label", "backing", "device_to", "static_mb", "nbytes", "device",
        "refs", "seq", "cost_fns", "page_ins", "source",
    )

    def __init__(self, key, backing, device_to, static_mb, label, source=None):
        self.key = key
        # A weak reference to the scene the key's id() names, or None.
        self.source = weakref.ref(source) if source is not None else None
        self.label = label
        self.backing = backing
        self.device_to = device_to       # where a page-in puts the scene: a
                                         # device or a Placement
        self.static_mb = float(static_mb)
        self.nbytes = pytree_bytes(backing)   # what one page-in moves
        self.device: Any = None          # the device scene; None = paged out
        self.refs = 0
        self.seq = 0                     # LRU stamp (manager clock)
        self.page_ins = 0
        # Dynamic per-entry cost callbacks (MB): device memory the static
        # model cannot see (the handles' stream frontend caches).
        # Weakref-backed, so an entry never pins its handles.
        self.cost_fns: List[Callable[[], float]] = []

    @property
    def resident(self) -> bool:
        return self.device is not None

    def cost_mb(self) -> float:
        """Static model + dynamic callbacks, in per-device MB."""
        extra = 0.0
        for fn in list(self.cost_fns):
            try:
                extra += float(fn())
            except Exception:            # noqa: BLE001 — a closing stream
                pass                     # must not poison eviction decisions
        return self.static_mb + extra


class ResidencyManager:
    """LRU paging of committed scenes against a per-device MB budget.

    ``budget_mb=None`` never evicts (every entry stays resident once paged
    in) but still dedupes device copies per layout. Thread-safe: one lock
    serializes register/acquire/release/eviction.
    """

    def __init__(self, budget_mb: Optional[float] = None, name: str = "residency"):
        self.budget_mb = budget_mb
        self.name = name
        self._lock = threading.RLock()
        self._entries: Dict[Any, ResidencyEntry] = {}
        self._seq = 0
        self._orphans = itertools.count()
        self._counters = {
            "page_ins": 0, "page_outs": 0, "evictions": 0,
            "hits": 0, "prefetches": 0, "over_budget": 0,
        }

    # -- registration / lifecycle -------------------------------------------

    def register(
        self,
        key,
        staged,
        device,
        static_mb: float,
        label: Optional[str] = None,
        source=None,
    ) -> ResidencyEntry:
        """File (or ref-share) the entry for ``key``; does NOT page in.

        ``device`` is where a page-in puts the scene: a device, or a
        ``Placement`` (mesh and spec); one that holds a CUDA device pins the
        host backing. A second handle over the same layout gets the SAME
        entry (refs+1), so two configs over one scene hold one scene copy.
        ``static_mb`` takes the max across registrants. ``source``, the
        object whose id() the key holds, guards against a reused id: a
        live entry filed for another object moves to a key of its own.
        """
        with self._lock:
            entry = self._entries.get(key)
            if (entry is not None and source is not None and entry.source is not None
                    and entry.source() is not source):
                self._entries.pop(key)
                entry.key = ("orphan", next(self._orphans), key)
                self._entries[entry.key] = entry
                entry = None
            if entry is None:
                if isinstance(device, Placement):
                    pinned = device.has_cuda
                else:
                    device = torch.device(device)
                    pinned = device.type == "cuda"
                entry = ResidencyEntry(
                    key, _host_backing(staged, pinned), device, static_mb,
                    label or repr(key), source,
                )
                self._entries[key] = entry
            else:
                entry.static_mb = max(entry.static_mb, float(static_mb))
            entry.refs += 1
            return entry

    def release(self, entry: ResidencyEntry) -> None:
        """Drop one reference; the last release pages out and removes the
        entry entirely (device copy AND host backing)."""
        with self._lock:
            entry.refs -= 1
            if entry.refs > 0:
                return
            if entry.resident:
                self._page_out(entry, reason="release")
            self._entries.pop(entry.key, None)
            entry.cost_fns.clear()

    # -- the paging protocol -------------------------------------------------

    def acquire(self, entry: ResidencyEntry):
        """The device-resident scene for ``entry``, paging in on a miss.
        Every render path calls this; a resident acquire is an LRU touch
        plus a counter (no device work)."""
        with self._lock:
            self._seq += 1
            entry.seq = self._seq
            if entry.resident:
                self._counters["hits"] += 1
                get_registry().counter("residency.hits_total").inc()
                return entry.device
            return self._page_in(entry)

    def prefetch(self, entry: ResidencyEntry) -> bool:
        """Admission-time page-in: warm the scene before its dispatch
        arrives. True when a transfer happened (a resident scene is a no-op
        that does NOT touch LRU order: a queued request must not shield a
        cold scene from eviction forever)."""
        with self._lock:
            if entry.resident:
                return False
            self._counters["prefetches"] += 1
            get_registry().counter("residency.prefetch_total").inc()
            self._seq += 1
            entry.seq = self._seq
            self._page_in(entry)
            return True

    def _page_in(self, entry: ResidencyEntry):
        """Lock held. Evict LRU-cold residents until ``entry`` fits, then
        copy the backing store to the entry's device, or place it over the
        entry's mesh (``sharding/policies.py::place``). The copy from pinned
        memory is synchronous, so the span covers the transfer (and any
        work queued before it on the stream)."""
        registry = get_registry()
        tracer = get_tracer()
        if self.budget_mb is not None:
            need = entry.cost_mb()
            while self._resident_mb() + need > self.budget_mb:
                victim = min(
                    (e for e in self._entries.values() if e.resident and e is not entry),
                    key=lambda e: e.seq,
                    default=None,
                )
                if victim is None:
                    # Nothing left to evict: the active scene (plus its live
                    # stream caches) exceeds the budget alone. Rendering must
                    # proceed, so count the violation.
                    self._counters["over_budget"] += 1
                    registry.counter("residency.over_budget_total").inc()
                    break
                self._evict(victim)
        t0 = tracer.clock()
        to = entry.device_to
        if isinstance(to, Placement):
            entry.device = place(entry.backing, to.mesh, to.spec)
        else:
            entry.device = tree_map(lambda x: x.to(to), entry.backing)
        t1 = tracer.clock()
        entry.page_ins += 1
        # Counter + span in ONE critical section: the residency cross-check
        # (spans == counters) can never race.
        self._counters["page_ins"] += 1
        registry.counter("residency.page_ins_total").inc()
        tracer.complete(
            "residency/page_in", t0, t1, category="residency",
            args={"entry": entry.label, "mb": round(entry.static_mb, 4),
                  "bytes": entry.nbytes},
        )
        self._publish_gauges()
        return entry.device

    def _evict(self, entry: ResidencyEntry) -> None:
        """Lock held. Budget eviction = a counted page-out."""
        self._counters["evictions"] += 1
        get_registry().counter("residency.evictions_total").inc()
        self._page_out(entry, reason="evict")

    def _page_out(self, entry: ResidencyEntry, reason: str) -> None:
        """Lock held. Drop the manager's device reference. The tensors free
        once no in-flight render holds them; their blocks go back to the
        caching allocator (see the module docstring). The host backing
        stays."""
        tracer = get_tracer()
        t0 = tracer.clock()
        entry.device = None
        t1 = tracer.clock()
        self._counters["page_outs"] += 1
        get_registry().counter("residency.page_outs_total").inc()
        tracer.complete(
            "residency/page_out", t0, t1, category="residency",
            args={"entry": entry.label, "reason": reason},
        )
        self._publish_gauges()

    # -- accounting / introspection ------------------------------------------

    def _resident_mb(self) -> float:
        return sum(e.cost_mb() for e in self._entries.values() if e.resident)

    def _publish_gauges(self) -> None:
        registry = get_registry()
        registry.gauge("residency.resident_mb").set(self._resident_mb())
        registry.gauge("residency.resident_entries").set(
            sum(1 for e in self._entries.values() if e.resident)
        )

    def resident_keys(self) -> list:
        with self._lock:
            return [e.key for e in self._entries.values() if e.resident]

    def stats(self) -> dict:
        with self._lock:
            resident = [e for e in self._entries.values() if e.resident]
            return {
                "budget_mb": self.budget_mb,
                "entries": len(self._entries),
                "resident_entries": len(resident),
                "resident_mb": self._resident_mb(),
                **dict(self._counters),
            }

    def __repr__(self) -> str:
        s = self.stats()
        return (
            f"<ResidencyManager {self.name} budget={self.budget_mb} "
            f"resident={s['resident_entries']}/{s['entries']} "
            f"page_ins={s['page_ins']} page_outs={s['page_outs']}>"
        )
