"""Thread-safe span tracer with Chrome trace-event export (a copy of the
JAX package's ``repro.obs.trace``, DESIGN.md §14).

Spans are COMPLETE events: the caller measures ``[t0, t1]`` on the shared
monotonic clock and hands the finished interval to :meth:`Tracer.complete`
(or lets the :meth:`Tracer.span` context manager / :func:`trace_span`
decorator do it). Events land in a bounded ring buffer — a long-lived
server never grows; the oldest spans fall off and ``dropped`` counts them.

The export format is the Chrome trace-event JSON object form
(``{"traceEvents": [...]}``), loadable in Perfetto / chrome://tracing:

  * ``"ph": "X"`` complete events with ``ts``/``dur`` in microseconds
    relative to the tracer's origin, ``pid`` = this process,
    ``tid`` = the recording thread (or a synthetic lane such as one row
    per serving request);
  * ``"ph": "M"`` metadata events naming the process and every tid.

Clock: ``time.monotonic`` — the SAME clock the serving tier stamps
requests with (``RequestQueue``/``RenderServer`` defaults), so request
lifecycle stamps and stage spans line up on one timeline without any
cross-clock alignment.

:func:`validate_chrome_trace` is the schema checker the tests and
chip_smoke share: every event carries name/ph/ts/dur/pid/tid, and within
each (pid, tid) lane the X events must nest like a call stack (touching
siblings allowed, partial overlap is a violation).
:func:`validate_residency_trace` and :func:`validate_stream_trace` hold the
residency and stream spans to their counters.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

SCHEMA = "repro.trace/v1"
_ENV = "REPRO_TRACE"

# Partial-overlap tolerance for the nesting check, in microseconds. Spans on
# one lane come from sequential code on one clock, so true siblings share
# boundary timestamps exactly; the epsilon only absorbs float64->float
# round-trips through JSON.
_NEST_EPS_US = 0.01


def trace_env_enabled() -> bool:
    """True when ``REPRO_TRACE`` is set to anything but ''/0/false/off."""
    return os.environ.get(_ENV, "").strip().lower() not in ("", "0", "false", "off")


@dataclass(frozen=True)
class SpanEvent:
    """One finished span. Times are raw clock readings (seconds); the
    Chrome export rebases them onto the tracer origin."""

    name: str
    t0: float
    t1: float
    tid: int
    category: str = ""
    args: Optional[Dict[str, Any]] = field(default=None)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Bounded, thread-safe recorder of :class:`SpanEvent`.

    ``enabled`` gates the ambient helpers (:meth:`span`, the decorator,
    serving lifecycle spans): when off they cost one predicate and record
    nothing. :meth:`complete` with ``force=True`` records regardless —
    the timed-stage engine path uses it because ``RenderConfig.timing``
    IS the opt-in there; asking twice would drop spans on the floor.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.monotonic,
                 enabled: Optional[bool] = None):
        self.clock = clock
        self.capacity = int(capacity)
        self._events: "deque[SpanEvent]" = deque(maxlen=self.capacity)
        self._dropped = 0
        self._lock = threading.Lock()
        self._enabled = trace_env_enabled() if enabled is None else bool(enabled)
        self._origin = clock()
        # tid registry: stable small ints per thread / synthetic lane, plus
        # display names for the metadata events.
        self._tids: Dict[Any, int] = {}
        self._tid_names: Dict[int, str] = {}

    # -- enable/disable -------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    # -- tid registry ---------------------------------------------------------

    def _tid_for(self, key: Any, name: str) -> int:
        with self._lock:
            tid = self._tids.get(key)
            if tid is None:
                tid = len(self._tids)
                self._tids[key] = tid
                self._tid_names[tid] = name
            return tid

    def current_tid(self) -> int:
        """tid of the calling thread (registered with its thread name)."""
        t = threading.current_thread()
        return self._tid_for(("thread", t.ident), t.name)

    def lane_tid(self, key: Any, name: Optional[str] = None) -> int:
        """A synthetic lane — e.g. one trace row per serving request — so
        concurrent lifecycles don't interleave on a real thread's row."""
        return self._tid_for(("lane", key), name if name is not None else str(key))

    # -- recording ------------------------------------------------------------

    def complete(self, name: str, t0: float, t1: float, *,
                 category: str = "", args: Optional[Dict[str, Any]] = None,
                 tid: Optional[int] = None, force: bool = False) -> None:
        """Record a finished ``[t0, t1]`` span (clock readings in seconds)."""
        if not (self._enabled or force):
            return
        ev = SpanEvent(name=name, t0=float(t0), t1=float(t1),
                       tid=self.current_tid() if tid is None else tid,
                       category=category, args=args)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, *, category: str = "",
             args: Optional[Dict[str, Any]] = None, tid: Optional[int] = None):
        """Context manager recording the enclosed wall interval."""
        if not self._enabled:
            yield
            return
        t0 = self.clock()
        try:
            yield
        finally:
            self.complete(name, t0, self.clock(), category=category,
                          args=args, tid=tid)

    # -- introspection --------------------------------------------------------

    def events(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    # -- export ---------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace-event JSON document (object form)."""
        pid = os.getpid()
        with self._lock:
            events = list(self._events)
            tid_names = dict(self._tid_names)
        out: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "repro"},
        }]
        for tid, name in sorted(tid_names.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": name}})
        for ev in events:
            rec = {
                "name": ev.name,
                "ph": "X",
                "cat": ev.category or "span",
                "ts": (ev.t0 - self._origin) * 1e6,
                "dur": max(0.0, ev.t1 - ev.t0) * 1e6,
                "pid": pid,
                "tid": ev.tid,
            }
            if ev.args:
                rec["args"] = dict(ev.args)
            out.append(rec)
        return {
            "schema": SCHEMA,
            "displayTimeUnit": "ms",
            "traceEvents": out,
            "dropped": self._dropped,
        }

    def write_chrome_trace(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)


# Stamp-pair -> span-name table for the serving request lifecycle
# (serving/server.py, engine/handle.py): consecutive phases share boundary
# stamps, so the spans tile the request lane without overlap.
REQUEST_PHASES = (
    ("enqueue", "batch_form", "request/queue"),
    ("batch_form", "dispatch", "request/batch_wait"),
    ("dispatch", "device_done", "request/device"),
    ("device_done", "resolve", "request/resolve"),
)


def emit_request_spans(tracer: Tracer, request_id, stamps: Dict[str, float],
                       *, args: Optional[Dict[str, Any]] = None) -> None:
    """Emit the standard request-lifecycle spans onto a per-request lane.

    Each request gets its OWN synthetic tid: concurrent lifecycles on a
    shared lane would partially overlap and break the per-tid nesting
    contract the validator enforces. Missing stamps (e.g. a request that
    skipped the queue) just skip their phase span; an enclosing
    ``request`` span covers enqueue -> resolve when both exist.
    """
    if not tracer.enabled:
        return
    tid = tracer.lane_tid(("request", request_id), f"request {request_id}")
    ev_args = dict(args or {})
    ev_args["request_id"] = request_id
    t0, t_end = stamps.get("enqueue"), stamps.get("resolve")
    if t0 is not None and t_end is not None and t_end >= t0:
        tracer.complete("request", t0, t_end, tid=tid, category="request",
                        args=ev_args)
    for a, b, name in REQUEST_PHASES:
        ta, tb = stamps.get(a), stamps.get(b)
        if ta is not None and tb is not None and tb >= ta:
            tracer.complete(name, ta, tb, tid=tid, category="request",
                            args=ev_args)


# -- validation (shared by tests + scripts/validate_trace.py) -----------------


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema + nesting check; returns a list of violations (empty = valid).

    Checks: the document is the object form with a ``traceEvents`` list;
    every event has name/ph/pid/tid; every ``"X"`` event has numeric
    ``ts``/``dur >= 0``; and per (pid, tid) lane the X events nest like a
    call stack — a span may share boundaries with a sibling but must not
    PARTIALLY overlap an enclosing span.
    """
    errs: List[str] = []
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        return ["document is not an object with a traceEvents list"]
    lanes: Dict[Tuple[Any, Any], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                errs.append(f"event {i}: missing {key!r}")
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            errs.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if ph == "M":
            continue
        ts, dur = ev.get("ts"), ev.get("dur")
        if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
            errs.append(f"event {i}: X event needs numeric ts/dur")
            continue
        if dur < 0:
            errs.append(f"event {i} ({ev.get('name')}): negative dur")
            continue
        lanes.setdefault((ev.get("pid"), ev.get("tid")), []).append(
            (float(ts), float(dur), str(ev.get("name"))))
    for (pid, tid), spans in lanes.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, str]] = []  # (end, name)
        for ts, dur, name in spans:
            end = ts + dur
            while stack and ts >= stack[-1][0] - _NEST_EPS_US:
                stack.pop()
            if stack and end > stack[-1][0] + _NEST_EPS_US:
                errs.append(
                    f"tid {tid}: span {name!r} [{ts:.1f}, {end:.1f}]us "
                    f"partially overlaps enclosing {stack[-1][1]!r} "
                    f"(ends {stack[-1][0]:.1f}us)")
            stack.append((end, name))
    return errs


def _complete_events(doc: Any) -> List[dict]:
    return [e for e in doc.get("traceEvents", [])
            if isinstance(e, dict) and e.get("ph") == "X"]


def validate_residency_trace(doc: Any, counters: Dict[str, Any]) -> List[str]:
    """Residency paging cross-check (the port of ``scripts/validate_trace.py``'s
    residency checks): every page-in/-out records its ``residency/*`` span
    and bumps its ``residency.*`` counter in one critical section, so span
    counts must equal the counters of a metrics snapshot (``counters`` is
    its ``"counters"`` map), and no eviction may lack its page-out. A run
    that never paged (no residency counter, no residency span) passes.
    Returns the violations (empty = consistent)."""
    xs = _complete_events(doc)
    errs: List[str] = []
    if "residency.page_ins_total" not in counters and not any(
        e.get("cat") == "residency" for e in xs
    ):
        return errs
    for name, counter in (
        ("residency/page_in", "residency.page_ins_total"),
        ("residency/page_out", "residency.page_outs_total"),
    ):
        n_span = sum(1 for e in xs if e.get("name") == name)
        n_counter = counters.get(counter, 0)
        if n_span != n_counter:
            errs.append(
                f"{name} spans = {n_span} but counters[{counter!r}] = "
                f"{n_counter}: a page transition lost its span or double-counted")
    evictions = counters.get("residency.evictions_total", 0)
    page_outs = counters.get("residency.page_outs_total", 0)
    if evictions > page_outs:
        errs.append(
            f"counters['residency.evictions_total'] = {evictions} exceeds "
            f"page_outs = {page_outs}: an eviction that never paged out")
    return errs


def validate_stream_trace(doc: Any, counters: Dict[str, Any]) -> List[str]:
    """Stream/speculation cross-check (the port of ``scripts/validate_trace.py``'s
    stream checks): every stream frame records exactly one ``spec/verify``
    span, so their count must equal the stream hit + miss counters and
    ``stream.frames_total``; every speculative frontend records one
    ``spec/run`` span, matching ``spec.runs_total``. A run that served no
    stream passes. Returns the violations (empty = consistent)."""
    xs = _complete_events(doc)
    errs: List[str] = []
    stream_frames = counters.get("stream.frames_total")
    if stream_frames is None and not any(e.get("cat") == "spec" for e in xs):
        return errs
    hits = counters.get("stream.hits_total", 0)
    misses = counters.get("stream.misses_total", 0)
    verifies = sum(1 for e in xs if e.get("name") == "spec/verify")
    if verifies != hits + misses:
        errs.append(
            f"spec/verify spans = {verifies} but stream hit+miss counters total "
            f"{hits + misses} (hits={hits}, misses={misses})")
    if stream_frames != hits + misses:
        errs.append(
            f"counters['stream.frames_total'] = {stream_frames} but hit+miss "
            f"counters total {hits + misses}")
    spec_runs = counters.get("spec.runs_total", 0)
    run_spans = sum(1 for e in xs if e.get("name") == "spec/run")
    if run_spans != spec_runs:
        errs.append(
            f"spec/run spans = {run_spans} but counters['spec.runs_total'] = {spec_runs}")
    return errs


# -- process-wide tracer + ambient helpers ------------------------------------

_global_lock = threading.Lock()
_global: Optional[Tracer] = None


def get_tracer() -> Tracer:
    """The process-wide tracer (created lazily; enabled iff ``REPRO_TRACE``
    is set, until someone calls ``.enable()``/``.disable()``)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = Tracer()
        return _global


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Swap the process-wide tracer (tests); returns the previous one."""
    global _global
    with _global_lock:
        prev, _global = _global, tracer
        return prev


@contextmanager
def span(name: str, *, category: str = "",
         args: Optional[Dict[str, Any]] = None, tid: Optional[int] = None):
    """``with obs.span("phase"):`` on the process-wide tracer."""
    with get_tracer().span(name, category=category, args=args, tid=tid):
        yield


def trace_span(name: Optional[str] = None, *, category: str = ""):
    """Decorator recording one span per call on the process-wide tracer.

    The tracer is resolved at CALL time, so decorating at import does not
    freeze an early (possibly disabled) tracer instance.
    """
    def deco(fn):
        label = name if name is not None else fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            tracer = get_tracer()
            if not tracer.enabled:
                return fn(*a, **kw)
            with tracer.span(label, category=category):
                return fn(*a, **kw)
        return wrapper
    return deco
