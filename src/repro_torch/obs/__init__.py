"""Observability layer: tracing spans + metrics registry (a copy of the
JAX package's pure-Python ``repro.obs``, DESIGN.md §14).

Pure Python: importing ``repro_torch.obs`` imports neither torch nor jax.

  * ``repro_torch.obs.trace`` — a thread-safe :class:`Tracer` ring buffer of
    complete spans with Chrome trace-event JSON export (Perfetto-loadable)
    and :func:`validate_chrome_trace`, with the residency, stream and
    gateway span-against-counter cross-checks beside it.
  * ``repro_torch.obs.metrics`` — a :class:`MetricsRegistry` of named
    counters/gauges/reservoir histograms behind the port's stats surfaces
    (``Renderer.stats()``, the render-cache registry), exported as a
    schema-versioned snapshot dict or Prometheus text.

The per-stage ``stage/<name>`` spans come from ``RenderConfig(timing=True)``
(``core/stages.py::TimedBackend``).
"""
from repro_torch.obs.trace import (
    REQUEST_PHASES,
    SpanEvent,
    emit_request_spans,
    Tracer,
    get_tracer,
    set_tracer,
    span,
    trace_env_enabled,
    trace_span,
    validate_chrome_trace,
    validate_gateway_trace,
    validate_residency_trace,
    validate_stream_trace,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    percentile,
)

__all__ = [
    "REQUEST_PHASES",
    "SpanEvent",
    "emit_request_spans",
    "Tracer",
    "get_tracer",
    "set_tracer",
    "span",
    "trace_env_enabled",
    "trace_span",
    "validate_chrome_trace",
    "validate_gateway_trace",
    "validate_residency_trace",
    "validate_stream_trace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "percentile",
]
