"""Observability layer: the pieces the block store, the fault mirror and
the circuit breaker count on.

- :mod:`~mdanalysis_mpi_tpu_torch.obs.spans` — hierarchical span tracing
  exported as Chrome trace-event JSON (Perfetto / ``chrome://tracing``).
  Off by default; enabled by ``MDTPU_TRACE_OUT`` or
  :func:`enable_tracing`, and NEAR-FREE when disabled (shared no-op
  span, no allocation).
- :mod:`~mdanalysis_mpi_tpu_torch.obs.metrics` — a counters/gauges/histograms
  registry, snapshotable as one JSON document and as Prometheus text
  exposition.  Its known-metric schema is the JAX package's.
- :mod:`~mdanalysis_mpi_tpu_torch.obs.usage` — per-tenant usage metering
  (the store reader charges chunk reads here).
- :mod:`~mdanalysis_mpi_tpu_torch.obs.report` — the per-run
  ``RunReport`` that ``AnalysisBase.run_streaming`` attaches under
  ``results.observability`` (phase totals from ``utils/timers``).

The JAX package's continuous profiler, alert rules, perf-regression
sentinel and flight recorder wait for the serving layers that call
them (ROADMAP A10).

Import layering: this package imports ONLY the standard library — the
rest of the package imports it, never the reverse, so instrumentation
can thread anywhere without cycles.
"""

from mdanalysis_mpi_tpu_torch.obs import usage as usage
from mdanalysis_mpi_tpu_torch.obs.metrics import (
    METRICS, MetricsRegistry, to_prometheus, unified_snapshot,
)
from mdanalysis_mpi_tpu_torch.obs.report import (
    abandon_capture, finish_capture, start_capture,
)
from mdanalysis_mpi_tpu_torch.obs.spans import (
    context as trace_context,
    disable as disable_tracing,
    enable as enable_tracing,
    enabled as tracing_enabled,
    export as export_trace,
    maybe_enable_from_env,
    span,
    span_event,
    trace_path,
)

# run-capture helpers under their obs.* names (run_streaming calls
# obs.start_run_capture / obs.finish_run_capture, and
# obs.abandon_run_capture when the run raises in between)
start_run_capture = start_capture
finish_run_capture = finish_capture
abandon_run_capture = abandon_capture

__all__ = [
    "METRICS", "MetricsRegistry", "to_prometheus", "unified_snapshot",
    "span", "span_event", "trace_context", "enable_tracing",
    "disable_tracing", "tracing_enabled", "export_trace", "trace_path",
    "maybe_enable_from_env", "usage", "start_run_capture",
    "finish_run_capture", "abandon_run_capture",
]
