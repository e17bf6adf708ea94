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
  ``RunReport`` that ``AnalysisBase.run`` and ``run_streaming`` attach
  under ``results.observability`` (phase totals from ``utils/timers``).

Plus the active layer the serving scheduler drives:

- :mod:`~mdanalysis_mpi_tpu_torch.obs.prof` — continuous sampling
  profiler (collapsed stacks, per-dispatch latency histograms per
  program geometry, RSS/staged-bytes/cache watermarks), behind
  ``MDTPU_PROF``;
- :mod:`~mdanalysis_mpi_tpu_torch.obs.alerts` — declarative threshold /
  rate / multi-window burn-rate rules over the unified snapshot;
- :mod:`~mdanalysis_mpi_tpu_torch.obs.baseline` — the perf-regression
  sentinel over a bench record (``python -m mdanalysis_mpi_tpu_torch
  perf``);
- :mod:`~mdanalysis_mpi_tpu_torch.obs.flight` — the flight recorder's
  black-box dumps on quarantine and worker fencing.

Import layering: this package imports ONLY the standard library — the
rest of the package imports it, never the reverse, so instrumentation
can thread anywhere without cycles.
"""

from mdanalysis_mpi_tpu_torch.obs import alerts as alerts
from mdanalysis_mpi_tpu_torch.obs import baseline as baseline
from mdanalysis_mpi_tpu_torch.obs import flight as flight
from mdanalysis_mpi_tpu_torch.obs import prof as prof
from mdanalysis_mpi_tpu_torch.obs import usage as usage
from mdanalysis_mpi_tpu_torch.obs.alerts import (
    AlertEngine, AlertRule, seed_rules,
)
from mdanalysis_mpi_tpu_torch.obs.flight import dump as flight_dump
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
    span,
    span_event,
    trace_path,
)


def maybe_enable_from_env() -> None:
    """Honor the observability env knobs at every run/serve entry:
    ``MDTPU_TRACE_OUT`` (span tracing) and ``MDTPU_PROF`` (the
    continuous profiler).  One attribute read each once enabled."""
    from mdanalysis_mpi_tpu_torch.obs import spans as _spans

    _spans.maybe_enable_from_env()
    prof.maybe_enable_from_env()


# run-capture helpers under their obs.* names (AnalysisBase.run and
# run_streaming call obs.start_run_capture / obs.finish_run_capture,
# and obs.abandon_run_capture when the run raises in between)
start_run_capture = start_capture
finish_run_capture = finish_capture
abandon_run_capture = abandon_capture

__all__ = [
    "METRICS", "MetricsRegistry", "to_prometheus", "unified_snapshot",
    "span", "span_event", "trace_context", "enable_tracing",
    "disable_tracing", "tracing_enabled", "export_trace", "trace_path",
    "maybe_enable_from_env", "start_run_capture",
    "finish_run_capture", "abandon_run_capture", "flight",
    "flight_dump", "prof", "alerts", "baseline", "AlertEngine",
    "AlertRule", "seed_rules", "usage",
]
