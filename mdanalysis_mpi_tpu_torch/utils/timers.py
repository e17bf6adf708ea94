"""Phase timers (SURVEY.md §5.1), the port's copy of the JAX package's
``utils/timers.py``.

The reference's only observability is one per-rank print of its frame
range (RMSF.py:74) and its only performance control is BLAS thread
pinning (RMSF.py:20-25).  The framework replaces that with named phase
accumulators so a run can be decomposed into host I/O / staging /
kernel dispatch / conclude time.

Notes on interpreting the numbers (expanded in docs/OBSERVABILITY.md,
which also shows how to SEE the overlaps these caveats describe on a
per-thread span timeline):

- Staging runs on a prefetch thread concurrently with device compute
  (double buffering), so phase sums may legitimately exceed the
  end-to-end wall time.
- CUDA launches are asynchronous: a phase around device work measures
  the host's enqueue, not the device's execution, unless the block
  ends in a wait on the CUDA stream (``torch.cuda.synchronize``).
  Device time shows up as the tail of ``run`` (the first fetch of a
  result).

Tracing piggyback: when span tracing is enabled
(:mod:`mdanalysis_mpi_tpu_torch.obs`), every ``phase()`` block also records a
span with the same name on the current thread — the one instrumentation
point that covers stage/dispatch/wire/serve_job everywhere they are
timed.  Disabled-mode cost is one attribute check.

Profiler bridge: while a ``torch.profiler`` profile is recording, the
leaf staging phases (:data:`BRIDGED_PHASES`: ``gather``, ``repack``,
``chunk_read``, ``wire``, and ``decode``, the XTC reader's native
decodes inside its ``gather``) also open a
``torch.profiler.record_function`` of their own name, so host staging
shows on the device trace's timeline as user annotations.  Waits and
enclosing phases are never bridged: a trace reader names an idle gap by
the single host event that covers most of it, and an enclosing span
would take every gap from the leaves inside it.  ``gather`` is the one
bridged phase that can enclose another: on the XTC path a gap that
``decode`` covers is covered by its ``gather`` too.  Torch is found
through ``sys.modules`` (this module imports none); with no profiler
recording the bridge costs one set lookup and one module lookup a
bridged phase.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager

from mdanalysis_mpi_tpu_torch.obs import spans as _spans

# ---- phase hooks (the serving layer's heartbeat channel) ----
#
# The scheduler supervisor (service/supervision.py) needs a liveness
# signal from INSIDE a running job: a worker that is making progress
# enters timed phases (stage/dispatch/wire/prepare/...) continuously,
# while a hung dispatch or dead thread stops.  Rather than threading a
# callback through every executor, hooks registered here fire on every
# phase ENTRY on the entering thread — the scheduler's hook renews the
# calling worker's lease; everything else costs one truthiness check.
_PHASE_HOOKS: list = []


def add_phase_hook(fn) -> None:
    """Register ``fn(phase_name)`` to run at every phase entry (any
    PhaseTimers instance, the entering thread).  Hook exceptions are
    swallowed — instrumentation must never fail a run."""
    if fn not in _PHASE_HOOKS:
        _PHASE_HOOKS.append(fn)


def remove_phase_hook(fn) -> None:
    if fn in _PHASE_HOOKS:
        _PHASE_HOOKS.remove(fn)


def _fire_phase_hooks(name: str) -> None:
    for fn in list(_PHASE_HOOKS):
        try:
            fn(name)
        except Exception:
            pass


# ---- per-job phase windows (obs.report attribution) ----
#
# A RunReport used to slice the process-global TIMERS by time window,
# which bled concurrent jobs' phases into each other's reports
# (the documented PR-5 caveat).  Windows fix that: run() opens one
# keyed by the job's trace ids (obs.spans thread context — live even
# with tracing off), and every phase completion whose thread context
# intersects a window's ids accumulates there too.  Cross-thread
# staging keeps its attribution because the executors re-apply the
# captured context on prefetch/pool threads (spans.saved_context).
# Cost when no run is capturing: one list truthiness check per phase.

class PhaseWindow:
    """One run's private phase accumulator, matched by trace ids."""

    __slots__ = ("trace_ids", "_acc", "_calls", "_lock")

    def __init__(self, trace_ids):
        self.trace_ids = frozenset(trace_ids)
        self._acc: dict[str, float] = {}
        self._calls: dict[str, int] = {}
        self._lock = threading.Lock()

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + seconds
            self._calls[name] = self._calls.get(name, 0) + 1

    def snapshot(self) -> tuple[dict, dict]:
        with self._lock:
            return dict(self._acc), dict(self._calls)


_WINDOWS: list[PhaseWindow] = []
_WINDOWS_LOCK = threading.Lock()
#: Backstop on concurrently open windows: capture sites close (or
#: abandon) their window, but a window leaked past both paths must
#: not grow the registry — and the per-phase scan — forever in a
#: long-lived serving process.  Far above any real worker count.
MAX_WINDOWS = 64


def open_window(trace_ids) -> PhaseWindow:
    """Start attributing matching phase completions to a new window
    (``obs.report.start_capture`` calls this when the current thread
    carries a trace context)."""
    w = PhaseWindow(trace_ids)
    with _WINDOWS_LOCK:
        if len(_WINDOWS) >= MAX_WINDOWS:
            _WINDOWS.pop(0)             # oldest — a leak, not live
        _WINDOWS.append(w)
    return w


def close_window(window: PhaseWindow) -> None:
    with _WINDOWS_LOCK:
        try:
            _WINDOWS.remove(window)
        except ValueError:
            pass


def _attribute_window(name: str, seconds: float) -> None:
    # caller checked `_WINDOWS` (the near-free miss path); re-check
    # under the race anyway via the local copy
    ids = _spans.current_trace_ids()
    if not ids:
        return
    with _WINDOWS_LOCK:
        windows = list(_WINDOWS)
    for w in windows:
        if w.trace_ids & ids:
            w._add(name, seconds)


#: The leaf staging phases that become ``record_function`` annotations
#: while a torch profiler records (README.md, "Profiler bridge").
BRIDGED_PHASES = frozenset(("gather", "repack", "chunk_read", "wire",
                            "decode"))


def _profiler_annotation(name: str):
    """A ``torch.profiler.record_function(name)`` context while a
    torch profiler is recording, else None.  The recording flag is read from
    ``torch.autograd.profiler._is_profiler_enabled``, which every
    thread sees; ``torch._C._autograd._profiler_enabled()`` reads False
    on a thread the profile was not opened on."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    return prof.record_function(name)


class PhaseTimers:
    """Accumulating named wall-clock phase timers.

    Thread-safe: the process-global :data:`TIMERS` is mutated
    concurrently by the serving scheduler's worker pool and the
    executors' prefetch thread, and the unguarded dict read-modify-write
    this class used to do lost updates under that load (the regression
    test in ``tests/test_obs.py`` hammers ``phase()`` from N threads
    and asserts exact call counts).

    >>> t = PhaseTimers()
    >>> with t.phase("stage"):
    ...     pass
    >>> t.report()["stage"]["calls"]
    1
    """

    def __init__(self):
        self._acc: dict[str, float] = {}
        self._calls: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str, **span_args):
        """Time the enclosed block under ``name``.  ``span_args`` ride
        the piggybacked span (e.g. ``scan_k``) when tracing is on;
        they never touch the timer accounting."""
        if _PHASE_HOOKS:
            _fire_phase_hooks(name)
        sp = _spans.span(name, **span_args)
        sp.__enter__()
        rf = _profiler_annotation(name) if name in BRIDGED_PHASES else None
        if rf is not None:
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            sp.__exit__(None, None, None)
            with self._lock:
                self._acc[name] = self._acc.get(name, 0.0) + dt
                self._calls[name] = self._calls.get(name, 0) + 1
            if _WINDOWS:
                _attribute_window(name, dt)

    def add(self, name: str, seconds: float) -> None:
        """Record an externally measured duration under ``name``."""
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + seconds
            self._calls[name] = self._calls.get(name, 0) + 1
        if _WINDOWS:
            _attribute_window(name, seconds)

    def seconds(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def calls(self, name: str) -> int:
        """How many times ``name`` was entered — e.g. ``calls("dispatch")``
        is the batch-kernel dispatch count, the number the scan-folded
        schedule exists to shrink (bench artifacts report it per leg as
        ``dispatch_count``)."""
        return self._calls.get(name, 0)

    def report(self) -> dict:
        """{phase: {"seconds": total, "calls": n}} sorted by cost."""
        with self._lock:
            return {
                k: {"seconds": round(self._acc[k], 6),
                    "calls": self._calls[k]}
                for k in sorted(self._acc, key=self._acc.get,
                                reverse=True)
            }

    def snapshot(self) -> tuple[dict, dict]:
        """Consistent ``(seconds, calls)`` copies — what run-scoped
        deltas (obs.report) subtract against."""
        with self._lock:
            return dict(self._acc), dict(self._calls)

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()
            self._calls.clear()


#: Process-global default registry.  Executors and ``AnalysisBase.run``
#: record into this unless handed an explicit ``PhaseTimers``.
TIMERS = PhaseTimers()


@contextmanager
def device_trace(trace_dir: str | None):
    """Optional ``torch.profiler`` trace around a region (SURVEY.md
    §5.1 "optional profiler trace hooks"; the JAX package uses
    ``jax.profiler.trace`` here).

    ``trace_dir`` None → no-op.  Otherwise profiles host and CUDA
    activity (CUDA only when a card is present) on every thread, the
    staging threads' bridged phases included, and writes a Chrome
    trace-event file, ``trace.json``, under ``trace_dir`` (view it in
    Perfetto or ``chrome://tracing``).  The region ends in a wait on
    the current CUDA stream, so the trace holds the device work the
    region queued.
    """
    if not trace_dir:
        yield
        return
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=every_thread) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

