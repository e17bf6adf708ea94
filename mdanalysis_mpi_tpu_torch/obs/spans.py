"""Span tracing: hierarchical wall-clock spans → Chrome trace-event JSON.

The repo's phase timers (``utils/timers.py``) answer "how much total
time went to staging vs dispatch" but are blind to WHEN: staging runs
on a prefetch thread concurrently with device compute, so phase sums
legitimately exceed wall time and the overlap — the thing double
buffering exists to create — was invisible.  Spans fix that: every
instrumented region records a ``(name, thread, t0, duration, args)``
complete event, and :func:`export` writes the standard Chrome
trace-event JSON that Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` load directly — one row per thread, staging spans
on the prefetch row visibly overlapping dispatch spans on the main row
(docs/OBSERVABILITY.md).

Span model (nesting is by time containment per thread row, the Chrome
"X" complete-event convention)::

    run → pass → {read, stage, dispatch, wire, device_wait, fetch}
    serve_job → coalesced_pass → run → ...

Instant events (``ph: "i"``) mark reliability incidents: ``retry``,
``frame_drop``, ``executor_fallback``, ``fault_injected``.  Structured
``log_event`` lines mirror onto the same timeline (``cat: "log"``) so
:func:`tail` shows breaker transitions and serving snapshots
interleaved with phases in one monotonic order.

Near-free when disabled — the contract the hot paths rely on:
:func:`span` returns ONE shared no-op context manager (no allocation,
no clock read, no lock) unless tracing was enabled via
:func:`enable` / the ``MDTPU_TRACE_OUT`` env knob.  Tests pin this
(``tests/test_obs.py``: disabled-mode spans allocate no events).

Cross-thread/job attribution: :func:`context` merges fields (job ids,
tenants, trace ids) into every span recorded on the current thread
while active — the serving scheduler wraps each execution unit in one,
so a coalesced pass's spans carry every member job.  The context is
live even while RECORDING is off (it is per execution unit, not per
frame): run reports derive their per-job phase attribution from it
(``utils/timers.py`` phase windows), so concurrent scheduler workers
get exact per-job phase totals with tracing disabled.

Buffer semantics: the event buffer is a RING of :data:`MAX_EVENTS`
— when it is full the OLDEST events are evicted (counted, disclosed
in the exported ``otherData.dropped_events``), so :func:`tail` always
holds the most recent window: the flight recorder's black box
(``obs/flight.py``) relies on "recent" staying current forever.

Process-wide args (:func:`set_process_args`) merge into every recorded
event at the lowest precedence, and :func:`counter_event` records the
continuous profiler's watermark line (``obs/prof.py``).  The JAX
package's fleet trace shipping is not carried here yet.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque


#: bound of the event ring (the JAX package's default)
MAX_EVENTS = 500_000


class _TraceState:
    __slots__ = ("enabled", "path", "events", "dropped", "t0",
                 "tid_names", "proc_args")

    def __init__(self):
        self.enabled = False
        self.path: str | None = None
        self.events: deque = deque()
        # bounded RING: a long process with tracing left on must not
        # grow memory without limit; overflow evicts the OLDEST events
        # (counted and disclosed in the exported document, never
        # silent) so the tail stays the most recent window
        self.dropped = 0
        self.t0 = time.perf_counter()
        self.tid_names: dict[int, str] = {}
        #: process-wide args merged (lowest precedence) into every
        #: recorded span/event
        self.proc_args: dict | None = None


_STATE = _TraceState()
_LOCK = threading.Lock()
_CTX = threading.local()


def enabled() -> bool:
    """Hot-path guard: is tracing recording right now?"""
    return _STATE.enabled


def trace_path() -> str | None:
    """The file the trace will export to (None: in-memory only /
    tracing disabled)."""
    return _STATE.path if _STATE.enabled else None


def enable(path: str | None = None) -> None:
    """Start recording spans.  ``path`` is where :func:`export` (and
    the per-run auto-export in ``AnalysisBase.run``) writes the Chrome
    trace JSON; None records in memory only."""
    with _LOCK:
        # the trace epoch (t0) deliberately survives enable/disable
        # cycles: re-enabling continues the same timeline
        _STATE.path = path
        _STATE.enabled = True


def disable(discard: bool = False) -> None:
    with _LOCK:
        _STATE.enabled = False
        _STATE.path = None
        if discard:
            _STATE.events.clear()
            _STATE.tid_names.clear()
            _STATE.dropped = 0


def reset() -> None:
    """Drop every recorded event and restart the trace clock (tests;
    long-lived processes rotating trace files)."""
    with _LOCK:
        _STATE.events.clear()
        _STATE.tid_names.clear()
        _STATE.dropped = 0
        _STATE.t0 = time.perf_counter()


def maybe_enable_from_env() -> None:
    """Honor ``MDTPU_TRACE_OUT=<file>`` — checked at every run entry so
    the knob works however late the environment set it.  A no-op once
    tracing is on (one attribute read)."""
    if _STATE.enabled:
        return
    path = os.environ.get("MDTPU_TRACE_OUT")
    if path:
        enable(path)


def n_events() -> int:
    with _LOCK:
        return len(_STATE.events)


def tail(limit: int = 50, trace_id: str | None = None) -> list[dict]:
    """The most recent recorded events (copies), newest last — spans,
    instants and mirrored log events in one shared monotonic (append)
    order.  With ``trace_id``, keeps events whose merged args carry it
    in their ``trace_ids``/``trace_id`` attribution PLUS the globally
    attributed instants (retries, breaker transitions, lease reaps,
    fencing — incidents recorded outside any job context), so a
    quarantined job's diagnostics show its phases interleaved with the
    process-level incidents that surrounded them.  Empty when tracing
    is off."""
    with _LOCK:
        events = list(_STATE.events)
    if trace_id is not None:
        def _keep(ev):
            args = ev.get("args") or {}
            if (trace_id in (args.get("trace_ids") or ())
                    or args.get("trace_id") == trace_id):
                return True
            # globally attributed instants/log marks: incidents that
            # belong to no single job ride along for context
            return (ev.get("ph") == "i"
                    and not args.get("trace_ids")
                    and not args.get("trace_id"))

        events = [ev for ev in events if _keep(ev)]
    return [dict(ev) for ev in events[-limit:]]


def _merged_args(args: dict) -> dict:
    ctx = getattr(_CTX, "args", None)
    proc = _STATE.proc_args
    if not ctx and not proc:
        return args
    merged = dict(proc) if proc else {}
    if ctx:
        merged.update(ctx)
    merged.update(args)
    return merged


def set_process_args(**args) -> None:
    """Merge ``args`` into EVERY span/event this process records, for
    the life of the process (lowest precedence — thread contexts and
    per-span args override).  Pass nothing to clear."""
    with _LOCK:
        _STATE.proc_args = dict(args) if args else None


def process_args() -> dict | None:
    """The current :func:`set_process_args` value (the flight recorder
    stamps it into its dump header)."""
    return dict(_STATE.proc_args) if _STATE.proc_args else None


def _append(ev: dict, tid: int, thread_name: str) -> None:
    st = _STATE
    with _LOCK:
        # Perfetto labels the row with the thread's name — how the
        # prefetch row is told apart from MainThread in the UI.  Kept
        # OUT of the ring (regenerated at export) so eviction can never
        # unlabel a row.
        st.tid_names.setdefault(tid, thread_name)
        st.events.append(ev)
        if len(st.events) > MAX_EVENTS:
            st.events.popleft()          # ring: evict oldest, counted
            st.dropped += 1


_PID = os.getpid()


class _Span:
    """One recording complete-event ("X") span."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        st = _STATE
        if not st.enabled:          # disabled mid-span: drop silently
            return False
        th = threading.current_thread()
        # the kernel's thread id: ``th.ident`` is a stack address that
        # the next thread started may reuse at once, merging two rows
        tid = th.native_id or 0
        ev = {"ph": "X", "cat": "mdtpu", "name": self.name,
              "ts": round((self._t0 - st.t0) * 1e6, 1),
              "dur": round((t1 - self._t0) * 1e6, 1),
              "pid": _PID, "tid": tid}
        args = _merged_args(self.args)
        if args:
            ev["args"] = args
        _append(ev, tid, th.name)
        return False


class _NoopSpan:
    """THE shared disabled-mode span: entering/exiting it allocates
    nothing and records nothing (identity-pinned by tests)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoopSpan()


def span(name: str, **args):
    """Context manager recording one span — the shared no-op when
    tracing is disabled."""
    if not _STATE.enabled:
        return NOOP
    return _Span(name, args)


def _instant(name: str, args: dict, cat: str) -> None:
    st = _STATE
    th = threading.current_thread()
    tid = th.native_id or 0
    ev = {"ph": "i", "cat": cat, "name": name, "s": "t",
          "ts": round((time.perf_counter() - st.t0) * 1e6, 1),
          "pid": _PID, "tid": tid}
    merged = _merged_args(args)
    if merged:
        ev["args"] = merged
    _append(ev, tid, th.name)


def span_event(name: str, **args) -> None:
    """Record an instant event (reliability incidents: retries, frame
    drops, fallbacks, injected faults).  No-op when disabled."""
    if not _STATE.enabled:
        return
    _instant(name, args, "mdtpu")


def counter_event(name: str, **values) -> None:
    """Record a Chrome counter event (``ph:"C"``) — Perfetto renders
    the values as a stacked area row (the profiler's RSS/watermark
    line, obs/prof.py).  No-op when disabled."""
    if not _STATE.enabled:
        return
    st = _STATE
    th = threading.current_thread()
    tid = th.native_id or 0
    ev = {"ph": "C", "cat": "mdtpu", "name": name,
          "ts": round((time.perf_counter() - st.t0) * 1e6, 1),
          "pid": _PID, "tid": tid, "args": values}
    _append(ev, tid, th.name)


def log_mark(name: str, **args) -> None:
    """Mirror one structured log event onto the span timeline
    (``cat: "log"`` instant), so :func:`tail` shows log lines
    interleaved with phases and incidents in one monotonic order.
    ``utils/log.log_event`` calls this with its scalar fields; no-op
    when disabled."""
    if not _STATE.enabled:
        return
    _instant(name, args, "log")


class _Context:
    __slots__ = ("args", "_prev")

    def __init__(self, args: dict):
        self.args = args

    def __enter__(self):
        prev = getattr(_CTX, "args", None)
        self._prev = prev
        merged = dict(prev) if prev else {}
        merged.update(self.args)
        _CTX.args = merged
        return self

    def __exit__(self, *exc):
        _CTX.args = self._prev
        return False


def context(**args):
    """Merge ``args`` into every span/event recorded on THIS thread
    inside the block — the serving layer's job/tenant attribution
    channel.  Live even while tracing is OFF (it is entered per
    execution unit, never per frame): the run report's per-job phase
    windows key off :func:`current_trace_ids`, so concurrent scheduler
    workers keep exact per-job phase attribution with recording
    disabled."""
    return _Context(args)


def current_context() -> dict | None:
    """The calling thread's active context args (None when no context
    is active) — capture this BEFORE handing work to another thread,
    and re-apply it there with :func:`saved_context`.  The context is
    thread-local by design, so without this hand-off a prefetch/pool
    thread's spans (and phase-window attribution) would silently lose
    the job/tenant identity the scheduler stamped on the submitting
    thread."""
    return getattr(_CTX, "args", None)


def saved_context(args: dict | None):
    """Re-apply a :func:`current_context` capture on the current
    (different) thread.  No-op when nothing was captured."""
    if not args:
        return NOOP
    return _Context(args)


def current_trace_ids() -> frozenset | None:
    """The trace ids attributed to the current thread's active
    context, or None — what ``utils/timers.py`` phase windows match
    against for per-job phase attribution."""
    args = getattr(_CTX, "args", None)
    if not args:
        return None
    ids = args.get("trace_ids")
    if ids:
        return frozenset(ids)
    tid = args.get("trace_id")
    return frozenset((tid,)) if tid else None


_EXPORT_LOCK = threading.Lock()


def document() -> dict:
    """The recorded events as a Chrome trace-event document (thread
    row labels regenerated from the tid table, drop count disclosed).
    :func:`export` writes this."""
    with _LOCK:
        events = list(_STATE.events)
        tid_names = dict(_STATE.tid_names)
        dropped = _STATE.dropped
    meta = [{"ph": "M", "name": "thread_name", "pid": _PID,
             "tid": tid, "args": {"name": name}}
            for tid, name in tid_names.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": {"tool": "mdanalysis_mpi_tpu_torch",
                          "dropped_events": dropped}}


def export(path: str | None = None) -> str | None:
    """Write the recorded events as Chrome trace-event JSON (atomic
    replace).  ``path`` defaults to the one :func:`enable` was given;
    returns the written path, or None when there is nowhere to write.

    Serialized under its own lock: scheduler workers and run()-level
    auto-exports call this concurrently, and two threads sharing one
    ``path + ".tmp"`` would interleave writes into the same inode —
    exactly the corrupt-on-crash file the atomic replace exists to
    prevent.  (A separate lock from the event-buffer one, so a slow
    disk never stalls span recording.)"""
    path = path or _STATE.path
    if path is None:
        return None
    doc = document()
    try:
        with _EXPORT_LOCK:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
    except OSError:
        # a full disk (or unwritable path) must not fail the RUN the
        # auto-export piggybacks on — but the drop is counted and
        # disclosed, never silent (docs/RELIABILITY.md §5;
        # intra-package import, obs stays stdlib-only externally)
        from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS

        METRICS.inc("mdtpu_obs_write_errors_total", sink="trace")
        return None
    return path
