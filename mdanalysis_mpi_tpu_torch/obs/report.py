"""RunReport: one run's observability summary under
``results.observability`` (the port's copy of the JAX package's
``obs/report.py``).

``AnalysisBase.run`` (and the multi-pass ``AlignedRMSF.run``) and
``run_streaming`` capture phase totals for the run and attach them
together with wall time, the dispatch count, the active ``scan_k``,
and where the trace (if any) is being written.  A plain JSON-friendly dict:
``.npz``/CLI serialization filters it out automatically (dicts are not
arrays) and notebooks read it directly.

Attribution: when the run executes under a scheduler trace context
(job/trace ids on the submitting thread — live even with tracing off),
the report's phases come from the run's OWN phase window
(``utils/timers.open_window``): every phase completion whose thread
context carries the job's trace ids — including staging on the
prefetch/pool threads, which re-apply the captured context — lands in
the window, and nothing another concurrent job records can bleed in.
``phase_attribution: "job"`` marks these reports.  A solo run with no
trace context falls back to the process-global ``TIMERS`` delta
(``phase_attribution: "process"``) — exact there by construction,
since nothing else is recording.  (This replaces the PR-5
time-window-slice caveat; the 2-worker regression test in
``tests/test_obs.py`` pins the isolation.)

Staging: a process-attributed report also carries ``staging``, the
run's deltas of the staging counters (``obs/metrics.py``
``STAGING_COUNTERS``): ``{"blocks": {path: n}, "bytes": n}``, present
only when the run staged, with ``"xtc_decoded_bytes": n`` and
``"xtc_redecodes": n`` beside them where the run decoded an XTC.  The
counters are process-wide, so a job-attributed report leaves it out
rather than book another job's blocks.

Near-free by construction: capture is a few small dict copies per
run() call (plus one list append when a window opens), nothing per
frame or per block.
"""

from __future__ import annotations

import time


def start_capture() -> dict:
    """Snapshot the run-scoped baselines (call at run() entry)."""
    from mdanalysis_mpi_tpu_torch.obs import spans as _spans
    from mdanalysis_mpi_tpu_torch.parallel import executors as _executors
    from mdanalysis_mpi_tpu_torch.utils import timers as _timers
    from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

    acc, calls = TIMERS.snapshot()
    cap = {"t0": time.perf_counter(), "acc": acc, "calls": calls,
           "batch_runs": _executors.BATCH_RUNS,
           "staging": _staging_counts()}
    ids = _spans.current_trace_ids()
    if ids:
        # a scheduler (or any caller) stamped trace ids on this
        # thread: attribute phases to THIS job via its own window
        cap["window"] = _timers.open_window(ids)
    return cap


def abandon_capture(cap: dict) -> None:
    """Release a :func:`start_capture` whose run raised before
    :func:`finish_capture` could consume it — without this, every
    failed job under a trace context would leak its phase window into
    the process-global registry (run sites call this from their
    except path)."""
    from mdanalysis_mpi_tpu_torch.utils import timers as _timers

    window = cap.pop("window", None)
    if window is not None:
        _timers.close_window(window)


def finish_capture(cap: dict, analysis: str, backend: str,
                   n_frames: int) -> dict:
    """Build the RunReport dict from a :func:`start_capture` baseline."""
    from mdanalysis_mpi_tpu_torch.obs import spans as _spans
    from mdanalysis_mpi_tpu_torch.parallel import executors as _executors
    from mdanalysis_mpi_tpu_torch.utils import timers as _timers
    from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

    wall = time.perf_counter() - cap["t0"]
    window = cap.pop("window", None)
    if window is not None:
        _timers.close_window(window)
        acc1, calls1 = window.snapshot()
        acc0, calls0 = {}, {}
        attribution = "job"
    else:
        acc1, calls1 = TIMERS.snapshot()
        acc0, calls0 = cap["acc"], cap["calls"]
        attribution = "process"
    phases = {}
    for name in acc1:
        ds = acc1[name] - acc0.get(name, 0.0)
        dc = calls1.get(name, 0) - calls0.get(name, 0)
        if dc or ds > 0:
            phases[name] = {"seconds": round(ds, 6), "calls": dc}
    dispatches = calls1.get("dispatch", 0) - calls0.get("dispatch", 0)
    report = {
        "analysis": analysis,
        "backend": backend,
        "n_frames": n_frames,
        "wall_s": round(wall, 6),
        "fps": round(n_frames / wall, 2) if wall > 0 else None,
        # per-phase seconds/calls for THIS run; staging overlaps device
        # compute (prefetch thread), so the per-phase sum may exceed
        # wall_s — that overlap is what the span trace makes visible
        # (docs/OBSERVABILITY.md)
        "phases": phases,
        "phase_attribution": attribution,
        "dispatch_count": dispatches,
        # the resolved scan group size of the run's last batch pass
        # (1 = per-block dispatch, or no batch pass in this run), beside
        # the dispatch count it shrinks
        "scan_k": (_executors.LAST_SCAN_K
                   if _executors.BATCH_RUNS > cap["batch_runs"] else 1),
        "tracing": _spans.enabled(),
        "trace_out": _spans.trace_path(),
    }
    if attribution == "process":
        staging = _staging_delta(cap["staging"], _staging_counts())
        if staging is not None:
            report["staging"] = staging
    from mdanalysis_mpi_tpu_torch.obs import prof as _prof

    if _prof.enabled():
        # the continuous profiler's process-level summary rides the
        # run report when sampling is on; absent otherwise — the report
        # stays byte-identical for profiler-off runs
        report["profiler"] = _prof.run_summary()
    return report


#: the unlabelled XTC staging counters and their keys in the summary
_XTC_COUNTS = (("mdtpu_xtc_decoded_bytes_total", "xtc_decoded_bytes"),
               ("mdtpu_xtc_redecodes_total", "xtc_redecodes"))


def _staging_counts() -> tuple:
    """The staging counters now: (blocks by label key, bytes by label
    key, then each of :data:`_XTC_COUNTS` by label key)."""
    from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS

    return ((METRICS.counter("mdtpu_stage_blocks_total"),
             METRICS.counter("mdtpu_staged_bytes_total"))
            + tuple(METRICS.counter(name) for name, _ in _XTC_COUNTS))


def _staging_delta(before: tuple, after: tuple) -> dict | None:
    """``{"blocks": {path: n}, "bytes": n}`` between two
    :func:`_staging_counts`, with each of :data:`_XTC_COUNTS` that
    moved, or None when nothing was staged."""
    blocks = {}
    for key, n in after[0].items():
        d = n - before[0].get(key, 0)
        if d:
            # the label key is ``path="<path>"``
            blocks[key.partition('"')[2].rstrip('"')] = d
    nbytes = sum(after[1].values()) - sum(before[1].values())
    if not blocks and not nbytes:
        return None
    out = {"blocks": blocks, "bytes": nbytes}
    for (_, key), b, a in zip(_XTC_COUNTS, before[2:], after[2:]):
        d = sum(a.values()) - sum(b.values())
        if d:
            out[key] = d
    return out
