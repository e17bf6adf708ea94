"""``python -m mdanalysis_mpi_tpu_torch batch <jobs.json>`` — the serving
layer's CLI surface.

The single-analysis CLI (``utils/config.py``) is one blocking run; this
subcommand is the multi-tenant shape: a JSON job file declares N
requests against one (topology, trajectory), and the scheduler runs
them with request coalescing, admission control, and per-job
reliability — then prints ONE JSON line: per-job outcomes plus the
serving telemetry snapshot.

Job file schema (see docs/SERVICE.md)::

    {
      "topology": "top.gro",
      "trajectory": "traj.xtc",          // optional (topology coords)
      "defaults": {"select": "protein"},  // "backend", "device": the
                                          // port's default is each
                                          // analysis' own (torch on
                                          // cuda)
      "workers": 1,                       // scheduler threads
      "cache_mb": 4096,                   // shared device cache (batch
                                          // backends; 0 disables)
      "jobs": [
        {"analysis": "rmsf", "priority": 5, "tenant": "alice"},
        {"analysis": "rmsd", "select": "name CA", "output": "rmsd.npz"},
        {"analysis": "rdf", "select": "name OW", "coalesce": false}
      ]
    }

Per-job fields: every ``AnalysisConfig`` knob (``analysis``,
``select``, ``start``/``stop``/``step``, ``nbins``, ...) plus the
serving knobs ``qos`` (``interactive``/``batch``/``background`` —
docs/RELIABILITY.md §7), ``priority``, ``deadline_s``, ``resilient``
(bool), ``coalesce``, ``tenant``, and ``output`` (per-job ``.npz``).
All jobs share ONE Universe, so same-window requests coalesce into
one staged pass.

A top-level ``"qos"`` block configures the scheduler's
:class:`~mdanalysis_mpi_tpu_torch.service.qos.QosPolicy` (weighted-fair
class weights, per-class SLO targets, bounded submit, per-tenant rate
limits/quotas, the overload shed ladder, runaway-job caps)::

    {"qos": {"weights": {"interactive": 8, "batch": 3},
             "slo_targets_s": {"interactive": 2.0},
             "max_queue_depth": 512,
             "shed_queue_depth": 256,
             "shed_classes": ["background"],
             "max_runtime_s": 3600}, ...}

The output JSON's ``serving.qos`` sub-document breaks completion /
expiry counts, queue-wait and latency percentiles, and SLO attainment
out per class.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import threading
import time

import numpy as np

_JOB_FIELDS = ("qos", "priority", "deadline_s", "coalesce", "tenant",
               "trace_id")


def _job_fingerprint(index: int, spec: dict) -> str:
    """Journal identity of one job-file entry: position + a digest of
    the spec itself.  Reproducible across process restarts by
    construction (the file is the same file), which is what lets
    ``--journal`` recovery match a resubmitted job to its pre-crash
    records and skip the ones already done."""
    digest = hashlib.sha1(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:12]
    return f"{index}:{digest}"


def _result_arrays(analysis) -> dict:
    results = analysis.results.materialize()
    return {k: np.asarray(v) for k, v in results.items()
            if isinstance(v, (np.ndarray, float, int))}


def _output_writer(output: str):
    """Done-callback persisting a finished job's arrays to its .npz —
    EAGERLY, on the worker thread that resolved the handle, before the
    scheduler's journal marks the job finished.  A ``kill -9`` between
    a job's completion and the end of the batch therefore cannot lose
    its output: either the npz is on disk, or the journal still says
    pending and the restarted process re-runs the job.

    Integrity (docs/RELIABILITY.md §5): the file is digest-stamped and
    written tmp→fsync→rename, so a restart can VERIFY it before
    trusting it.  A write failure (ENOSPC, EIO) fails THE JOB — the
    typed :class:`~mdanalysis_mpi_tpu_torch.utils.integrity.
    ArtifactWriteError` lands on ``handle.output_error`` and the job's
    JSON record reports ``failed`` — never the worker thread (the
    done-callback contract swallows everything else)."""
    from mdanalysis_mpi_tpu_torch.utils import integrity

    def write(handle):
        if handle.error is None:
            try:
                integrity.write_npz_atomic(
                    output, _result_arrays(handle.job.analysis))
            except integrity.ArtifactWriteError as exc:
                handle.output_error = exc
    return write


def _build_job(spec: dict, defaults: dict, universe):
    from mdanalysis_mpi_tpu_torch.service.jobs import AnalysisJob
    from mdanalysis_mpi_tpu_torch.utils.config import (
        AnalysisConfig, build_analysis,
    )

    merged = {**defaults, **spec}
    serving = {k: merged.pop(k) for k in _JOB_FIELDS if k in merged}
    resilient = merged.pop("resilient", False)
    output = merged.pop("output", None)
    cfg_fields = {f.name for f in dataclasses.fields(AnalysisConfig)}
    unknown = set(merged) - cfg_fields
    if unknown:
        raise ValueError(
            f"unknown job fields {sorted(unknown)}; known: "
            f"{sorted(cfg_fields | set(_JOB_FIELDS) | {'resilient', 'output'})}")
    cfg = AnalysisConfig(**merged)
    cfg.topology = cfg.topology or "-"   # validated via shared universe
    analysis = build_analysis(cfg, universe=universe)
    # no backend named: the analysis' own default, as the single-run
    # CLI decides (torch on cuda, serial for the serial-only analyses)
    backend = cfg.backend or analysis._default_backend
    executor_kwargs = {}
    if backend in ("torch", "mesh") and cfg.transfer_dtype != "float32":
        executor_kwargs["transfer_dtype"] = cfg.transfer_dtype
    if backend == "torch" and cfg.device is not None:
        executor_kwargs["device"] = cfg.device
    if backend == "mesh" and cfg.device is not None:
        executor_kwargs["devices"] = [cfg.device]
    job = AnalysisJob(
        analysis,
        start=cfg.start, stop=cfg.stop, step=cfg.step,
        backend=backend, batch_size=cfg.batch_size,
        executor_kwargs=executor_kwargs, resilient=resilient,
        **serving)
    return job, cfg, output


def batch_main(argv=None, universe=None) -> int:
    """Entry point for the ``batch`` subcommand.  ``universe`` injects
    a prebuilt Universe (tests; the job file then omits topology)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="mdanalysis_mpi_tpu_torch batch",
        description="run a multi-tenant job file through the serving "
                    "scheduler (request coalescing + shared-cache "
                    "admission; docs/SERVICE.md)")
    p.add_argument("jobs_file", help="JSON job file (see module docs)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome trace-event JSON of every "
                        "served pass's spans to FILE (open in Perfetto; "
                        "merged passes carry all member job ids — env "
                        "twin MDTPU_TRACE_OUT, docs/OBSERVABILITY.md)")
    p.add_argument("--warmup", action="store_true",
                   help="before the first claim, build and load the "
                        "kernel library and run each dispatch shape "
                        "the job file needs once; the warmup wall "
                        "lands in the output JSON as warmup_seconds")
    p.add_argument("--prefetch", action="store_true",
                   help="stage queued jobs' blocks into the shared "
                        "cache before their claim (scheduler-driven "
                        "prefetch, docs/COLDSTART.md)")
    p.add_argument("--store", default=None, metavar="DIR",
                   help="prefer an ingested block store (docs/"
                        "STORE.md) over the job file's trajectory "
                        "when DIR holds one: every tenant then "
                        "random-access-reads its chunks instead of "
                        "re-decoding the file; falls back to the job "
                        "file's trajectory (with a stderr note) when "
                        "DIR is not a store")
    p.add_argument("--status-port", type=int, default=None,
                   metavar="PORT",
                   help="serve the live status endpoint (/status, "
                        "/healthz, /metrics — docs/OBSERVABILITY.md) "
                        "on PORT for the life of the batch (0 binds "
                        "an ephemeral port; the bound address lands "
                        "in the output JSON as status_addr)")
    p.add_argument("--journal", default=None, metavar="FILE",
                   help="crash-consistent job journal (append-only "
                        "JSONL, docs/RELIABILITY.md): every lifecycle "
                        "transition is logged with fsync batching, and "
                        "re-running the SAME command after a crash "
                        "replays the journal — jobs already done or "
                        "quarantined are skipped, unfinished ones "
                        "re-run")
    ns = p.parse_args(argv)

    import os

    from mdanalysis_mpi_tpu_torch import obs

    trace_out = ns.trace_out or os.environ.get("MDTPU_TRACE_OUT")
    if trace_out:
        obs.enable_tracing(trace_out)
    with open(ns.jobs_file) as f:
        spec = json.load(f)

    from mdanalysis_mpi_tpu_torch.service.journal import SETTLED_STATES
    from mdanalysis_mpi_tpu_torch.service.scheduler import Scheduler

    defaults = dict(spec.get("defaults", {}))
    defaults.setdefault("topology", spec.get("topology", ""))
    defaults.setdefault("trajectory", spec.get("trajectory"))
    if ns.store:
        from mdanalysis_mpi_tpu_torch.io.store import is_store

        if is_store(ns.store):
            defaults["trajectory"] = ns.store
        else:
            print(f"[batch] --store {ns.store!r} holds no ingested "
                  f"store; using the job file's trajectory",
                  file=sys.stderr)
    if universe is None:
        from mdanalysis_mpi_tpu_torch import Universe

        u = Universe(defaults["topology"], defaults["trajectory"])
    else:
        u = universe

    # --journal recovery: replay the journal BEFORE building jobs, so
    # a restarted process resubmits exactly the jobs the journal shows
    # unfinished and skips the ones already done (their outputs were
    # written eagerly, see _output_writer) or quarantined
    import os as _os

    recovered = None
    if ns.journal and _os.path.exists(ns.journal):
        recovered = Scheduler.recover(ns.journal)

    from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity

    jobs = []
    build_failures = []
    recovered_records = []
    outputs_corrupt_rerun = 0
    for i, js in enumerate(spec.get("jobs", [])):
        fp = _job_fingerprint(i, js)
        if recovered is not None:
            state = recovered["jobs"].get(fp, {}).get("state")
            if state in SETTLED_STATES:
                # trust-but-verify (docs/RELIABILITY.md §5): a "done"
                # journal record is only as good as the artifact it
                # points at — a digest mismatch, a torn file, or a
                # deleted output means the job must RE-RUN, not be
                # skipped on the journal's word
                out_path = js.get("output")
                if state == "done" and out_path:
                    try:
                        _integrity.verify_npz(out_path)
                    except (_integrity.IntegrityError, OSError) as exc:
                        outputs_corrupt_rerun += 1
                        print(f"[batch] recovered job {fp} is 'done' "
                              f"but its output failed verification "
                              f"({type(exc).__name__}); re-running",
                              file=sys.stderr)
                        # fall through to the normal build path below
                    else:
                        recovered_records.append({
                            "analysis": js.get(
                                "analysis",
                                defaults.get("analysis", "?")),
                            "tenant": js.get("tenant", "default"),
                            "state": state, "recovered": True,
                            "fingerprint": fp,
                            "output": out_path,
                            "output_verified": True})
                        continue
                else:
                    recovered_records.append({
                        "analysis": js.get(
                            "analysis", defaults.get("analysis", "?")),
                        "tenant": js.get("tenant", "default"),
                        "state": state, "recovered": True,
                        "fingerprint": fp,
                        "output": out_path})
                    continue
        try:
            job, cfg, output = _build_job(js, defaults, u)
            job.fingerprint = fp
            jobs.append((job, cfg, output))
        except Exception as exc:
            # a malformed request fails ITS job, not the whole file —
            # the other tenants' submissions still run
            build_failures.append((js, exc))
    if not jobs and not build_failures and not recovered_records:
        raise SystemExit("job file has no jobs")

    cache = None
    cache_mb = spec.get("cache_mb", 4096)
    if cache_mb and any(j.backend in ("torch", "mesh") for j, _, _ in jobs):
        from mdanalysis_mpi_tpu_torch.parallel.executors import DeviceBlockCache

        cache = DeviceBlockCache(max_bytes=int(cache_mb) << 20)

    t0 = time.perf_counter()
    # queue the whole file BEFORE starting workers: same-window
    # requests then coalesce maximally instead of being claimed one by
    # one as they arrive
    from mdanalysis_mpi_tpu_torch.service.qos import QosPolicy

    sched = Scheduler(n_workers=int(spec.get("workers", 1)),
                      cache=cache, autostart=False,
                      prefetch=bool(ns.prefetch),
                      lease_ttl_s=float(spec.get("lease_ttl_s", 30.0)),
                      poison_threshold=int(
                          spec.get("poison_threshold", 2)),
                      supervise=bool(spec.get("supervise", True)),
                      qos=(QosPolicy.from_spec(spec["qos"])
                           if spec.get("qos") else None),
                      journal=ns.journal)
    status_addr = None
    if ns.status_port is not None:
        host, port = sched.serve_status(port=ns.status_port)
        status_addr = f"{host}:{port}"
    warmup_stats = None
    if ns.warmup:
        warmup_stats = sched.warmup([j for j, _, _ in jobs])
    from mdanalysis_mpi_tpu_torch.service.jobs import AdmissionRejectedError

    handles = []
    submitted = []
    rejected = []
    for job, cfg, output in jobs:
        try:
            h = sched.submit(job)
        except AdmissionRejectedError as exc:
            # typed backpressure (docs/RELIABILITY.md §7): the policy
            # refused THIS submission (queue bound / tenant rate /
            # quota) — its record says so, the other tenants still run
            rejected.append((job, cfg, exc))
            continue
        if output:
            # persist per job, at completion time, BEFORE the journal's
            # finish record: a crash mid-batch then never strands a
            # finished-but-unwritten job (see _output_writer)
            h.add_done_callback(_output_writer(output))
        handles.append(h)
        submitted.append((job, cfg, output))
    if ns.prefetch:
        # synchronous first pass before workers start: wave-1 claims
        # then ride staged blocks; the background thread covers jobs
        # submitted later
        sched.prefetch_pending()

    # SIGINT/SIGTERM: drain in-flight units, abort everything still
    # queued (typed SchedulerShutdownError → "aborted" records), and
    # STILL emit the JSON summary — an operator's ^C must not leave a
    # half-written report.  The handler only sets a flag: the abort
    # itself runs on the main loop below, outside signal context.
    import signal

    stop = threading.Event()
    restore = {}
    try:
        for signum in (signal.SIGINT, signal.SIGTERM):
            restore[signum] = signal.signal(
                signum, lambda *_: stop.set())
    except ValueError:
        pass         # not the main thread (in-process tests)

    sched.start()
    interrupted = False
    try:
        while not sched.drain(timeout=0.2):
            if stop.is_set() and not interrupted:
                interrupted = True
                sched.abort_queued(
                    "SIGINT/SIGTERM received: in-flight units drain, "
                    "queued jobs abort")
        sched.shutdown()
    finally:
        for signum, handler in restore.items():
            signal.signal(signum, handler)
    wall = time.perf_counter() - t0

    records = list(recovered_records)
    rc = 0
    for js, exc in build_failures:
        records.append({
            "analysis": js.get("analysis",
                               defaults.get("analysis", "?")),
            "tenant": js.get("tenant", "default"), "state": "failed",
            "error": f"{type(exc).__name__}: {exc}"})
        rc = 1
    for job, cfg, exc in rejected:
        records.append({
            "analysis": cfg.analysis, "tenant": job.tenant,
            "qos": job.qos, "state": "rejected",
            "reject_reason": exc.reason,
            "error": f"{type(exc).__name__}: {exc}"})
        rc = 1
    for handle, (job, cfg, output) in zip(handles, submitted):
        rec = {"job_id": handle.job_id, "analysis": cfg.analysis,
               "tenant": job.tenant, "qos": job.qos,
               "state": handle.state,
               "coalesced": handle.coalesced,
               "queue_wait_s": (round(handle.queue_wait_s, 4)
                                if handle.queue_wait_s is not None
                                else None),
               "latency_s": (round(handle.latency_s, 4)
                             if handle.latency_s is not None else None)}
        output_error = getattr(handle, "output_error", None)
        if handle.error is None and output_error is not None:
            # the analysis ran, but its artifact never landed (disk
            # full / I/O error): the JOB is failed — its caller would
            # otherwise trust an output that does not exist — while
            # the worker and every other tenant carried on
            rec["state"] = "failed"
            rec["error"] = (f"{type(output_error).__name__}: "
                            f"{output_error}")
            rc = 1
        elif handle.error is not None:
            rec["error"] = f"{type(handle.error).__name__}: {handle.error}"
            rc = 1
            diag = getattr(handle.error, "diagnostics", None)
            if diag:
                # the quarantine surface (docs/RELIABILITY.md): what
                # the supervisor captured at each incident, minus the
                # span dumps (the trace file has those) — enough for
                # an operator to see WHY without grepping logs
                rec["quarantine"] = {
                    "reason": diag.get("reason"),
                    "fault_count": diag.get("fault_count"),
                    "last_worker": diag.get("last_worker"),
                    "incidents": [
                        {k: v for k, v in inc.items()
                         if k != "last_spans"}
                        for inc in diag.get("incidents", [])],
                }
        else:
            results = job.analysis.results.materialize()
            rec["results"] = {k: list(np.shape(v))
                              for k, v in results.items()
                              if isinstance(v, (np.ndarray, float, int))}
            if output:
                # written eagerly by the done-callback (see
                # _output_writer) — only the record points at it here
                rec["output"] = output
        records.append(rec)

    if trace_out:
        obs.export_trace(trace_out)
    out = {
        "jobs": records, "wall_s": round(wall, 4),
        "serving": sched.telemetry.snapshot(cache=cache),
        "trace_out": trace_out,
        "status_addr": status_addr,
        "interrupted": interrupted,
        "quarantined": [h.job.fingerprint for h in sched.quarantined],
    }
    if sched.breakers is not None:
        out["breakers"] = {
            (backend if mesh is None else f"{backend}@{mesh}"): st
            for (backend, mesh), st in sched.breakers.states().items()}
    if ns.journal:
        out["journal"] = ns.journal
        out["recovered_skipped"] = len(recovered_records)
        # "done" jobs whose npz failed digest verification at restart:
        # re-run instead of skipped (docs/RELIABILITY.md §5)
        out["outputs_corrupt_rerun"] = outputs_corrupt_rerun
    if warmup_stats is not None:
        out["warmup_seconds"] = warmup_stats["seconds"]
        out["warmup_executables"] = warmup_stats["executables"]
    print(json.dumps(out))
    return rc
