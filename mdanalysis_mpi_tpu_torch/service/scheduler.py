"""The job scheduler: priority queue + coalescing + cache admission.

One :class:`Scheduler` turns the library's blocking ``run()`` calls
into a served workload: tenants ``submit()`` :class:`~mdanalysis_mpi_tpu_torch
.service.jobs.AnalysisJob`\\ s and get :class:`~mdanalysis_mpi_tpu_torch.
service.jobs.JobHandle` futures back; worker threads claim the
highest-priority job PLUS every queued peer sharing its coalesce key,
plan the batch into merged/solo passes
(:mod:`~mdanalysis_mpi_tpu_torch.service.coalesce`), and run them.

Admission control (the shared-cache policy): when the scheduler owns a
:class:`~mdanalysis_mpi_tpu_torch.parallel.executors.DeviceBlockCache`, a
batch-backend job must RESERVE its estimated staged working set before
it may stage into the cache.  A job whose estimate

- fits the available budget → admitted (reservation held for the run);
- exceeds the whole cache → runs UNCACHED (it could never fit;
  letting it insert would evict nothing — the cache never evicts — but
  would burn the budget hot tenants are using);
- fits the cache but not the current budget → the scheduler first
  reclaims entries of tenants with no pending jobs
  (``evict_unpinned()`` — pinned/hot tenants' superblocks are never
  touched), then either admits, DEFERS the job behind other runnable
  work, or — when nothing else is queued or the deferral budget is
  spent — runs it uncached.  Queuing instead of evicting is the
  whole point: a cold tenant must not thrash a hot tenant's
  device-resident superblocks.

Reliability integration: ``job.resilient`` forwards to
``run(resilient=...)`` — each job run builds its OWN degradation chain
(:class:`~mdanalysis_mpi_tpu_torch.reliability.policy.FallbackChain`), so a
device-loss-shaped failure demotes the executor for THAT job only; the
process, the scheduler, and other tenants keep their backends.  A
merged pass that fails re-runs its members solo (one bad tenant must
not take down the batch it coalesced into).

Supervision (docs/RELIABILITY.md, "Serving supervision"): every claim
grants a **lease** (:mod:`~mdanalysis_mpi_tpu_torch.service.supervision`)
that the worker renews implicitly on every timed-phase entry; a
supervisor thread reaps expired leases and leases held by dead
threads, requeues the stranded handles onto fresh workers (solo — a
batch that sank a worker must not re-merge), **quarantines** a job
after ``poison_threshold`` incidents with its captured diagnostics,
respawns dead worker threads, and fences wedged ones so a zombie's
late completion can neither corrupt the re-run's accumulators nor
double-resolve the handle.  Per-(backend, mesh) **circuit breakers**
(:mod:`~mdanalysis_mpi_tpu_torch.reliability.breaker`) remember dispatch
faults across jobs: while a backend's breaker is open, new units route
down the same Mesh→Torch→Serial order the FallbackChain uses, and a
half-open breaker is probed with a warmup-shaped no-op before traffic
is restored.

**On a CUDA device no route ends on serial** (the FallbackChain's own
rule on the card: Mesh → Torch, then stop).  A job bound for the card
whose device breakers are all open fails with
:class:`~mdanalysis_mpi_tpu_torch.service.jobs.BackendUnavailableError`
(typed, non-degradable, naming the open breaker), and the memory guard
holds a unit that would cross ``mem_guard_bytes`` until the in-flight
charge drains (a unit larger than the guard then runs alone), where on
the CPU both shed to the serial backend as the JAX package does.  With ``journal=``, every lifecycle transition lands in a
crash-consistent JSONL journal
(:mod:`~mdanalysis_mpi_tpu_torch.service.journal`) that :meth:`Scheduler.
recover` replays after a process crash.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import traceback as _traceback

from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.obs import alerts as _alerts
from mdanalysis_mpi_tpu_torch.obs import flight as _flight
from mdanalysis_mpi_tpu_torch.obs import prof as _prof
from mdanalysis_mpi_tpu_torch.reliability import breaker as _breaker
from mdanalysis_mpi_tpu_torch.reliability import faults as _faults
from mdanalysis_mpi_tpu_torch.service import coalesce as _coalesce
from mdanalysis_mpi_tpu_torch.service.canary import CANARY_TENANT
from mdanalysis_mpi_tpu_torch.service import journal as _journal
from mdanalysis_mpi_tpu_torch.service import qos as _qos
from mdanalysis_mpi_tpu_torch.service import supervision as _supervision
from mdanalysis_mpi_tpu_torch.service.jobs import (
    BackendUnavailableError,
    AdmissionRejectedError, AnalysisJob, JobDeadlineExpired,
    JobHandle, JobQuarantinedError, JobRuntimeExceeded, JobShedError,
    JobState, SchedulerShutdownError,
)
from mdanalysis_mpi_tpu_torch.service.telemetry import ServiceTelemetry
from mdanalysis_mpi_tpu_torch.utils import timers as _timers
from mdanalysis_mpi_tpu_torch.utils.log import get_logger
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

#: The degradation order breaker routing walks — the same one
#: reliability.policy.degradation_chain builds (serial is the floor:
#: it has no device to lose, so it never carries a breaker; a job on
#: a CUDA device never reaches it).
ROUTE_ORDER = ("mesh", "torch", "serial")

#: The batch backends: cache admission, warmup, prefetch and the
#: memory guard apply to these.
DEVICE_BACKENDS = ("torch", "mesh")


def job_on_card(job) -> bool:
    """Does ``job`` run on a CUDA device?  Its ``device`` (torch) or
    ``devices`` (mesh) executor keyword, where None is the default
    device (``device.DEFAULT_DEVICE``, ``cuda``); a serial job never
    does."""
    import torch

    from mdanalysis_mpi_tpu_torch import device as _device

    kw = job.executor_kwargs
    if job.backend == "torch":
        devs = [kw.get("device")]
    elif job.backend == "mesh":
        devs = kw.get("devices")
        devs = ([devs] if devs is None or isinstance(devs, (str,
                                                             torch.device))
                else list(devs))
    else:
        return False
    return any(torch.device(_device.DEFAULT_DEVICE if d is None else d)
               .type == "cuda" for d in devs)

def reader_fingerprint(reader):
    """Re-exported from the executor layer: the cache-key namespace
    every staged-block key leads with — the scheduler pins hot
    tenants' entries by this value."""
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        reader_fingerprint as fp,
    )

    return fp(reader)


class Scheduler:
    """Multi-tenant job scheduler over the executor layer.

    ``n_workers``
        Worker threads claiming jobs (default 1: one staged pass at a
        time — staging and dispatch share the host core, and
        coalescing, not thread fan-out, is where the multi-tenant win
        lives).  More workers overlap host-bound jobs; the shared
        caches are lock-safe for it (the thread-safety audit in
        ``io/base.py``/``DeviceBlockCache``).
    ``cache``
        Optional shared :class:`~mdanalysis_mpi_tpu_torch.parallel.executors.
        DeviceBlockCache` handed to admitted batch-backend jobs (see
        the module docstring for the admission rules).  Jobs that pass
        their own ``block_cache`` in ``executor_kwargs`` bypass
        admission entirely.
    ``autostart``
        Start workers on construction.  ``False`` lets a caller queue
        a burst first (tests pin priority order this way), then
        :meth:`start`.
    ``lease_ttl_s`` / ``poison_threshold`` / ``supervise``
        Serving supervision (docs/RELIABILITY.md): claims hold leases
        renewed by phase-entry heartbeats; the supervisor reaps
        expired/dead holders, requeues their batches, and quarantines
        a job after ``poison_threshold`` incidents.  ``supervise=False``
        disables leases and the supervisor thread entirely.
    ``breakers``
        A shared :class:`~mdanalysis_mpi_tpu_torch.reliability.breaker.
        BreakerBoard`, ``None`` for a private default board, or
        ``False`` to disable breaker routing.
    ``journal``
        Path (or open :class:`~mdanalysis_mpi_tpu_torch.service.journal.
        JobJournal`) for the crash-consistent lifecycle journal;
        :meth:`recover` replays it after a crash.
    ``scrub`` / ``scrub_interval_s``
        Opt-in SDC scrubbing (docs/RELIABILITY.md §5): a background
        thread re-fetches the shared cache's idle superblocks every
        ``scrub_interval_s`` (only while no worker is mid-run — the
        fetch competes for the host core and, on tunneled targets, the
        link) and compares them against the host-side fingerprints
        recorded at stage time; a mismatch quarantines the entry so
        the next pass re-stages clean bytes.  :meth:`scrub_now` is the
        synchronous form.
    ``mem_guard_bytes``
        Admission-level memory watchdog: an upper bound on the total
        ESTIMATED staged bytes in flight across workers (cached or
        not).  A batch-backend unit whose estimate would cross the
        guard is shed to the serial backend (frame-at-a-time, no block
        residency) instead of letting the allocator OOM the process —
        counted as ``admission_shed_serial``.  On a CUDA device the
        unit waits instead until the in-flight charge drains, and a
        unit larger than the guard runs alone.  ``None`` (default)
        disables the guard.
    ``flight_dir``
        Where the flight recorder (``obs/flight.py``,
        docs/OBSERVABILITY.md) dumps its black box on quarantine and
        worker fencing.  Default: ``MDTPU_FLIGHT_DIR``, else beside a
        path-backed ``journal``, else off.
    ``qos``
        A :class:`~mdanalysis_mpi_tpu_torch.service.qos.QosPolicy`
        (docs/RELIABILITY.md §7): weighted-fair claim ordering across
        tenant QoS classes, bounded submit + per-tenant rate limits
        and quotas (typed :class:`~mdanalysis_mpi_tpu_torch.service.jobs.
        AdmissionRejectedError`), the overload shed ladder (typed
        :class:`~mdanalysis_mpi_tpu_torch.service.jobs.JobShedError`, state
        ``shed``), and the runaway-job lease caps.  None → a default
        policy whose admission/shed/cap knobs are all OFF, so
        pre-QoS callers see byte-identical behavior.
    ``alerts`` / ``alert_interval_s``
        The alert rules engine (obs/alerts.py, docs/OBSERVABILITY.md
        "Alerting & profiling"): evaluated over
        ``unified_snapshot(timers=, cache=, telemetry=)`` on the
        supervisor tick, at most every ``alert_interval_s`` seconds
        on the scheduler's (injectable) clock.  ``None`` builds the
        seed-rule engine sharing this scheduler's clock, flight dir
        and journal; ``False`` disables alerting; an
        :class:`~mdanalysis_mpi_tpu_torch.obs.alerts.AlertEngine` (or a
        rule list) is used as-is.  Firing/resolving alerts land in
        the ``/status`` ``alerts`` block.
    """

    def __init__(self, n_workers: int = 1, cache=None,
                 telemetry: ServiceTelemetry | None = None,
                 max_deferrals: int = 3, autostart: bool = True,
                 prefetch: bool = False, lease_ttl_s: float = 30.0,
                 poison_threshold: int = 2, supervise: bool = True,
                 supervision_interval_s: float = 0.05,
                 breakers=None, journal=None, clock=time.monotonic,
                 scrub: bool = False, scrub_interval_s: float = 5.0,
                 mem_guard_bytes: int | None = None,
                 flight_dir: str | None = None,
                 qos: "_qos.QosPolicy | None" = None,
                 alerts=None, alert_interval_s: float = 1.0,
                 canary=None, canary_interval_s: float | None = None):
        self.cache = cache
        # ---- QoS + overload policy (docs/RELIABILITY.md §7) ----
        self.qos = qos or _qos.QosPolicy()
        self._stride = _qos.StrideScheduler(self.qos.weights)
        self._buckets = (_qos.TenantBuckets(self.qos.tenant_rate_per_s,
                                            self.qos.rate_burst(),
                                            clock=clock)
                         if self.qos.tenant_rate_per_s else None)
        self._tenant_inflight: dict[str, int] = {}
        self.telemetry = telemetry or ServiceTelemetry(
            slo_targets_s=self.qos.slo_targets_s)
        if telemetry is not None and qos is not None:
            # a shared/injected telemetry still reports attainment
            # against THIS scheduler's configured targets
            self.telemetry.slo_targets_s.update(self.qos.slo_targets_s)
        self.max_deferrals = max_deferrals
        self.n_workers = max(1, int(n_workers))
        # ---- supervision state ----
        self.supervise = bool(supervise)
        self.lease_ttl_s = float(lease_ttl_s)
        self.poison_threshold = max(1, int(poison_threshold))
        self.supervision_interval_s = float(supervision_interval_s)
        self._clock = clock
        self._sup = _supervision.LeaseTable(clock=clock)
        self._sup_thread: threading.Thread | None = None
        # incidents parked until their fenced (wedged-but-alive)
        # worker exits: [(handle, thread, grace_deadline)]
        self._pending_requeues: list = []
        #: quarantined handles, with diagnostics on their errors
        self.quarantined: list[JobHandle] = []
        # ---- breaker routing ----
        if breakers is False:
            self.breakers = None
        else:
            self.breakers = breakers or _breaker.BreakerBoard()
        # ---- crash-consistent journal ----
        self._owns_journal = isinstance(journal, (str, bytes)) or \
            hasattr(journal, "__fspath__")
        self.journal = (_journal.JobJournal(journal)
                        if self._owns_journal else journal)
        # flight recorder (obs/flight.py): black-box dumps on
        # quarantine and worker fencing; off with no resolvable dir
        self._flight_dir = _flight.flight_dir(
            flight_dir, journal if self._owns_journal else None)
        # ---- alert rules engine (obs/alerts.py, docs/OBSERVABILITY.md
        #      "Alerting & profiling"): evaluated over the unified
        #      snapshot on the supervisor tick, every
        #      ``alert_interval_s``.  ``alerts`` is an AlertEngine, a
        #      rule list, None (seed rules), or False (off). ----
        if alerts is False:
            self.alerts = None
        elif isinstance(alerts, _alerts.AlertEngine):
            self.alerts = alerts
        else:
            self.alerts = _alerts.AlertEngine(
                rules=alerts, clock=clock,
                flight_dir=self._flight_dir, journal=self.journal)
        self.alert_interval_s = float(alert_interval_s)
        self._alert_last = float("-inf")
        # ---- synthetic canary (service/canary.py,
        #      docs/OBSERVABILITY.md): the reserved background-class
        #      pseudo-tenant probing the full serving path on the
        #      supervisor tick.  Off by default; pass an instance, or
        #      True / canary_interval_s to build one bound here. ----
        if canary is True or (canary is None and canary_interval_s):
            from mdanalysis_mpi_tpu_torch.service.canary import CanaryProbe
            canary = CanaryProbe(
                self, interval_s=canary_interval_s or 30.0)
        self.canary = canary or None
        #: standalone schedulers charge the per-tenant jobs meter
        #: (obs/usage.py) at their own terminal sites; a fleet host's
        #: local scheduler leaves it to the controller — the journal
        #: writer — so the meter reconciles EXACTLY against the
        #: journal's finish ledger.
        self._usage_charge_jobs = True
        # live status endpoint (service/statusd.py), opt-in via
        # serve_status() / the batch CLI's --status-port
        self._statusd = None
        self._fp_counts: dict = {}      # derived-fingerprint occurrence
        # scheduler-driven prefetch (docs/COLDSTART.md): a background
        # thread stages queued jobs' blocks into the shared cache
        # while every worker is busy, so wave-1 cold misses become
        # hits.  Also available synchronously via prefetch_pending().
        self.prefetch = bool(prefetch) and cache is not None
        self._prefetch_thread: threading.Thread | None = None
        # ---- integrity: SDC scrubbing + memory watchdog
        #      (docs/RELIABILITY.md §5) ----
        self.scrub = (bool(scrub) and cache is not None
                      and hasattr(cache, "scrub"))
        self.scrub_interval_s = float(scrub_interval_s)
        self._scrub_thread: threading.Thread | None = None
        self.mem_guard_bytes = mem_guard_bytes
        self._staged_inflight = 0     # estimated staged bytes mid-run
        self._queue: list = []        # (-priority, seq, handle)
        # admission-deferred entries, parked until OTHER work actually
        # runs (a deferred top-priority job back in the queue would
        # just be re-claimed immediately — a busy-loop that never
        # yields to the runnable work it deferred behind)
        self._parked: list = []
        # shed-parked live tenants (docs/STREAMING.md): the overload
        # controller moves streaming entries HERE instead of killing
        # them — out of the depth the shed predicate reads, re-admitted
        # once overload passes.  Distinct from _parked (admission
        # deferrals) because re-entry is load-gated, not progress-gated
        self._stream_parked: list = []
        self._active = 0              # workers currently running a batch
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._inflight = 0            # queued + running handles
        self._shutdown = False
        self._workers: list[threading.Thread] = []
        self._ns_active: dict = {}    # reader fingerprint → live jobs
        self._log = get_logger("mdtpu.service")
        if autostart:
            self.start()

    # ---- lifecycle ----

    def start(self) -> None:
        with self._cond:
            if self._workers:
                return
            self._shutdown = False
            # watermark sources for the continuous profiler
            # (obs/prof.py): polled only while the sampler runs —
            # registering is one dict write either way.  The fns are
            # kept so teardown unregisters ONLY its own (a second
            # scheduler taking the name over must not lose it when
            # this one shuts down)
            self._wm_sources = {
                "staged_bytes": lambda: self._staged_inflight}
            if self.cache is not None:
                self._wm_sources["cache_bytes"] = \
                    lambda: self.cache._bytes
            for name, fn in self._wm_sources.items():
                _prof.register_watermark(name, fn)
            for i in range(self.n_workers):
                t = threading.Thread(target=self._worker_outer,
                                     daemon=True,
                                     name=f"mdtpu-serve-{i}")
                self._workers.append(t)
                t.start()
            if self.prefetch and self._prefetch_thread is None:
                t = threading.Thread(target=self._prefetch_worker,
                                     daemon=True,
                                     name="mdtpu-prefetch")
                self._prefetch_thread = t
                t.start()
            if self.scrub and self._scrub_thread is None:
                t = threading.Thread(target=self._scrub_worker,
                                     daemon=True,
                                     name="mdtpu-scrub")
                self._scrub_thread = t
                t.start()
            if self.supervise and self._sup_thread is None:
                # heartbeats ride phase entries (utils/timers.py): the
                # hook renews the calling worker's lease, and aborts a
                # fenced zombie at its next phase boundary
                _timers.add_phase_hook(self._sup.heartbeat)
                t = threading.Thread(target=self._supervisor,
                                     daemon=True,
                                     name="mdtpu-supervisor")
                self._sup_thread = t
                t.start()

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted job reached a terminal state."""
        if not self._workers:
            self.start()
        with self._cond:
            return self._cond.wait_for(lambda: self._inflight == 0,
                                       timeout)

    def shutdown(self, wait: bool = True) -> None:
        """Stop the scheduler.  ``wait=True`` lets the workers drain
        whatever is still queued, then joins them.  ``wait=False``
        ABORTS every job no worker has claimed yet — each unclaimed
        handle fails with a typed :class:`~mdanalysis_mpi_tpu_torch.service.
        jobs.SchedulerShutdownError` (state ``aborted``) so a caller
        blocked on ``handle.result()`` gets its answer instead of
        hanging forever on a future no worker will ever resolve."""
        if not wait:
            self.abort_queued(
                "scheduler shut down (wait=False) with this job still "
                "queued; it will never run")
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        if wait:
            # same bounded re-snapshot join as the wait=False path: a
            # fenced never-waking zombie stays alive until the
            # supervisor writes it off and drops it from the pool, and
            # an unbounded join on a stale snapshot would wait on the
            # zombie forever
            self._finalize_shutdown()
        else:
            # in-flight units must still be able to finish
            # (abort_queued's contract): tearing down here would stop
            # lease renewal (the phase hook is the heartbeat channel),
            # so the supervisor would reap and fence HEALTHY in-flight
            # workers and their handles would never resolve — and the
            # closed journal would drop their finish records.  A
            # background finalizer waits the pool out, then performs
            # the same teardown the wait=True path does inline.
            threading.Thread(target=self._finalize_shutdown,
                             daemon=True,
                             name="mdtpu-finalize").start()

    def _finalize_shutdown(self) -> None:
        # re-snapshot until quiet: the supervisor can still replace a
        # written-off wedged worker in the pool after our first look,
        # and a stale snapshot would either miss the replacement or
        # join a zombie the write-off already removed
        while True:
            workers = [t for t in list(self._workers) if t.is_alive()]
            if not workers:
                break
            for t in workers:
                # bounded join, then re-snapshot: a wedged worker
                # stays alive until the supervisor writes it off and
                # drops it from the pool — an unbounded join here
                # would wait on the zombie forever instead
                t.join(timeout=1.0)
        pf = self._prefetch_thread
        if pf is not None:
            pf.join()
        sc = self._scrub_thread
        if sc is not None:
            sc.join()
        st = self._sup_thread
        if st is not None:
            st.join()
        self._teardown()

    def status(self) -> dict:
        """The ``/status`` document (service/statusd.py,
        docs/OBSERVABILITY.md): queue depth, live leases, breaker
        states, quarantine — one JSON fetch instead of a log grep."""
        now = self._clock()
        with self._cond:
            queue_depth = len(self._queue) + len(self._parked)
            by_class: dict = {}
            for _, _, h in self._queue + self._parked:
                by_class[h.job.qos] = by_class.get(h.job.qos, 0) + 1
            overloaded = self._overloaded_locked()
            inflight = self._inflight
            active = self._active
            workers_alive = sum(1 for t in self._workers
                                if t.is_alive())
            shutdown = self._shutdown
            leases = [
                {"worker": lease.worker.name,
                 "jobs": len(lease.handles),
                 "ttl_s": round(lease.ttl, 3),
                 "expires_in_s": round(lease.deadline - now, 3)}
                for lease in self._sup.leases.values()]
            quarantined = [h.job.fingerprint or f"job-{h.job_id}"
                           for h in self.quarantined]
        out = {
            "role": "scheduler",
            "shutdown": shutdown,
            "queue_depth": queue_depth,
            "queue_depth_by_class": by_class,
            "overloaded": overloaded,
            "inflight": inflight,
            "active_workers": active,
            "workers_alive": workers_alive,
            "leases": leases,
            "quarantined": quarantined,
            "telemetry": self.telemetry.snapshot(cache=self.cache),
            # firing/resolved alerts (obs/alerts.py) — what
            # `mdtpu status --alerts` renders
            "alerts": (self.alerts.status()
                       if self.alerts is not None else None),
            # the synthetic canary's black-box view (service/canary.py)
            "canary": (self.canary.status()
                       if self.canary is not None else None),
        }
        # histogram exemplars (docs/OBSERVABILITY.md): the last trace
        # id each latency bucket saw — a p99 bucket links straight to
        # an actual Chrome trace
        snap = obs.METRICS.snapshot()
        exemplars: dict = {}
        for name in ("mdtpu_queue_wait_seconds",
                     "mdtpu_job_latency_seconds", "mdtpu_dispatch_ms",
                     "mdtpu_canary_latency_seconds"):
            series = snap.get(name)
            if not series:
                continue
            ex = {lk: v["exemplars"]
                  for lk, v in series["values"].items()
                  if v.get("exemplars")}
            if ex:
                exemplars[name] = ex
        out["exemplars"] = exemplars
        if self.breakers is not None:
            out["breakers"] = {
                (backend if mesh is None else f"{backend}@{mesh}"): st
                for (backend, mesh), st
                in self.breakers.states().items()}
        return out

    def _healthz(self) -> dict:
        with self._cond:
            ok = (not self._shutdown
                  and any(t.is_alive() for t in self._workers))
        return {"ok": ok, "role": "scheduler"}

    def serve_status(self, port: int = 0,
                     bind_host: str = "127.0.0.1") -> tuple:
        """Start the live status endpoint for this scheduler
        (``/status``, ``/healthz``, ``/metrics`` —
        service/statusd.py); returns the bound ``(host, port)``.
        Idempotent; closed by :meth:`shutdown`."""
        from mdanalysis_mpi_tpu_torch.service.statusd import StatusServer

        if self._statusd is None:
            self._statusd = StatusServer(
                self.status,
                metrics_fn=lambda: obs.to_prometheus(
                    obs.unified_snapshot(timers=TIMERS,
                                         cache=self.cache,
                                         telemetry=self.telemetry)),
                health_fn=self._healthz,
                usage_fn=lambda: obs.usage.usage_doc(
                    obs.unified_snapshot(timers=TIMERS,
                                         cache=self.cache,
                                         telemetry=self.telemetry)),
                bind_host=bind_host, port=port)
        return self._statusd.address

    def _teardown(self) -> None:
        """Idempotent final cleanup, only once no worker can still
        need a heartbeat or a journal record."""
        _timers.remove_phase_hook(self._sup.heartbeat)
        for name, fn in getattr(self, "_wm_sources", {}).items():
            _prof.unregister_watermark(name, fn)
        if self._statusd is not None:
            self._statusd.close()
            self._statusd = None
        if self.canary is not None:
            self.canary.close()
        if self.journal is not None and self._owns_journal:
            self.journal.close()
        # under the condition like every other mutation of the pool
        # bookkeeping (`mdtpu lint` MDT001): the pool is quiescent by
        # the time _teardown runs, but a concurrent start() must see
        # either the old pool or the cleared one, never a half-clear
        with self._cond:
            self._workers.clear()
            self._prefetch_thread = None
            self._scrub_thread = None
            self._sup_thread = None

    def abort_queued(self, reason: str = "scheduler draining") -> list:
        """Fail every queued/parked handle no worker has claimed with
        :class:`~mdanalysis_mpi_tpu_torch.service.jobs.
        SchedulerShutdownError` (state ``aborted``); in-flight units
        are left to finish.  Returns the aborted handles.  The
        ``batch`` CLI's SIGINT/SIGTERM handler calls this so a drained
        process still emits its full JSON summary."""
        with self._cond:
            entries = self._queue + self._parked
            for _, _, h in entries:
                self.telemetry.note_dequeue()
            # shed-parked live tenants are unclaimed queued work too
            # (leaving them would hang their waiters past shutdown) —
            # but their dequeue was already noted at park time
            entries += self._stream_parked
            self._queue.clear()
            self._parked.clear()
            self._stream_parked.clear()
            self._cond.notify_all()
        aborted = []
        for _, _, h in entries:
            if h.done():
                continue
            h._mark_failed(SchedulerShutdownError(
                f"job {h.job_id} ({h.job.tenant}): {reason}"),
                JobState.ABORTED)
            self._finish(h)
            aborted.append(h)
        if aborted:
            self._log.warning("aborted %d unclaimed jobs (%s)",
                              len(aborted), reason)
        return aborted

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.drain()
        self.shutdown()
        return False

    # ---- submission ----

    def submit(self, job, **kwargs) -> JobHandle:
        """Queue an :class:`AnalysisJob` (or an analysis instance, with
        job fields as keyword arguments) and return its handle."""
        if isinstance(job, AnalysisJob):
            if kwargs:
                raise TypeError(
                    "submit() got both a prebuilt AnalysisJob and job "
                    f"keyword arguments {sorted(kwargs)}; set those "
                    "fields on the job itself (they would otherwise "
                    "be silently discarded)")
        else:
            job = AnalysisJob(job, **kwargs)
        handle = JobHandle(job)
        if job.trace_id is None:
            # derived span-trace correlation id (docs/OBSERVABILITY.md):
            # stable per submission, carried by every span the job's
            # pass records — including a merged pass's, which carries
            # ALL member trace ids
            job.trace_id = f"job-{handle.job_id}"
        # everything under one condition acquisition (its lock is
        # re-entrant), with the shutdown check FIRST: a rejected
        # submission must leave no side effects — in particular no
        # namespace pin on a shared cache that no completion would
        # ever release.  note_submit stays inside too, so the depth
        # gauge can never see the dequeue of a job before its submit.
        with self._cond:
            if self._shutdown:
                raise RuntimeError("scheduler is shut down")
            # policy admission FIRST (docs/RELIABILITY.md §7
            # "Backpressure contract"): a rejected submission leaves
            # NO side effects — no handle state, no journal record,
            # no namespace pin, no depth-gauge wobble — so the caller
            # can back off and retry without cleanup
            self._admission_check_locked(job)
            if job.fingerprint is None:
                job.fingerprint = self._derive_fingerprint(job)
            self._tenant_inflight[job.tenant] = \
                self._tenant_inflight.get(job.tenant, 0) + 1
            handle._mark_queued()
            self._note_ns_submit(job)
            self._queue.append((-job.priority, next(self._seq), handle))
            self._inflight += 1
            self.telemetry.note_submit()
            # notify_all, NOT notify(): the supervisor (and prefetch)
            # threads wait on this same condition, and a single notify
            # can land on one of them instead of an idle worker — the
            # woken supervisor just re-waits, and the submission sits
            # unclaimed forever (observed as an intermittent drain
            # hang once supervise=True made the extra waiter default)
            self._cond.notify_all()
        if self.journal is not None:
            self.journal.record(
                "submit", job.fingerprint, tenant=job.tenant,
                analysis=type(job.analysis).__name__)
        # overload check AFTER the enqueue: a burst that pushed the
        # queue past the shed threshold sheds the lowest sheddable
        # class NOW (possibly this very job), not a supervisor tick
        # later — the journal/disk I/O runs outside the lock
        self._maybe_shed()
        return handle

    def _admission_check_locked(self, job: AnalysisJob) -> None:
        """Typed policy admission at the submission door
        (docs/RELIABILITY.md §7).  Raises
        :class:`AdmissionRejectedError` — counted
        ``mdtpu_admission_rejects_total{reason=}`` — and consumes a
        rate token only for submissions that pass every other check
        (a queue-full reject must not also burn the tenant's
        budget)."""
        p = self.qos
        reason = None
        # the synthetic canary (service/canary.py) is exempt from the
        # PER-TENANT checks — quota, budget, rate — by design: probe
        # cadence must not depend on tenant policy, and a probe must
        # never burn a real tenant's tokens.  The queue-full and
        # streaming-envelope bounds still apply (they protect the
        # process, not a tenant).
        is_canary = job.tenant == CANARY_TENANT
        depth = len(self._queue) + len(self._parked)
        if p.max_queue_depth is not None and depth >= p.max_queue_depth:
            reason = "queue_full"
            msg = (f"queue depth {depth} at its bound "
                   f"{p.max_queue_depth}; back off and resubmit")
        elif (not is_canary and p.tenant_quota is not None
              and self._tenant_inflight.get(job.tenant, 0)
              >= p.tenant_quota):
            reason = "tenant_quota"
            msg = (f"tenant {job.tenant!r} already has "
                   f"{self._tenant_inflight[job.tenant]} jobs in "
                   f"flight (quota {p.tenant_quota})")
        elif (not is_canary and p.tenant_budget_dispatch_s is not None
              and obs.usage.LEDGER.dispatch_s_for(job.tenant)
              >= p.tenant_budget_dispatch_s):
            # fed from the LIVE usage ledger (obs/usage.py): dispatch
            # wall-seconds this tenant has consumed, all classes
            reason = "budget"
            msg = (f"tenant {job.tenant!r} has consumed "
                   f"{obs.usage.LEDGER.dispatch_s_for(job.tenant):.3f}s"
                   f" of dispatch time, at/over its "
                   f"{p.tenant_budget_dispatch_s}s budget")
        elif (job.streaming is not None
              and p.streaming_staged_bytes is not None
              and self._stream_window_bytes(job)
              > p.streaming_staged_bytes):
            reason = "stream_envelope"
            msg = (f"streaming window would stage "
                   f"~{self._stream_window_bytes(job)} bytes, over "
                   f"the streaming class's resource envelope "
                   f"{p.streaming_staged_bytes} "
                   "(docs/STREAMING.md); narrow the window")
        elif not is_canary and self._buckets is not None \
                and not self._buckets.try_take(job.tenant):
            reason = "rate_limit"
            msg = (f"tenant {job.tenant!r} exceeded its "
                   f"{p.tenant_rate_per_s}/s submission rate")
        if reason is None:
            return
        self.telemetry.count("admission_rejects")
        obs.METRICS.inc("mdtpu_admission_rejects_total", reason=reason)
        obs.span_event("admission_reject", tenant=job.tenant,
                       qos=job.qos, reason=reason)
        raise AdmissionRejectedError(
            f"submission rejected ({reason}): {msg}", reason)

    def _stream_window_bytes(self, job: AnalysisJob) -> int:
        """Estimated staged bytes one streaming window puts in flight
        — the quantity ``QosPolicy.streaming_staged_bytes`` bounds
        (window frames x atoms x 12 B f32, the estimate
        :meth:`_lease_ttl` uses)."""
        try:
            traj = job.trajectory
            w = int((job.streaming or {}).get("window")
                    or getattr(traj, "chunk_frames", 0) or 64)
            return w * int(traj.n_atoms) * 12
        except Exception:
            return 0

    def _derive_fingerprint(self, job: AnalysisJob) -> str:
        """Journal identity when the caller supplied none: the job's
        window/backend/tenant plus an occurrence counter — stable only
        when jobs are resubmitted in the same order (the CLI derives a
        stronger one from the job-file spec + position)."""
        base = (f"{job.tenant}|{type(job.analysis).__name__}|"
                f"{job.start}:{job.stop}:{job.step}|{job.backend}")
        n = self._fp_counts.get(base, 0)
        self._fp_counts[base] = n + 1
        return f"{base}#{n}"

    def submit_all(self, jobs) -> list[JobHandle]:
        return [self.submit(j) for j in jobs]

    # ---- tenant pinning (hot tenants' cache entries survive
    #      admission eviction) ----

    def _note_ns_submit(self, job: AnalysisJob) -> None:
        if self.cache is None:
            return
        ns = reader_fingerprint(job.trajectory)
        with self._cond:
            self._ns_active[ns] = self._ns_active.get(ns, 0) + 1
            if self._ns_active[ns] == 1:
                self.cache.pin(ns)

    def _note_ns_done(self, job: AnalysisJob) -> None:
        if self.cache is None:
            return
        ns = reader_fingerprint(job.trajectory)
        with self._cond:
            n = self._ns_active.get(ns, 0) - 1
            if n <= 0:
                self._ns_active.pop(ns, None)
                self.cache.unpin(ns)
            else:
                self._ns_active[ns] = n

    # ---- worker loop ----

    def _claimable_locked(self) -> list:
        """Queue entries a worker may claim now: prefetch-held handles
        are skipped — their staging completes (and releases the hold)
        before they become claimable, which is what "staged before the
        job is claimed" means (docs/COLDSTART.md).  Resume-gated
        handles (a parked live tenant waiting out its
        ``stream_park_delay_s``) are skipped until the clock passes
        their gate — re-claiming one immediately would hot-spin on the
        same dry feed it just stalled on."""
        now = self._clock()
        return [e for e in self._queue
                if not e[2]._prefetch_hold and e[2]._resume_at <= now]

    def _resume_wait_locked(self) -> float | None:
        """Bound for the worker's idle wait: the soonest resume gate
        among queued entries (None = nothing resume-gated; wait for a
        notify).  Without this bound a queue holding ONLY parked live
        tenants would leave every worker in an untimed wait no one
        ever notifies — the resume would deadlock."""
        now = self._clock()
        gates = [e[2]._resume_at for e in self._queue
                 if e[2]._resume_at > now]
        if not gates:
            return None
        return max(0.0, min(gates) - now)

    def _worker_outer(self) -> None:
        """Thread target: records a dying worker's diagnostics for the
        supervisor (which folds them into the stranded jobs' fault
        logs, reaps the held lease, and respawns the thread).  A
        normal loop exit (shutdown) records nothing."""
        try:
            self._worker()
        except BaseException as exc:
            name = threading.current_thread().name
            with self._cond:
                if not isinstance(exc, _supervision.WorkerFenced):
                    # a fence death records nothing: its lease was
                    # already reaped (the fence IS the reap's doing),
                    # so the record would never be consumed and a
                    # long-lived scheduler would leak one entry per
                    # fence event
                    self._sup.record_worker_death(
                        name, f"{type(exc).__name__}: {exc}",
                        _traceback.format_exc())
                self._sup.fenced.discard(threading.current_thread())
                self._cond.notify_all()
            if not isinstance(exc, _supervision.WorkerFenced):
                self._log.warning("worker %s died: %s: %s", name,
                                  type(exc).__name__, exc)
            # swallow: the thread is gone either way, and re-raising
            # would only spam the interpreter's thread-excepthook

    def _worker(self) -> None:
        while True:
            with self._cond:
                while True:
                    # a reaped-but-alive worker must exit, not claim:
                    # the fence only fires at phase ENTRIES, so a
                    # zombie that finished its revoked batch without
                    # another phase would otherwise claim fresh jobs
                    # and die at THEIR first phase — charging a
                    # poison incident to innocent handles
                    if (threading.current_thread()
                            in self._sup.fenced):
                        raise _supervision.WorkerFenced(
                            "worker was reaped (lease expired); "
                            "exiting instead of claiming new work")
                    if self._claimable_locked():
                        break
                    if self._parked and self._active == 0:
                        # nothing queued AND no other worker mid-run
                        # (whose finish could free budget): deferred
                        # entries get their turn now
                        self._unpark_locked()
                        break
                    if self._stream_parked \
                            and not self._overloaded_locked():
                        # overload passed: shed-parked live tenants
                        # re-enter the queue (their resume gates, not
                        # this re-admission, pace the actual claims)
                        self._stream_unpark_locked()
                        if self._claimable_locked():
                            break
                    # exit only when NOTHING is queued at all: a
                    # prefetch-held entry is still queued work — its
                    # hold is released (with a notify) by the prefetch
                    # routine's finally, so wait for it rather than
                    # stranding the job in 'queued' forever
                    if (self._shutdown and not self._parked
                            and not self._stream_parked
                            and not self._queue):
                        return
                    # timed when resume-gated entries exist — no other
                    # thread notifies for a clock gate passing
                    self._cond.wait(self._resume_wait_locked())
                batch, poison, token = self._claim_batch_locked()
                self._active += 1
                # dequeue accounting at CLAIM time (not per-unit):
                # the supervisor's requeue of a reaped batch can then
                # balance the gauge without guessing how far the dead
                # worker got
                for _ in batch:
                    self.telemetry.note_dequeue()
            if self.journal is not None and poison is None:
                me = threading.current_thread().name
                for h in batch:
                    self.journal.record("claim", h.job.fingerprint,
                                        worker=me)
            progressed = True      # safe default for the finally
            try:
                # the process-level fault site (reliability/faults.py
                # "worker"): an InjectedWorkerDeath here unwinds the
                # whole thread with its lease held — the supervisor's
                # reap path, not any retry envelope, must recover
                if _faults.plans():
                    _faults.fire("worker")
                if poison is not None:
                    # a job whose coalesce key cannot even be computed
                    # (broken analysis/trajectory attribute) fails
                    # ITSELF — never the worker thread
                    for h in batch:
                        self._complete(h, token, exc=poison)
                    progressed = True
                else:
                    progressed = self._process_batch(batch, token)
                # normal end of batch: hand the lease back.  NOT in
                # the finally — a dying/fenced worker must leave its
                # lease held so the reaper sees the stranded batch
                with self._cond:
                    self._sup.release(threading.current_thread())
            finally:
                with self._cond:
                    self._active -= 1
                    if progressed:
                        # something actually ran: deferred entries may
                        # now find freed reservations
                        self._unpark_locked()
                    self._cond.notify_all()

    def _unpark_locked(self) -> None:
        if self._parked:
            self._queue.extend(self._parked)
            self._parked.clear()
            self._cond.notify_all()

    def _stream_unpark_locked(self) -> None:
        """Re-admit shed-parked live tenants once overload passed.
        They keep their resume gates: re-entry is to the QUEUE, the
        claim path still waits the park delay out."""
        if self._stream_parked:
            self._queue.extend(self._stream_parked)
            for _ in self._stream_parked:
                # balance the note_dequeue the shed-park recorded
                self.telemetry.note_requeue()
            self._stream_parked.clear()
            self._cond.notify_all()

    def _claim_batch_locked(self):
        """Claim the best-priority entry plus every queued peer sharing
        its coalesce key (lower-priority peers deliberately ride along:
        amortizing the staged pass is worth the inversion).  O(queue)
        per claim — a serving queue is small; revisit if it stops
        being.  Returns ``(handles, poison, token)``: a non-None
        poison is the key-computation failure of the best entry
        (claimed alone, to be failed by the caller); ``token`` is the
        granted lease's ownership token (see :meth:`_complete`).

        A supervision-requeued handle (``_solo_only``) is claimed
        ALONE and never rides as a peer: its previous batch already
        sank a worker, and one poison tenant must not sink the merged
        pass twice."""
        best = self._best_claimable_locked()
        try:
            key = best[2].job.coalesce_key()
        except Exception as exc:
            self._queue.remove(best)
            return [best[2]], exc, self._grant_locked([best[2]])
        if best[2]._solo_only:
            self._queue.remove(best)
            return [best[2]], None, self._grant_locked([best[2]])
        claimed, rest = [], []
        for entry in self._queue:
            try:
                # a prefetch-held peer stays queued: its staging is
                # mid-flight, and the blocks it stages are this very
                # key's — it rides them as hits when claimed next.
                # Known tradeoff: a same-key job claimed DURING the
                # hold runs its own (hit-resident) pass instead of
                # coalescing with the held peers — one extra dispatch
                # pass over staged blocks, bounded by the hold's
                # staging wall; blocking the claim on the hold would
                # trade worker idle time for it instead.
                same = (not entry[2]._prefetch_hold
                        and not entry[2]._solo_only
                        and entry[2].job.coalesce_key() == key)
            except Exception:
                same = False     # surfaces when it becomes `best`
            if same:
                claimed.append(entry[2])
            else:
                rest.append(entry)
        self._queue[:] = rest
        return claimed, None, self._grant_locked(claimed)

    def _best_claimable_locked(self):
        """The queue entry the next claim starts from: weighted-fair
        ACROSS QoS classes (stride scheduling over the policy weights
        — docs/RELIABILITY.md §7), best ``(-priority, seq)`` WITHIN
        the picked class.  With one class present (every pre-QoS
        workload) this is exactly the old ``min(queue)``."""
        claimable = self._claimable_locked()
        by_class: dict = {}
        for entry in claimable:
            by_class.setdefault(entry[2].job.qos, []).append(entry)
        chosen = self._stride.pick(sorted(by_class))
        return min(by_class[chosen])

    def _grant_locked(self, handles):
        """Grant this worker's lease over the claimed handles and
        return its ownership token (always minted, even with
        supervision off — the zombie-fencing guard in
        :meth:`_complete` costs nothing and keeps one code path)."""
        if not self.supervise:
            token = object()
            for h in handles:
                h._owner = token
            return token
        ttl = self._lease_ttl(handles)
        if handles and all(h.job.qos == "streaming" for h in handles):
            # the streaming class's sanctioned lease
            # (docs/STREAMING.md): unbounded runtime by design — its
            # envelope is bounded in RESOURCES at admission
            # (streaming_staged_bytes), so the runaway caps do not
            # apply.  The TTL widens past the stall window too: a
            # stalled feed enters no phases (no heartbeats) until the
            # stall raises, and reaping a healthily-waiting tenant
            # would charge a poison incident to a dry feed.
            stall = max((float((h.job.streaming or {}).get(
                "stall_timeout_s", 30.0)) for h in handles),
                default=30.0)
            return self._sup.grant(
                handles, max(ttl, stall + self.lease_ttl_s)).token
        return self._sup.grant(
            handles, ttl,
            max_renewals=self.qos.max_lease_renewals,
            max_runtime_s=self.qos.max_runtime_s).token

    def _lease_ttl(self, handles) -> float:
        """TTL for one claimed batch: the configured floor, widened by
        the batch's estimated staged bytes (a healthy worker moves at
        least LEASE_MIN_BYTES_PER_S between phase entries), tightened
        by the tightest member deadline — never below the floor."""
        est = 0
        deadline = None
        for h in handles:
            try:
                # frames x atoms x 3 x 4B staged f32 (no selection
                # resolved: selections resolve in _prepare)
                n = len(h.job.analysis._frames(
                    h.job.start, h.job.stop, h.job.step, h.job.frames))
                est += n * h.job.trajectory.n_atoms * 12
            except Exception:
                pass
            if h.job.deadline_s is not None:
                deadline = (h.job.deadline_s if deadline is None
                            else min(deadline, h.job.deadline_s))
        return _supervision.derive_ttl(self.lease_ttl_s, est, deadline)

    def _usage_weights(self, handles) -> list:
        """``[(tenant, class, frames), ...]`` for one unit — the
        pro-rata split the trace context carries to every downstream
        charge site (obs/usage.py: shared meters of a merged pass
        split by member frame count, sums exact).  Frame counts reuse
        the :meth:`_lease_ttl` estimate."""
        out = []
        for h in handles:
            try:
                n = len(h.job.analysis._frames(
                    h.job.start, h.job.stop, h.job.step, h.job.frames))
            except Exception:
                n = 0
            out.append((h.job.tenant, h.job.qos, n))
        return out

    def _charge_usage(self, weights: list, t0: float,
                      frames: bool = False) -> None:
        """Charge one served unit's dispatch wall-seconds (split
        pro-rata) and, on success, each member's exact frame count."""
        led = obs.usage.LEDGER
        if not led.enabled or not weights:
            return
        led.charge_split(
            weights, dispatch_s=max(0.0, time.monotonic() - t0))
        if frames:
            for tenant, qos, n in weights:
                if n:
                    led.charge(tenant, qos, frames=n)

    def _requeue(self, handles: list[JobHandle]) -> None:
        """Park admission-deferred handles; they re-enter the queue
        only after other work has actually run (see _worker) — putting
        a top-priority entry straight back would re-claim it in a
        tight loop without ever yielding to the work it deferred
        behind."""
        with self._cond:
            for h in handles:
                h._deferrals += 1
                # a parked handle rides no lease and belongs to no
                # worker until its next claim
                h._owner = None
                self._sup.drop_handle(h)
                self._parked.append((-h.job.priority, next(self._seq),
                                     h))
                # balance the note_dequeue the claim already recorded —
                # the handle is queued again, but NOT resubmitted
                self.telemetry.note_requeue()

    def _complete(self, handle: JobHandle, token,
                  exc: BaseException | None = None,
                  state: str = JobState.FAILED) -> bool:
        """Guarded terminal marking: only the worker still OWNING the
        handle (its claim's lease token) may resolve it.  A reaped
        worker's late completion — the zombie woke after its batch was
        requeued — finds the token changed and is DISCARDED: the
        requeued attempt owns the handle's accounting now, and a
        double `_finish` would corrupt the inflight count and the
        telemetry."""
        with self._cond:
            if handle._owner is not token or handle.done():
                return False
            handle._owner = None
            # drop the handle from its lease HERE, inside the lock:
            # _mark_done below runs outside it (callbacks do disk
            # I/O), and a reap landing in that window would otherwise
            # see an unresolved stranded handle and requeue or
            # quarantine a job that just completed — a double
            # terminal record and a corrupted inflight count
            self._sup.drop_handle(handle)
        if exc is None:
            handle._mark_done()
        else:
            handle._mark_failed(exc, state)
        self._finish(handle)
        return True

    def _finish(self, handle: JobHandle) -> None:
        self.telemetry.note_finish(handle)
        self._note_ns_done(handle.job)
        if (self.journal is not None
                and handle.state != JobState.QUARANTINED):
            # terminal records are the ones recovery must never
            # double-run: fsync immediately, not batched.  A
            # quarantined handle already wrote its own terminal record
            # (with the reason) in _quarantine — exactly one
            # terminal record per job, so recovery and the chaos
            # tests' exactly-once accounting can count them.
            self.journal.record("finish", handle.job.fingerprint,
                                state=handle.state, durable=True)
        # per-tenant jobs-by-outcome meter (obs/usage.py): charged by
        # the journal writer — exactly one charge per terminal record,
        # so usage.reconcile audits the meter against the journal's
        # finish ledger.  A fleet host's local scheduler defers the
        # charge to the controller (its journal writer).
        if self._usage_charge_jobs:
            obs.usage.LEDGER.charge_job(handle.job.tenant,
                                        handle.job.qos, handle.state)
        with self._cond:
            self._sup.drop_handle(handle)
            self._inflight -= 1
            n = self._tenant_inflight.get(handle.job.tenant, 0) - 1
            if n <= 0:
                self._tenant_inflight.pop(handle.job.tenant, None)
            else:
                self._tenant_inflight[handle.job.tenant] = n
            self._cond.notify_all()

    def _process_batch(self, batch: list[JobHandle], token) -> bool:
        """Run one claimed batch.  Returns True when any handle made
        real progress (ran or reached a terminal state) — the signal
        that parked (deferred) entries may find freed budget."""
        progressed = False
        live = []
        for h in batch:
            if h.deadline_expired:
                self._complete(h, token, exc=JobDeadlineExpired(
                    f"job {h.job_id} ({h.job.tenant}) spent "
                    f"{h.queue_wait_s or 0:.3f}s queued, over its "
                    f"{h.job.deadline_s}s deadline"),
                    state=JobState.EXPIRED)
                progressed = True
            else:
                live.append(h)
        if not live:
            return progressed
        # NOTHING may escape into _worker: an uncaught planning or
        # admission error would kill the worker thread, stranding every
        # queued job and hanging drain() — failures land on the
        # affected handles instead
        try:
            units = _coalesce.plan_units(live)
        except Exception as exc:
            for h in live:
                self._complete(h, token, exc=exc)
            return True
        for unit in units:
            try:
                if self._run_unit(unit, token):
                    progressed = True
            except Exception as exc:
                for h in unit.handles:
                    self._complete(h, token, exc=exc)
                progressed = True
        return progressed

    # ---- supervision: reap / requeue / quarantine / respawn ----

    def _supervisor(self) -> None:
        """Supervisor loop: reap expired or dead-held leases, release
        parked requeues whose fenced worker exited, respawn dead
        worker threads.  Exits once the scheduler is shut down and no
        lease or live worker remains."""
        while True:
            with self._cond:
                quarantines, fences, capped = self._reap_locked()
                alive = [t for t in self._workers if t.is_alive()]
                stop = (self._shutdown and not self._sup.leases
                        and not self._pending_requeues and not alive)
                if not stop and not quarantines and not fences \
                        and not capped:
                    self._cond.wait(self.supervision_interval_s)
            # quarantine and flight dumps OUTSIDE the condition lock:
            # quarantine fires the handle's done-callbacks (the batch
            # CLI writes an .npz there) and a durable journal fsync,
            # and a dump is an fsync'd file write — holding the lock
            # through disk I/O would stall every claim/submit/finish
            for worker_name, n_jobs in fences:
                _flight.dump("worker_fence", self._flight_dir,
                             extra={"worker": worker_name,
                                    "n_jobs": n_jobs})
            for h, incident in quarantines:
                self._quarantine(h, incident)
            for h, incident in capped:
                self._fail_capped(h, incident)
            # overload tick (docs/RELIABILITY.md §7): the supervisor
            # owns the shed ladder between submissions, so a queue
            # that outran capacity mid-wave sheds without waiting for
            # the next submit() to notice
            if not stop:
                self._maybe_shed()
                # alert tick (obs/alerts.py): the rules engine reads
                # the same unified snapshot /metrics exposes, at most
                # every alert_interval_s on the injectable clock
                self._alert_tick()
                # canary tick (service/canary.py): settle/launch the
                # synthetic probe — non-blocking, at most one in flight
                self._canary_tick()
            if stop:
                # a worker death AFTER shutdown can requeue a handle
                # no one will ever claim (respawn stops at shutdown):
                # resolve it instead of hanging its waiters forever
                if self._queue or self._parked or self._stream_parked:
                    self.abort_queued(
                        "scheduler shut down with no remaining "
                        "workers to claim this requeued job")
                return

    def _alert_tick(self, force: bool = False) -> list:
        """Evaluate the alert rules over this scheduler's unified
        snapshot (the supervisor calls this every pass; the interval
        bound keeps the snapshot cost off the 50 ms supervision
        cadence).  Returns this tick's transitions."""
        if self.alerts is None:
            return []
        now = self._clock()
        if not force and now - self._alert_last < self.alert_interval_s:
            return []
        self._alert_last = now
        snap = obs.unified_snapshot(timers=TIMERS, cache=self.cache,
                                    telemetry=self.telemetry)
        return self.alerts.evaluate(snap, now=now)

    def _canary_tick(self) -> None:
        """Drive the attached synthetic canary on the supervisor
        cadence.  A probe FAILURE is the canary's own signal; a tick
        that raises must never kill the supervisor."""
        if self.canary is None:
            return
        try:
            self.canary.tick()
        except Exception:
            self._log.exception("canary tick failed")

    def _reap_locked(self) -> tuple:
        """Reap due leases; returns ``(quarantines, fences, capped)``
        — ``(handle, incident)`` pairs that crossed the poison
        threshold, ``(worker_name, n_jobs)`` pairs for workers fenced
        this pass, and ``(handle, incident)`` pairs whose lease hit
        its RENEWAL CAP (docs/RELIABILITY.md §7: a runaway that
        heartbeats forever; failed typed instead of requeued) — for
        the caller to resolve AFTER releasing the condition lock (all
        do disk I/O: done-callbacks, a durable journal record, an
        fsync'd dump)."""
        quarantines = []
        fences = []
        cap_fails = []
        now = self._clock()
        for lease in self._sup.expired(now):
            worker = lease.worker
            self._sup.leases.pop(worker, None)
            dead = not worker.is_alive()
            runaway = not dead and lease.capped(now)
            reason = ("worker_death" if dead
                      else "runtime_capped" if runaway
                      else "lease_expired")
            death = self._sup.worker_deaths.pop(worker.name, None)
            self.telemetry.count("lease_expired")
            obs.METRICS.inc("mdtpu_lease_expired_total", reason=reason)
            obs.span_event("lease_reaped", worker=worker.name,
                           reason=reason,
                           n_jobs=len(lease.handles))
            self._log.warning(
                "reaping lease of %s (%s): %d job(s) stranded",
                worker.name, reason, len(lease.handles))
            if not dead:
                # wedged, not dead: fence the zombie (its next phase
                # entry raises WorkerFenced) and HOLD the requeue
                # until it actually exits — re-running the same
                # analysis instance while the zombie still writes its
                # accumulators would corrupt the results.  The grace
                # deadline bounds a thread hung inside one phase
                # forever: after one more TTL the requeue proceeds
                # anyway (disclosed risk, docs/RELIABILITY.md).
                self._sup.fenced.add(worker)
                fences.append((worker.name, len(lease.handles)))
            for h in list(lease.handles):
                if h.done():
                    continue
                h._owner = None
                h._faults += 1
                incident = _supervision.capture_diagnostics(
                    h, reason=reason, worker=worker.name,
                    ttl=lease.ttl, death=death)
                h._fault_log.append(incident)
                if runaway:
                    # the renewal cap engaged: the job fails TYPED —
                    # never a requeue (a runaway re-run is the same
                    # runaway), never a poison count against a future
                    # batch.  The fenced zombie is actively
                    # heartbeating (that is what capped it), so its
                    # next phase entry aborts it and the respawn loop
                    # restores the pool slot; peers on other leases
                    # are untouched.
                    cap_fails.append((h, incident))
                elif h._faults >= self.poison_threshold:
                    quarantines.append((h, incident))
                elif dead:
                    self._requeue_supervised_locked(h)
                else:
                    self._pending_requeues.append(
                        (h, worker, now + lease.ttl))
        # release held requeues whose fenced worker exited — or whose
        # grace ran out (a thread hung inside ONE phase beyond reap +
        # one TTL).  In the grace case the zombie stays FENCED: if it
        # ever wakes, its next phase entry still aborts it instead of
        # racing the re-run for the analysis accumulators.  It is also
        # written off as lost capacity: replaced in the pool below (a
        # daemon thread, so neither shutdown's joins nor process exit
        # wait on it) — without this, n_workers=1 plus one forever-hung
        # dispatch would leave the requeued job unclaimable and wedge
        # drain()/shutdown() for good.
        if self._pending_requeues:
            still = []
            for h, worker, grace in self._pending_requeues:
                if not worker.is_alive():
                    self._sup.fenced.discard(worker)
                    if not h.done():
                        self._requeue_supervised_locked(h)
                elif now >= grace:
                    self._write_off_locked(worker)
                    if not h.done():
                        self._requeue_supervised_locked(h)
                else:
                    still.append((h, worker, grace))
            self._pending_requeues[:] = still
        # respawn dead worker threads (never past shutdown): pool
        # capacity must survive worker deaths, or one poison job
        # could bleed the scheduler down to zero workers
        if not self._shutdown:
            for i, t in enumerate(self._workers):
                if not t.is_alive():
                    # a death recorded with no lease to reap (the
                    # worker died between batches) has no consumer:
                    # discard it here rather than leak it forever
                    self._sup.worker_deaths.pop(t.name, None)
                    nt = threading.Thread(target=self._worker_outer,
                                          daemon=True,
                                          name=f"{t.name}r")
                    self._workers[i] = nt
                    self.telemetry.count("workers_respawned")
                    self._log.warning("respawned dead worker %s as %s",
                                      t.name, nt.name)
                    nt.start()
        return quarantines, fences, cap_fails

    def _write_off_locked(self, worker: threading.Thread) -> None:
        """Replace a forever-wedged (fenced, grace-expired, still
        alive) worker in the pool: the respawn loop above only sees
        DEAD threads, and shutdown/supervisor exit must not wait on a
        thread that may never wake.  The zombie keeps its fence — a
        late wakeup aborts at its next phase entry."""
        for i, t in enumerate(self._workers):
            if t is worker:
                nt = threading.Thread(target=self._worker_outer,
                                      daemon=True, name=f"{t.name}w")
                self._workers[i] = nt
                self.telemetry.count("workers_respawned")
                self._log.warning(
                    "writing off wedged worker %s (still alive, grace "
                    "spent); replacement %s started", t.name, nt.name)
                nt.start()
                return

    def _requeue_supervised_locked(self, h: JobHandle) -> None:
        """Put a reaped handle back in the queue — solo from now on,
        with its wait clock restarted (the requeue satellite fix:
        queue_wait must measure THIS wait, not the dead attempt's run
        time)."""
        h.state = JobState.QUEUED
        h.requeued_t = self._clock()
        h.started_t = None
        h._solo_only = True
        self._queue.append((-h.job.priority, next(self._seq), h))
        self.telemetry.note_requeue()
        self.telemetry.count("jobs_requeued")
        obs.METRICS.inc("mdtpu_jobs_requeued_total")
        obs.span_event("job_requeued", job_id=h.job_id,
                       tenant=h.job.tenant, faults=h._faults)
        if self.journal is not None:
            self.journal.record("requeue", h.job.fingerprint,
                                faults=h._faults)
        self._cond.notify_all()

    def _quarantine(self, h: JobHandle, incident: dict) -> None:
        """Park a poison job with its diagnostics instead of retrying
        forever: typed error on the handle, counter + trace event, and
        a durable journal record.  Called WITHOUT the condition lock
        (the supervisor drops it first): `_mark_failed` fires the
        handle's done-callbacks and the journal record fsyncs — disk
        I/O that must not stall claims.  Safe unlocked: the handle
        left its lease with `_owner` cleared at reap time, so a
        zombie's late `_complete` is already fenced off."""
        if h.done():
            return
        diagnostics = {
            "incidents": list(h._fault_log),
            "reason": incident.get("reason"),
            "last_worker": incident.get("worker"),
            "fault_count": h._faults,
        }
        # the black box rides the diagnostics (docs/OBSERVABILITY.md):
        # recent timeline + counters at the moment of the quarantine
        fpath = _flight.dump(
            "quarantine", self._flight_dir,
            extra={"job_id": h.job_id, "tenant": h.job.tenant,
                   "fingerprint": h.job.fingerprint,
                   "trace_id": h.job.trace_id,
                   "reason": incident.get("reason")})
        if fpath:
            diagnostics["flight_recorder"] = fpath
        err = JobQuarantinedError(
            f"job {h.job_id} ({h.job.tenant}, "
            f"{type(h.job.analysis).__name__}) quarantined after "
            f"{h._faults} supervision incidents "
            f"(last: {incident.get('reason')})", diagnostics)
        h._mark_failed(err, JobState.QUARANTINED)
        self.quarantined.append(h)
        obs.METRICS.inc("mdtpu_jobs_quarantined_total")
        obs.span_event("job_quarantined", job_id=h.job_id,
                       tenant=h.job.tenant,
                       reason=incident.get("reason"))
        self._log.error("quarantined job %d (%s): %s", h.job_id,
                        h.job.tenant, incident.get("reason"))
        if self.journal is not None:
            self.journal.record("quarantine", h.job.fingerprint,
                                reason=incident.get("reason"),
                                durable=True)
        self._finish(h)

    def _fail_capped(self, h: JobHandle, incident: dict) -> None:
        """Resolve a runaway handle whose lease hit its renewal cap
        (docs/RELIABILITY.md §7): typed failure, durable journal
        record via ``_finish``.  Called WITHOUT the condition lock
        (done-callbacks and the journal fsync are disk I/O); safe
        unlocked for the same reason ``_quarantine`` is — the handle
        left its lease with ``_owner`` cleared at reap time, so the
        runaway zombie's late ``_complete`` is already fenced off."""
        if h.done():
            return
        p = self.qos
        err = JobRuntimeExceeded(
            f"job {h.job_id} ({h.job.tenant}, "
            f"{type(h.job.analysis).__name__}) exceeded its runtime "
            f"cap (max_runtime_s={p.max_runtime_s}, "
            f"max_lease_renewals={p.max_lease_renewals}) after "
            f"{incident.get('lease_ttl_s')}s-TTL renewals; releasing "
            "its worker instead of renewing forever")
        h._mark_failed(err)
        obs.span_event("job_runtime_capped", job_id=h.job_id,
                       tenant=h.job.tenant, qos=h.job.qos)
        self._log.error(
            "runtime cap: job %d (%s) failed typed after its lease "
            "stopped renewing; worker released", h.job_id,
            h.job.tenant)
        self._finish(h)

    # ---- overload shedding (docs/RELIABILITY.md §7) ----

    def _overloaded_locked(self) -> bool:
        """The overload predicate, from signals the scheduler already
        owns: queued depth beyond ``shed_queue_depth`` while every
        worker holds a lease (depth with idle workers is transient —
        they are about to claim), or estimated staged bytes in flight
        beyond ``shed_staged_bytes`` (the PR-9 memory-guard
        accounting)."""
        p = self.qos
        if p.shed_queue_depth is not None:
            depth = len(self._queue) + len(self._parked)
            busy = (len(self._sup.leases) >= self.n_workers
                    if self.supervise
                    else self._active >= self.n_workers)
            if depth > p.shed_queue_depth and busy:
                return True
        if p.shed_staged_bytes is not None \
                and self._staged_inflight > p.shed_staged_bytes:
            return True
        return False

    def _collect_sheds_locked(self) -> tuple:
        """Pull the entries the shed ladder drops this pass out of the
        queue: lowest sheddable class first, newest first within a
        class (the jobs that would wait longest), down to the
        configured depth — and NEVER a class outside
        ``shed_classes``, whatever the depth.  Prefetch-held entries
        are skipped (their staging is mid-flight); they are
        reconsidered once released.

        Streaming entries on the ladder are PARKED, not killed
        (docs/STREAMING.md): moved to ``_stream_parked`` — out of the
        depth the overload predicate reads, resume-gated — and
        re-admitted by :meth:`_stream_unpark_locked` once overload
        passes.  Returns ``(sheds, parks)``."""
        p = self.qos
        if not self._overloaded_locked():
            return [], []
        target = p.shed_queue_depth or 0
        sheds: list[JobHandle] = []
        parks: list[JobHandle] = []
        for qos_cls in p.shed_ladder():
            for queue in (self._parked, self._queue):
                candidates = sorted(
                    (e for e in queue
                     if e[2].job.qos == qos_cls
                     and not e[2]._prefetch_hold),
                    # canary probes shed FIRST within a class — the
                    # pseudo-tenant must never cost a real tenant a
                    # shed slot — then newest first (the jobs that
                    # would wait longest)
                    key=lambda e: (e[2].job.tenant != CANARY_TENANT,
                                   -e[1]))
                for entry in candidates:
                    depth = len(self._queue) + len(self._parked)
                    if depth <= target:
                        return sheds, parks
                    queue.remove(entry)
                    self.telemetry.note_dequeue()
                    if qos_cls == "streaming":
                        entry[2]._resume_at = (
                            self._clock() + p.stream_park_delay_s)
                        self._stream_parked.append(entry)
                        parks.append(entry[2])
                    else:
                        sheds.append(entry[2])
        return sheds, parks

    def _maybe_shed(self) -> list[JobHandle]:
        """One overload-controller pass: collect under the lock,
        resolve (done-callbacks + durable journal records) outside it.
        Returns the handles shed.  Also the load-gate for shed-parked
        live tenants: when the pass finds the overload over, they
        re-enter the queue here (the supervisor tick calls this
        between submissions)."""
        p = self.qos
        if p.shed_queue_depth is None and p.shed_staged_bytes is None:
            return []
        with self._cond:
            if self._stream_parked \
                    and not self._overloaded_locked():
                self._stream_unpark_locked()
            sheds, parks = self._collect_sheds_locked()
            if sheds or parks:
                self._cond.notify_all()
        for h in parks:
            self._note_stream_park(h, "shed")
        for h in sheds:
            self._resolve_shed(h)
        return sheds

    def _note_stream_park(self, h: JobHandle, reason: str,
                          **extra) -> None:
        """Disclose one streaming park (stall or shed) — counted
        ``mdtpu_stream_parks_total{reason=}``, span event
        ``stream_parked``.  Parks are NEVER supervision faults: the
        handle's poison counter and fault log are untouched."""
        obs.METRICS.inc("mdtpu_stream_parks_total", reason=reason)
        obs.span_event("stream_parked", job_id=h.job_id,
                       tenant=h.job.tenant, reason=reason, **extra)
        self._log.info(
            "parked streaming job %d (%s): %s; resume in %.2fs",
            h.job_id, h.job.tenant, reason,
            max(0.0, h._resume_at - self._clock()))

    def _resolve_shed(self, h: JobHandle) -> None:
        if h.done():
            return
        qos_cls = h.job.qos
        err = JobShedError(
            f"job {h.job_id} ({h.job.tenant}, class {qos_cls}) shed "
            "by the overload controller: queue depth outran capacity "
            "and this class is in the configured shed set "
            f"({self.qos.shed_classes}); resubmit once the burst "
            "passes", qos=qos_cls)
        h._mark_failed(err, JobState.SHED)
        obs.METRICS.inc("mdtpu_jobs_shed_total",
                        **{"class": qos_cls})
        obs.span_event("job_shed", job_id=h.job_id,
                       tenant=h.job.tenant, qos=qos_cls)
        self._log.warning(
            "overload: shed job %d (%s, class %s) — queue depth over "
            "%s with all workers busy", h.job_id, h.job.tenant,
            qos_cls, self.qos.shed_queue_depth)
        self._finish(h)

    @staticmethod
    def recover(path) -> dict:
        """Replay a journal after a crash: ``{"jobs": {fp: record},
        "done": set, "quarantined": set, "pending": [fp, ...]}`` where
        ``pending`` is every job submitted (or claimed — the crash
        caught it mid-run) but never finished; those are the ones a
        restarted process must resubmit.  Idempotence contract: the
        caller derives the same fingerprints it used before the crash
        (the ``batch --journal`` CLI derives them from the job-file
        spec + position)."""
        jobs = _journal.replay(path)
        return {
            "jobs": jobs,
            "done": {fp for fp, r in jobs.items()
                     if r["state"] == "done"},
            "quarantined": {fp for fp, r in jobs.items()
                            if r["state"] == "quarantined"},
            "pending": [fp for fp, r in jobs.items()
                        if r["state"] in ("queued", "claimed")],
        }

    @staticmethod
    def recover_fleet(path) -> dict:
        """Fleet-journal twin of :meth:`recover`
        (docs/RELIABILITY.md §6): same per-job replay, PLUS epoch
        fencing — records a zombie controller appended under a stale
        epoch are rejected and counted — and the ``finishes``
        exactly-once ledger.  What :meth:`FleetController.adopt` (and
        the chaos tests' audits) read."""
        return _journal.replay_fleet(path)

    # ---- warmup + scheduler-driven prefetch (docs/COLDSTART.md) ----

    def _plan_for(self, handles: list[JobHandle]):
        """Coalesce-plan ``handles`` exactly as a claim would: bucket
        by coalesce key (failures dropped — they surface at claim
        time), then :func:`~mdanalysis_mpi_tpu_torch.service.coalesce.
        plan_units` per bucket.  Used by warmup and prefetch so what
        they compile/stage is what the claim will actually run."""
        buckets: dict = {}
        for h in handles:
            try:
                buckets.setdefault(h.job.coalesce_key(), []).append(h)
            except Exception:
                continue
        units = []
        for group in buckets.values():
            try:
                units.extend(_coalesce.plan_units(group))
            except Exception:
                continue
        return units

    def warmup(self, jobs) -> dict:
        """Prepare every program the given jobs (AnalysisJobs or
        analysis instances) will need, BEFORE submission: plans the
        coalesce units a claim would produce and hands each unit's
        runnable to the executor's warmup (``TorchExecutor.warmup`` /
        ``MeshExecutor.warmup``: build and load the ``csrc/`` kernel
        library on a CUDA device, then run each dispatch shape once on
        every device).  A warmed worker's first dispatch builds and
        loads nothing.  Returns ``{"executables": n, "seconds":
        wall}``, ``n`` the programs run."""
        import time

        from mdanalysis_mpi_tpu_torch.parallel.executors import (
            get_executor, warmup_analysis,
        )

        t0 = time.perf_counter()
        handles = [JobHandle(j if isinstance(j, AnalysisJob)
                             else AnalysisJob(j)) for j in jobs]
        n = 0
        for unit in self._plan_for(handles):
            job = unit.handles[0].job
            if job.backend not in DEVICE_BACKENDS:
                continue
            kwargs = {k: v for k, v in job.executor_kwargs.items()
                      if k != "block_cache"}
            kwargs["block_cache"] = (
                job.executor_kwargs.get("block_cache") or self.cache)
            try:
                ex = get_executor(job.backend, **kwargs)
                n += warmup_analysis(unit.runnable, ex,
                                     batch_size=job.batch_size,
                                     **job.window_kwargs())
            except Exception as exc:
                # warmup is an optimization: a job whose kernels fail
                # to precompile still runs (and surfaces its real
                # error, if any, at claim time)
                self._log.warning("warmup skipped for %s: %s",
                                  type(job.analysis).__name__, exc)
        return {"executables": n,
                "seconds": round(time.perf_counter() - t0, 4)}

    def prefetch_pending(self, max_units: int | None = None) -> int:
        """Stage queued (unclaimed) jobs' blocks into the shared cache
        ahead of their claim — synchronously, in priority order.
        Respects admission control (reserve-or-skip; NEVER evicts —
        prefetch is opportunistic and must not displace a hot
        tenant's superblocks) and tenant pinning.  Returns blocks
        staged.  The background twin (``prefetch=True``) calls this
        while all workers are busy.

        Resilient jobs are not prefetched: their claim-time staging
        runs under a per-run ReliabilityRuntime whose salvage state
        namespaces the cache keys (``validate=True``) — a plain
        prefetch would stage ``validate=False`` twins the run can
        never hit, dead weight in a never-evicting shared cache.

        Shed-pending jobs are not prefetched either
        (docs/RELIABILITY.md §7): while the overload controller is
        engaged, a job of a sheddable class is about to be dropped —
        staging its blocks would burn decode/wire time AND park a
        never-hit entry in a never-evicting shared cache.  Skips are
        counted (``prefetch_skipped_shed``)."""
        staged = 0
        units_done = 0
        shed_counted: set = set()
        while max_units is None or units_done < max_units:
            with self._cond:
                overloaded = self._overloaded_locked()
                if overloaded:
                    for e in self._queue:
                        h = e[2]
                        if (self.qos.sheddable(h.job.qos)
                                and id(h) not in shed_counted):
                            shed_counted.add(id(h))
                            self.telemetry.count(
                                "prefetch_skipped_shed")
                pending = [e[2] for e in sorted(self._queue)
                           if not e[2]._prefetch_hold
                           and not e[2].prefetched
                           and not e[2].job.resilient
                           # a live tenant's window grows under the
                           # prefetch: the blocks staged now are stale
                           # by its claim (docs/STREAMING.md)
                           and e[2].job.streaming is None
                           and not (overloaded and self.qos.sheddable(
                               e[2].job.qos))
                           and e[2].job.backend in DEVICE_BACKENDS
                           and "block_cache" not in
                           e[2].job.executor_kwargs]
                if self.cache is None or not pending:
                    break
                units = self._plan_for(pending)
                if not units:
                    break
                unit = units[0]
                for h in unit.handles:
                    h._prefetch_hold = True
            try:
                staged += self._prefetch_unit(unit)
            finally:
                with self._cond:
                    for h in unit.handles:
                        h._prefetch_hold = False
                        h.prefetched = True
                    self._cond.notify_all()
            units_done += 1
        return staged

    def _prefetch_unit(self, unit) -> int:
        """Stage one planned unit's blocks (no dispatch).  Admission:
        reserve the estimate, or ride resident entries; otherwise skip
        — deferral and eviction are claim-time decisions."""
        from mdanalysis_mpi_tpu_torch.parallel.executors import (
            get_executor, stage_analysis,
        )

        job = unit.handles[0].job
        est = self._estimate_bytes(job)
        reserved = 0
        if est > self.cache.max_bytes:
            self.telemetry.count("prefetch_skipped")
            return 0
        if self.cache.reserve(est):
            reserved = est
        elif not self.cache.ns_bytes(reader_fingerprint(job.trajectory)):
            self.telemetry.count("prefetch_skipped")
            return 0
        try:
            kwargs = {k: v for k, v in job.executor_kwargs.items()
                      if k != "block_cache"}
            ex = get_executor(job.backend, block_cache=self.cache,
                              **kwargs)
            n = stage_analysis(unit.runnable, ex,
                               batch_size=job.batch_size,
                               **job.window_kwargs())
        except Exception as exc:
            self.telemetry.count("prefetch_skipped")
            self._log.warning("prefetch failed for %s: %s",
                              type(job.analysis).__name__, exc)
            return 0
        finally:
            if reserved:
                # staged bytes are now accounted as cache entries
                self.cache.release(reserved)
        if n:
            self.telemetry.count("prefetch_jobs", len(unit.handles))
            self.telemetry.count("prefetch_blocks", n)
        return n

    def _prefetch_worker(self) -> None:
        """Background prefetch: while every worker is mid-run and
        unclaimed jobs wait, stage the next unit's blocks so its
        wave-1 misses become hits."""
        while True:
            with self._cond:
                while not self._shutdown and not (
                        self._active >= self.n_workers
                        and any(not e[2]._prefetch_hold
                                and not e[2].prefetched
                                for e in self._queue)):
                    self._cond.wait(0.05)
                if self._shutdown:
                    return
            self.prefetch_pending(max_units=1)

    # ---- SDC scrubbing + memory watchdog
    #      (docs/RELIABILITY.md §5 "Integrity model") ----

    def scrub_now(self, max_entries: int | None = None) -> dict:
        """One synchronous scrub pass over the shared cache: re-fetch
        fingerprinted resident entries, compare against the stage-time
        host fingerprints, quarantine mismatches (the next pass over
        those frames re-stages clean bytes).  Returns the cache's
        ``{"checked", "corrupt", "bytes"}`` stats (empty dict when the
        cache has no scrub support)."""
        if self.cache is None or not hasattr(self.cache, "scrub"):
            return {}
        stats = self.cache.scrub(max_entries=max_entries)
        if stats.get("corrupt"):
            self._log.error(
                "scrub pass quarantined %d corrupt cache entr%s "
                "(%d checked)", stats["corrupt"],
                "y" if stats["corrupt"] == 1 else "ies",
                stats["checked"])
        return stats

    #: Entries one background scrub iteration verifies: keeps each
    #: pass short so the idle check stays honest — a job submitted
    #: mid-pass waits at most a few fetches, not a full-cache sweep
    #: (the cache rotates a cursor, so coverage is complete across
    #: iterations).
    SCRUB_BATCH = 8

    def _scrub_worker(self) -> None:
        """Background scrubber (``scrub=True``): every
        ``scrub_interval_s``, IF no worker is mid-run — the
        device→host re-fetch competes for the host core and the
        transfer link, so scrubbing rides idle cycles only — verify
        the next :data:`SCRUB_BATCH` fingerprinted cache entries."""
        while True:
            with self._cond:
                # predicate check BEFORE the wait too: a shutdown
                # notify that fired while this thread was out
                # scrubbing must not be re-waited-out for a whole
                # interval (same pattern as _prefetch_worker)
                if self._shutdown:
                    return
                self._cond.wait(self.scrub_interval_s)
                if self._shutdown:
                    return
                if self._active > 0 or self._queue or self._parked:
                    continue          # busy: keep the host core free
            self.scrub_now(max_entries=self.SCRUB_BATCH)

    # ---- cache admission ----

    def _estimate_bytes(self, job: AnalysisJob) -> int:
        """Estimated staged working set of one pass over the job's
        window: frames × n_atoms × 3 × transfer-dtype bytes.
        Deliberately conservative (full atom count, not the selection
        union — selections are not resolvable before ``_prepare``):
        over-admitting thrashes hot tenants, over-estimating only
        queues a job that might have fit."""
        from mdanalysis_mpi_tpu_torch.parallel.executors import _block_nbytes

        n = len(job.analysis._frames(job.start, job.stop, job.step,
                                     job.frames))
        # the executors' own bytes-per-staged-block model (one
        # definition: a dtype they learn to stage, admission learns to
        # estimate — and an unknown dtype fails loudly in both places)
        return _block_nbytes(n, None, job.trajectory.n_atoms,
                             job.executor_kwargs.get("transfer_dtype",
                                                     "float32"))

    def _admit(self, unit) -> tuple[bool, int]:
        """Admission decision for one execution unit.  Returns
        ``(run_now, reserved_bytes)``; ``reserved_bytes < 0`` means
        run WITHOUT the shared cache.  May requeue the unit's handles
        (deferral) — then ``run_now`` is False."""
        job = unit.handles[0].job
        if (self.cache is None or job.backend not in DEVICE_BACKENDS
                or "block_cache" in job.executor_kwargs):
            return True, -1
        est = self._estimate_bytes(job)
        if est > self.cache.max_bytes:
            self.telemetry.count("admission_uncached")
            return True, -1
        if self.cache.reserve(est):
            self.telemetry.count("admission_reserved")
            return True, est
        if self.cache.ns_bytes(reader_fingerprint(job.trajectory)):
            # the tenant already holds entries — its prior superblocks
            # ARE the budget the reservation just lost to.  Admit
            # without one: the pass rides its resident blocks (hits),
            # and any overflow insert is capped by the cache itself.
            self.telemetry.count("admission_resident")
            return True, 0
        # reclaim idle tenants' entries (never a pinned/hot tenant's)
        # — but only when the reclaim can actually make the
        # reservation fit: pointless eviction destroys staged
        # superblocks a returning tenant would re-pay the full
        # decode+stage cost for
        reclaimable = self.cache.unpinned_bytes()
        if reclaimable and est <= self.cache.available_bytes + reclaimable:
            evicted = self.cache.evict_unpinned()
            if evicted:
                self.telemetry.count("admission_evictions", len(evicted))
                if self.cache.reserve(est):
                    self.telemetry.count("admission_reserved")
                    return True, est
        with self._cond:
            # other runnable work = queued entries, or another worker
            # mid-run (its reservation/entries may free; self is
            # always active here, hence > 1)
            can_defer = bool(self._queue) or self._active > 1
        if can_defer and max(h._deferrals for h in unit.handles) \
                < self.max_deferrals:
            self.telemetry.count("admission_deferrals",
                                 len(unit.handles))
            self._requeue(unit.handles)
            return False, 0
        # starved or out of deferrals: run, but leave the cache alone
        self.telemetry.count("admission_uncached")
        return True, -1

    # ---- breaker routing (reliability/breaker.py) ----

    def _route_backend(self, job: AnalysisJob) -> str:
        """The backend this claim should actually dispatch against:
        the job's own backend when its breaker is closed (or breakers
        are off), otherwise the first non-open backend DOWN the same
        Mesh → Torch → Serial order the FallbackChain walks.  A
        half-open breaker is probed with a warmup-shaped no-op first —
        probe success restores traffic (and closes the breaker), probe
        failure re-opens it and the walk continues down.  Serial is
        the floor: it has no device to lose and never carries a
        breaker.  A job on a CUDA device never lands there: with every
        device breaker on its route open it raises
        :class:`~mdanalysis_mpi_tpu_torch.service.jobs.
        BackendUnavailableError`."""
        if self.breakers is None or job.backend not in ROUTE_ORDER:
            return job.backend
        refused = []
        for backend in ROUTE_ORDER[ROUTE_ORDER.index(job.backend):]:
            if backend == "serial":
                break
            br = self.breakers.get(backend)
            st = br.state
            if st == _breaker.OPEN:
                refused.append(backend)
                continue
            if st == _breaker.HALF_OPEN:
                if not br.probe(lambda b=backend:
                                self._probe_backend(b, job)):
                    refused.append(backend)
                    continue
            return backend
        if refused and job_on_card(job):
            raise BackendUnavailableError(
                f"every device breaker on the route of this job is "
                f"open ({', '.join(repr(b) for b in refused)}); on a "
                "CUDA device the scheduler does not finish a job on "
                "the serial backend — resubmit after the breaker's "
                "cooldown", breakers=tuple(refused))
        return "serial"

    def _probe_backend(self, backend: str, job: AnalysisJob) -> None:
        """Half-open probe: a warmup-shaped no-op dispatch on the
        job's device — a small torch op, then a wait for the device —
        cheap, shape-stable, no tenant data at risk.  Raises on failure
        (the breaker re-opens); the ``probe`` fault site lets tests pin
        the failure deterministically."""
        import torch

        from mdanalysis_mpi_tpu_torch.device import resolve_device

        if _faults.plans():
            _faults.fire("probe")
        kw = job.executor_kwargs
        dev = kw.get("device") if job.backend == "torch" else None
        devs = kw.get("devices") if job.backend == "mesh" else None
        if devs is not None:
            dev = (devs if isinstance(devs, (str, torch.device))
                   else list(devs)[0])
        dev = resolve_device(dev)
        out = torch.zeros((8, 3), device=dev) + 1.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if float(out.sum()) != 24.0:
            raise RuntimeError(f"probe of {backend!r} on {dev} returned "
                               "a wrong sum")

    def _note_backend_result(self, backend: str,
                             exc: BaseException | None,
                             analyses=()) -> None:
        """Feed the breaker after a dispatched unit: any success
        resets it; a degradable (device-loss / exhausted-transient)
        failure counts toward the trip threshold.  Non-degradable
        failures (corrupt data, programming errors) don't — a breaker
        reroute would just replay them on the next backend down.

        ``analyses`` are the unit's member analyses, consulted on
        SUCCESS: a resilient run reports success even when its
        FallbackChain internally degraded off ``backend`` — that
        degradation IS the breaker signal, or resilient tenants would
        keep a dead backend's breaker closed forever while every job
        re-paid the full retry/degrade cost the breaker exists to
        eliminate."""
        if self.breakers is None or backend == "serial" \
                or backend not in ROUTE_ORDER:
            return
        br = self.breakers.get(backend)
        if exc is None:
            for a in analyses:
                rel = getattr(getattr(a, "results", None),
                              "reliability", None)
                fallbacks = (rel or {}).get("fallbacks", ())
                if any(frm == backend for frm, _to, _r in fallbacks):
                    br.record_failure()
                    return
            br.record_success()
            return
        from mdanalysis_mpi_tpu_torch.reliability.policy import is_degradable

        if is_degradable(exc):
            br.record_failure()

    # ---- execution ----

    def _run_unit(self, unit, token) -> bool:
        """Admit + execute one unit; False when it was deferred."""
        # honor MDTPU_TRACE_OUT BEFORE entering the trace context: the
        # context is a no-op while tracing is off, and waiting for the
        # run() inside to enable it would leave THIS unit's spans
        # without their job attribution
        obs.maybe_enable_from_env()
        if unit.handles[0].job.streaming is not None:
            # live tenants take their own serve path
            # (docs/STREAMING.md): run_streaming tails the feed, a
            # stall PARKS instead of failing, and the unit is always
            # solo (streaming never coalesces) — no cache admission
            # either: the envelope check at the submission door
            # already bounded the window's staged bytes
            self._run_streaming_unit(unit.handles[0], token)
            return True
        run_now, reserved = self._admit(unit)
        if not run_now:
            return False
        job = unit.handles[0].job
        try:
            backend = self._route_backend(job)
        except BackendUnavailableError as exc:
            # refused on the card: the unit never runs
            if reserved > 0:
                self.cache.release(reserved)
            for h in unit.handles:
                self._complete(h, token, exc=exc)
            return True
        # unit-shape counters recorded only for units that actually
        # RUN — a deferred unit comes back through here and must not
        # double-count its pass
        if unit.coalesced:
            self.telemetry.count("coalesce_batches")
        elif unit.solo_reason:
            self.telemetry.count(unit.solo_reason)
        if backend != job.backend:
            self.telemetry.count("breaker_reroutes", len(unit.handles))
            self._log.warning(
                "breaker open for %r: routing %d job(s) to %r",
                job.backend, len(unit.handles), backend)
        backend, mem_charged = self._mem_guarded_backend(
            backend, job, len(unit.handles))
        kwargs = dict(job.executor_kwargs)
        if reserved >= 0:
            kwargs["block_cache"] = self.cache
        if backend == "serial":
            # a breaker reroute or memory-guard shed landed a
            # batch-geometry job on the serial floor: serial streams
            # frame-at-a-time and refuses batch kwargs (cache,
            # transfer dtype, scan_k) — forwarding them would turn
            # the graceful route into a TypeError
            kwargs = {k: v for k, v in kwargs.items()
                      if k == "reliability"}
        for h in unit.handles:
            h._mark_running()
        # span attribution (docs/OBSERVABILITY.md): every member job's
        # id/tenant/trace id rides the serve_job span, and the thread
        # context stamps them onto every span the pass records below
        # (run, stage, dispatch, ...) — a merged pass's timeline
        # attributes to EVERY member, not just the claiming job
        attrs = dict(
            job_ids=[h.job_id for h in unit.handles],
            tenants=[h.job.tenant for h in unit.handles],
            trace_ids=[h.job.trace_id for h in unit.handles])
        # per-tenant metering (obs/usage.py): the pro-rata weights
        # ride the same thread context, so every downstream charge
        # site (staging, cache residency, store reads) splits a
        # merged pass's cost by member frame count
        weights = self._usage_weights(unit.handles)
        if obs.usage.LEDGER.enabled:
            attrs["usage_weights"] = weights
        merged_span = (obs.span("coalesced_pass",
                                n_jobs=len(unit.handles))
                       if unit.coalesced else contextlib.nullcontext())
        t_run = time.monotonic()
        try:
            with obs.trace_context(**attrs), \
                    TIMERS.phase("serve_job", coalesced=unit.coalesced), \
                    merged_span:
                unit.runnable.run(backend=backend,
                                  batch_size=job.batch_size,
                                  resilient=job.resilient,
                                  **job.window_kwargs(), **kwargs)
        except Exception as exc:
            # the failed pass's wall time was still consumed on these
            # tenants' behalf (frames charge only on success)
            self._charge_usage(weights, t_run)
            self._note_backend_result(backend, exc)
            if unit.coalesced:
                # one bad member must not fail the batch it merged
                # into: fall back to solo passes with per-job outcomes.
                # Requeue-style accounting (the satellite fix): each
                # member's wait clock restarts here, so the merged
                # pass's doomed run time isn't booked as queue wait.
                self.telemetry.count("coalesce_fallbacks")
                self._log.warning(
                    "coalesced pass of %d jobs failed (%s: %s); "
                    "re-running members solo", len(unit.handles),
                    type(exc).__name__, exc)
                # the failed pass's staged bytes are no longer in
                # flight: release its memory-guard charge BEFORE the
                # solo re-runs, or each retry would see the dead
                # unit's estimate still counted and shed to serial
                # against a guard that is not actually exceeded
                self._mem_release(mem_charged)
                mem_charged = 0
                for h in unit.handles:
                    h.requeued_t = self._clock()
                    self.telemetry.count("jobs_requeued")
                    obs.METRICS.inc("mdtpu_jobs_requeued_total")
                    self._run_solo(h, kwargs, token)
            else:
                for h in unit.handles:
                    self._complete(h, token, exc=exc)
        else:
            self._charge_usage(weights, t_run, frames=True)
            self._note_backend_result(
                backend, None,
                analyses=[h.job.analysis for h in unit.handles])
            for h in unit.handles:
                h.coalesced = unit.coalesced
                self._complete(h, token)
        finally:
            if reserved > 0:
                # the staged bytes are now accounted as cache entries
                # (or were rejected by the cache's own cap check);
                # either way the reservation's job is done
                self.cache.release(reserved)
            self._mem_release(mem_charged)
            if self.cache is not None:
                # staged-pressure high-water (docs/RELIABILITY.md §5):
                # refreshed after every served unit, once the unit's
                # reservations/inserts have moved the peak
                obs.METRICS.set_gauge("mdtpu_staged_bytes_peak",
                                      self.cache.bytes_peak)
            # keep a file-backed trace current after each served unit:
            # the serve_job span closes AFTER the inner run()'s own
            # export, so without this the file would always trail the
            # last unit's serving spans
            if obs.trace_path():
                obs.export_trace()
        return True

    def _mem_guarded_backend(self, backend: str, job: AnalysisJob,
                             n_handles: int = 1) -> tuple:
        """Memory watchdog (docs/RELIABILITY.md §5): reservation-aware
        backpressure BEFORE the allocator OOMs.  A batch-backend unit
        charges its estimated staged working set against
        ``mem_guard_bytes`` while it runs (cached or uncached — the
        bytes are resident either way); a unit whose charge would
        cross the guard runs SERIAL instead: frame-at-a-time, no block
        residency, slower but alive.  On a CUDA device no unit leaves
        the card: it waits until the in-flight charge drains enough
        for it, and a unit larger than the guard runs once nothing else
        is in flight.  Returns ``(backend, charged)``; release
        ``charged`` via :meth:`_mem_release` when the unit finishes.
        Mesh-only (ring-kernel) analyses cannot shed and run as asked —
        disclosed in the log."""
        if (self.mem_guard_bytes is None
                or backend not in DEVICE_BACKENDS):
            return backend, 0
        try:
            est = self._estimate_bytes(job)
        except Exception:
            return backend, 0
        on_card = job_on_card(job)
        waited = False
        with self._cond:
            while (on_card and self._staged_inflight
                   and self._staged_inflight + est > self.mem_guard_bytes
                   and not self._shutdown):
                if not waited:
                    waited = True
                    obs.span_event("admission_mem_wait",
                                   tenant=job.tenant, est_bytes=est)
                    self._log.warning(
                        "memory guard: holding %d job(s) (%s, ~%d MB "
                        "staged) until %d MB in flight drain below "
                        "the %d MB guard", n_handles,
                        type(job.analysis).__name__, est >> 20,
                        self._staged_inflight >> 20,
                        self.mem_guard_bytes >> 20)
                # the wait renews this worker's lease as a phase entry
                # would: holding is the scheduler's choice, not a hang
                self._sup.heartbeat("mem_guard_wait")
                self._cond.wait(0.05)
            if on_card or (self._staged_inflight + est
                           <= self.mem_guard_bytes):
                self._staged_inflight += est
                return backend, est
        if getattr(job.analysis, "_mesh_only", False):
            self._log.warning(
                "memory guard: %s would cross mem_guard_bytes but is "
                "mesh-only; running on %r anyway",
                type(job.analysis).__name__, backend)
            return backend, 0
        self.telemetry.count("admission_shed_serial", n_handles)
        obs.span_event("admission_shed_serial", tenant=job.tenant,
                       est_bytes=est)
        self._log.warning(
            "memory guard: shedding %d job(s) (%s, ~%d MB staged) to "
            "the serial backend — %d MB already in flight against a "
            "%d MB guard", n_handles, type(job.analysis).__name__,
            est >> 20, self._staged_inflight >> 20,
            self.mem_guard_bytes >> 20)
        return "serial", 0

    def _mem_release(self, charged: int) -> None:
        if charged:
            with self._cond:
                self._staged_inflight -= charged
                self._cond.notify_all()

    def _run_streaming_unit(self, handle: JobHandle, token) -> None:
        """Serve one live tenant (docs/STREAMING.md):
        ``run_streaming`` tails the job's follow-mode trajectory and
        emits partial snapshots until the feed seals.  A feed stall
        parks the job — back to queued, resume-gated — and is NEVER a
        supervision fault: a dry feed is the producer's pace, not
        poison.  A resumed claim re-enters the analysis's own
        checkpoint-shaped carry (``_stream_state``), so no frame is
        re-reduced."""
        from mdanalysis_mpi_tpu_torch.analysis.base import StreamFeedStalled

        job = handle.job
        try:
            backend = self._route_backend(job)
        except BackendUnavailableError as exc:
            self._complete(handle, token, exc=exc)
            return
        if backend != job.backend:
            self.telemetry.count("breaker_reroutes")
        kwargs = dict(job.executor_kwargs)
        if backend == "serial":
            # same batch-kwarg filter as _run_unit (breaker reroute
            # to the serial floor)
            kwargs = {k: v for k, v in kwargs.items()
                      if k == "reliability"}
        handle._mark_running()
        weights = [(job.tenant, job.qos, 0)]
        attrs = dict(job_ids=[handle.job_id], tenants=[job.tenant],
                     trace_ids=[job.trace_id])
        if obs.usage.LEDGER.enabled:
            attrs["usage_weights"] = weights
        t_run = time.monotonic()
        try:
            with obs.trace_context(**attrs), \
                    TIMERS.phase("serve_job", coalesced=False):
                job.analysis.run_streaming(
                    backend=backend, batch_size=job.batch_size,
                    **job.streaming, **kwargs)
        except StreamFeedStalled as exc:
            # not a backend verdict either: the device did its work;
            # the PRODUCER went quiet — the breaker stays untouched
            self._park_stalled(handle, token, exc)
        except Exception as exc:
            self._note_backend_result(backend, exc)
            self._complete(handle, token, exc=exc)
        else:
            self._note_backend_result(backend, None,
                                      analyses=[job.analysis])
            self._complete(handle, token)
        finally:
            # streaming attempts charge dispatch wall time however
            # they end (a parked stall still consumed the wall); frame
            # counts are open-ended, left to the stream counters
            self._charge_usage(weights, t_run)
        if obs.trace_path():
            obs.export_trace()       # same file-currency contract as
            #                          _run_unit

    def _park_stalled(self, handle: JobHandle, token, exc) -> bool:
        """Owner-guarded park of a stalled live tenant: back to the
        queue (state ``queued``), resume-gated
        ``stream_park_delay_s`` out.  Guarded like :meth:`_complete` —
        only the worker still owning the handle may park it, so a
        reaped zombie's late stall cannot double-queue the job.  The
        fault log and poison counter are deliberately untouched
        (ISSUE: a stall must not count toward quarantine)."""
        with self._cond:
            if handle._owner is not token or handle.done():
                return False
            handle._owner = None
            self._sup.drop_handle(handle)
            handle.state = JobState.QUEUED
            # the resumed pass re-enters this analysis's own carry;
            # peers must never merge into it
            handle._solo_only = True
            now = self._clock()
            handle._resume_at = now + self.qos.stream_park_delay_s
            # wait clock restarts at the park (the requeue-accounting
            # contract): the stalled attempt's run time is not queue
            # wait, and the queue deadline measures from here
            handle.requeued_t = now
            self._queue.append((-handle.job.priority,
                                next(self._seq), handle))
            self.telemetry.note_requeue()
            self._cond.notify_all()
        self._note_stream_park(
            handle, "stall", frames_done=exc.frames_done,
            waited_s=round(exc.waited_s, 3))
        return True

    def _run_solo(self, handle: JobHandle, kwargs: dict,
                  token) -> None:
        job = handle.job
        obs.maybe_enable_from_env()      # same contract as _run_unit
        try:
            backend = self._route_backend(job)
        except BackendUnavailableError as exc:
            self._complete(handle, token, exc=exc)
            return
        if backend != job.backend:
            self.telemetry.count("breaker_reroutes")
        backend, mem_charged = self._mem_guarded_backend(backend, job)
        if backend == "serial":
            # same batch-kwarg filter as _run_unit (breaker reroute /
            # memory-guard shed to the serial floor)
            kwargs = {k: v for k, v in kwargs.items()
                      if k == "reliability"}
        handle._mark_running()
        weights = self._usage_weights([handle])
        attrs = dict(job_ids=[handle.job_id], tenants=[job.tenant],
                     trace_ids=[job.trace_id])
        if obs.usage.LEDGER.enabled:
            attrs["usage_weights"] = weights
        t_run = time.monotonic()
        try:
            with obs.trace_context(**attrs), \
                    TIMERS.phase("serve_job", coalesced=False):
                job.analysis.run(backend=backend,
                                 batch_size=job.batch_size,
                                 resilient=job.resilient,
                                 **job.window_kwargs(), **kwargs)
        except Exception as exc:
            self._charge_usage(weights, t_run)
            self._note_backend_result(backend, exc)
            self._complete(handle, token, exc=exc)
        else:
            self._charge_usage(weights, t_run, frames=True)
            self._note_backend_result(backend, None,
                                      analyses=[job.analysis])
            self._complete(handle, token)
        finally:
            self._mem_release(mem_charged)
        if obs.trace_path():
            obs.export_trace()       # same file-currency contract as
            #                          _run_unit
