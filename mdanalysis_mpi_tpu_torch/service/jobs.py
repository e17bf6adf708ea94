"""Job model for the serving layer.

An :class:`AnalysisJob` is one tenant's request: a constructed (not yet
run) analysis, the frame window to run it over, the backend and batch
geometry, and the serving knobs (priority, queue deadline, reliability
policy, coalescing opt-out).  Submitting one to a
:class:`~mdanalysis_mpi_tpu_torch.service.scheduler.Scheduler` returns a
:class:`JobHandle` — a thread-safe future carrying the job's state
machine (PENDING → QUEUED → RUNNING → DONE/FAILED/EXPIRED) and the
queue-wait/latency timestamps serving telemetry aggregates.

Ownership contract: each job owns its analysis INSTANCE (results land
on ``job.analysis.results``, exactly as a direct ``run()`` would leave
them) — submitting one instance under two jobs would race their
results.  Jobs that should coalesce must be built on a SHARED
Universe/trajectory object: coalescing merges by trajectory identity
(the same contract as
:class:`~mdanalysis_mpi_tpu_torch.analysis.base.AnalysisCollection`).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time


class JobState:
    """String states (npz/JSON-friendly; no enum dependency)."""

    PENDING = "pending"        # constructed, not yet submitted
    QUEUED = "queued"          # in the scheduler's priority queue
    RUNNING = "running"        # a worker is executing it (possibly
    #                            as part of a coalesced pass)
    DONE = "done"
    FAILED = "failed"
    EXPIRED = "expired"        # queue deadline passed before a worker
    #                            picked it up
    QUARANTINED = "quarantined"  # poisoned the workers that claimed it
    #                              (lease expiries / worker deaths) too
    #                              many times — parked with diagnostics
    ABORTED = "aborted"        # scheduler shut down / drained before a
    #                            worker could claim it
    SHED = "shed"              # dropped by the overload controller
    #                            (lowest QoS class first — policy, not
    #                            accident; docs/RELIABILITY.md §7)


class JobDeadlineExpired(RuntimeError):
    """The job's ``deadline_s`` elapsed while it was still queued."""


class JobShedError(RuntimeError):
    """The overload controller dropped this job (state ``shed``):
    queue depth outran capacity while every worker/host was saturated,
    and this job's QoS class is in the configured shed set
    (docs/RELIABILITY.md §7 "Overload and elasticity").  Degradation
    under overload is POLICY, not accident: the shed is typed here,
    journaled as a terminal record, and counted
    ``mdtpu_jobs_shed_total{class=}`` — a caller that sees this error
    may resubmit once the burst passes (a ``--journal`` restart
    re-runs shed jobs; they are not settled)."""

    def __init__(self, message, qos: str = "background"):
        super().__init__(message)
        self.qos = qos


class AdmissionRejectedError(RuntimeError):
    """``submit()`` refused this job at the door (docs/RELIABILITY.md
    §7 "Backpressure contract"): the queue bound, the tenant's rate
    limit, inflight quota, or dispatch-seconds budget would be
    exceeded.  The job was NEVER queued — no handle state, no journal
    record, no namespace pin — so the caller can retry/back off
    without cleanup.  ``reason`` is one of ``queue_full`` /
    ``rate_limit`` / ``tenant_quota`` / ``budget`` /
    ``stream_envelope`` (the
    ``mdtpu_admission_rejects_total{reason=}`` label)."""

    def __init__(self, message, reason: str):
        super().__init__(message)
        self.reason = reason


class JobRuntimeExceeded(RuntimeError):
    """The job outran its lease-renewal/runtime cap
    (``QosPolicy.max_lease_renewals`` / ``max_runtime_s``,
    docs/RELIABILITY.md §7): a run that keeps renewing its lease via
    phase-entry heartbeats would otherwise pin its worker — and, on a
    fleet, its host and cache — forever.  Past the cap the lease stops
    renewing, the supervisor reaps it, the wedged worker is fenced and
    written off, and the job fails HERE instead of being requeued
    (re-running a runaway is the same runaway)."""


class SchedulerShutdownError(RuntimeError):
    """The scheduler shut down (or aborted) with this job still
    queued: the job will never run.  Raised from ``handle.result()``
    so callers blocked on a future don't hang forever on a
    ``shutdown(wait=False)`` or a drained SIGTERM."""


class BackendUnavailableError(RuntimeError):
    """Every device breaker on a CUDA job's route is open, and the
    scheduler does not finish a job bound for the card on the serial
    backend (the degradation chain's own rule on a CUDA device: Mesh →
    Torch, then stop).  ``breakers`` names the open breakers.  Not
    degradable: a resilient run does not demote on it, and it does not
    feed a breaker.  The caller may resubmit after the cooldown."""

    def __init__(self, message, breakers: tuple = ()):
        super().__init__(message)
        self.breakers = tuple(breakers)


class JobQuarantinedError(RuntimeError):
    """The job was quarantined: its lease expired or its worker died
    ``poison_threshold`` times, so the scheduler stopped retrying it
    (one poison tenant must not monopolize workers forever).

    ``diagnostics`` carries what the supervisor captured at each
    incident: reason (lease_expired / worker_death), worker name,
    lease TTL, the fault-site error + traceback when the worker died
    by exception, and the job's last span-trace events when tracing
    was enabled (docs/RELIABILITY.md, "Serving supervision").
    """

    def __init__(self, message, diagnostics: dict | None = None):
        super().__init__(message)
        self.diagnostics = diagnostics or {}


@dataclasses.dataclass
class AnalysisJob:
    """One tenant's analysis request.

    ``analysis``
        A constructed :class:`~mdanalysis_mpi_tpu_torch.analysis.base.
        AnalysisBase` instance (NOT yet run).  Results fan out to
        ``analysis.results`` when the job completes.
    ``start``/``stop``/``step``/``frames``
        The frame window, exactly as ``run()`` takes it.  Part of the
        coalesce key: only jobs over the SAME window merge into one
        staged pass.
    ``backend`` / ``batch_size`` / ``executor_kwargs``
        Execution geometry, as ``run()`` takes it.  Also part of the
        coalesce key.  ``backend=None`` (the default) takes the
        analysis' own ``_default_backend``, as ``run()`` does:
        ``"torch"`` — on ``cuda`` unless ``executor_kwargs`` names
        another ``device`` — and ``"serial"`` for the serial-only
        analyses, so a served job runs on the card unless the caller
        asks for the CPU.
    ``qos``
        Tenant QoS class — ``"interactive"`` / ``"batch"`` (default) /
        ``"streaming"`` / ``"background"``
        (:data:`~mdanalysis_mpi_tpu_torch.service.qos.QOS_CLASSES`).  Claim ordering is weighted-fair ACROSS classes
        (stride scheduling over ``QosPolicy.weights`` — no class with
        queued work starves); under overload the shed ladder drops the
        lowest sheddable class first and never touches classes outside
        it (docs/RELIABILITY.md §7).  Deliberately NOT part of the
        coalesce key: two tenants asking the same question at
        different urgencies still share one staged pass (the pass runs
        at the earliest claim among them).
    ``priority``
        Higher runs earlier *within a QoS class*; ties break FIFO
        (submission order).
    ``deadline_s``
        Soft QUEUE deadline in seconds from submission: a job still
        queued when it expires fails with :class:`JobDeadlineExpired`
        instead of running (the tenant has given up; running it would
        burn capacity on an unwanted answer).  Per-op deadlines INSIDE
        a run come from ``resilient`` (ReliabilityPolicy
        .stage_deadline_s), not from this knob.
    ``resilient``
        ``False`` | ``True`` | a :class:`~mdanalysis_mpi_tpu_torch.
        reliability.ReliabilityPolicy` — per-job fault tolerance,
        forwarded to ``run(resilient=...)``: retry/backoff, corrupt-
        frame salvage, and Mesh→Torch→Serial degradation (Mesh→Torch
        on a CUDA device) that demotes
        the executor for THIS job only (each run builds its own
        fallback chain; the process and other tenants keep their
        backends).  Part of the coalesce key — jobs merge only with
        identical policies, so one tenant's retry budget is never
        silently applied to another's pass.
    ``streaming``
        ``None`` (default) — a normal bounded run.  A dict makes this
        a LIVE job (docs/STREAMING.md): the worker calls
        ``analysis.run_streaming(**streaming)`` instead of ``run()``,
        tailing the job's trajectory (a follow-mode
        :class:`~mdanalysis_mpi_tpu_torch.io.store.reader.StoreReader`) and
        emitting partial snapshots until the feed seals.  Keys are
        ``run_streaming``'s keywords (``window``, ``stall_timeout_s``,
        ``snapshot_cb``, ...).  Streaming jobs default their class to
        ``"streaming"`` and never coalesce — a live pass has no fixed
        window to merge on.  A feed stall PARKS the job (state back to
        queued, resumed after ``QosPolicy.stream_park_delay_s``) and
        is never a supervision fault.
    ``coalesce``
        ``False`` opts this job out of request coalescing (always a
        solo pass).
    ``tenant``
        Opaque label for telemetry/log attribution.
    ``trace_id``
        Opaque span-trace correlation id (docs/OBSERVABILITY.md).
        None → the scheduler derives one from the job id at submission.
        Propagated through the coalesced pass: every span a merged
        pass records carries the trace ids of ALL member jobs, so a
        shared timeline attributes to each tenant.  Deliberately NOT
        part of the coalesce key — two requests must not fail to merge
        because their trace ids differ.
    ``fingerprint``
        Stable identity for the crash-consistent journal
        (docs/RELIABILITY.md): recovery matches a resubmitted job to
        its journal records by this string, so it must be reproducible
        across process restarts (the ``batch --journal`` CLI derives
        it from the job's SPEC + position in the file).  None → the
        scheduler derives one from the job's window/backend/tenant
        plus a per-scheduler occurrence counter (stable only when jobs
        are resubmitted in the same order).  Not part of the coalesce
        key.
    """

    analysis: object
    start: int | None = None
    stop: int | None = None
    step: int | None = None
    frames: object = None
    backend: str | None = None
    batch_size: int | None = None
    executor_kwargs: dict = dataclasses.field(default_factory=dict)
    qos: str | None = None
    priority: int = 0
    deadline_s: float | None = None
    resilient: object = False
    streaming: dict | None = None
    coalesce: bool = True
    tenant: str = "default"
    trace_id: str | None = None
    fingerprint: str | None = None

    def __post_init__(self):
        from mdanalysis_mpi_tpu_torch.reliability.policy import (
            ReliabilityPolicy,
        )

        # normalize the bool-or-policy knob at CONSTRUCTION: a truthy
        # non-policy value (resilient=1 — a natural mistake) would
        # otherwise survive until the worker computes the coalesce key
        # (dataclasses.astuple crash) and kill the claim
        if not isinstance(self.resilient, ReliabilityPolicy):
            self.resilient = bool(self.resilient)
        if self.backend is None:
            self.backend = getattr(self.analysis, "_default_backend",
                                   "torch")
        if self.streaming is not None:
            self.streaming = dict(self.streaming)
            # a live pass has no fixed window to merge on, and its
            # snapshot cadence is per-tenant state — never coalesce
            self.coalesce = False
            if self.qos is None:
                self.qos = "streaming"
        # a typo'd class must fail the CONSTRUCTION, not silently ride
        # the default weights until the shed ledger is audited
        from mdanalysis_mpi_tpu_torch.service.qos import validate_qos

        self.qos = validate_qos(self.qos)

    def window_kwargs(self) -> dict:
        return dict(start=self.start, stop=self.stop, step=self.step,
                    frames=self.frames)

    @property
    def trajectory(self):
        return self.analysis._universe.trajectory

    def _resilient_key(self):
        """Hashable image of the reliability spec for the coalesce
        key (policies are dataclasses of scalars)."""
        if not self.resilient:
            return None
        if self.resilient is True:
            return True
        return dataclasses.astuple(self.resilient)

    def coalesce_key(self):
        """Jobs with EQUAL keys may merge into one staged pass."""
        frames = self.frames
        if frames is not None:
            frames = tuple(int(f) for f in frames)
        # list values (the mesh's ``devices``) key as tuples
        kwargs = tuple((k, tuple(v) if isinstance(v, list) else v)
                       for k, v in sorted(self.executor_kwargs.items(),
                                          key=lambda kv: kv[0]))
        return (id(self.trajectory), self.start, self.stop, self.step,
                frames, self.backend, self.batch_size, kwargs,
                self._resilient_key())


_job_ids = itertools.count(1)


class JobHandle:
    """Thread-safe future for one submitted job.

    ``result(timeout)`` blocks until the job finishes and returns the
    job's (run) analysis — or raises the job's failure.  Timestamps
    (``submitted_t`` / ``started_t`` / ``finished_t``) feed the
    queue-wait and latency percentiles in serving telemetry.
    """

    def __init__(self, job: AnalysisJob):
        self.job = job
        self.job_id = next(_job_ids)
        self.state = JobState.PENDING
        self.error: BaseException | None = None
        #: True when the job ran as part of a merged (≥2-member)
        #: coalesced pass — the telemetry coalesce-rate numerator
        self.coalesced = False
        self.submitted_t: float | None = None
        self.started_t: float | None = None
        self.finished_t: float | None = None
        #: last supervision requeue (lease reap / worker death), None
        #: until one happens — queue_wait_s measures from here so a
        #: requeued job's wait reflects ITS wait, not the dead
        #: attempt's run time (that skew is the requeue satellite fix)
        self.requeued_t: float | None = None
        self._done = threading.Event()
        # scheduler bookkeeping: admission deferral count (see
        # Scheduler._pop_admissible)
        self._deferrals = 0
        # supervision incidents (lease expiries / worker deaths) — at
        # poison_threshold the job is quarantined with this log
        self._faults = 0
        self._fault_log: list[dict] = []
        # ownership token of the worker currently running this handle
        # (the lease's token) — a reaped worker's late completion
        # finds it changed/cleared and is discarded
        self._owner = None
        # a supervision requeue claims this handle ALONE from then on:
        # its batch already sank one worker, so its coalesced peers
        # must not ride (or be sunk by) it again
        self._solo_only = False
        # park gate (streaming, docs/STREAMING.md): a stalled/shed
        # live job goes back to queued with this set in the future —
        # the claim path skips it until the clock passes it, so a
        # parked tenant resumes instead of hot-spinning on a dry feed
        self._resume_at = 0.0
        #: True once scheduler-driven prefetch staged this job's
        #: blocks into the shared cache (docs/COLDSTART.md)
        self.prefetched = False
        # prefetch in progress: the claim path skips held handles so
        # the staging completes before the job is claimed
        self._prefetch_hold = False
        # completion callbacks, fired on the resolving worker thread
        # BEFORE the scheduler's journal "finish" record lands — so a
        # callback that persists the job's results (the batch CLI's
        # per-job .npz) is on disk before the journal says "done" and
        # a crash between the two re-runs the job instead of losing
        # its output (docs/RELIABILITY.md, "Serving supervision")
        self._callbacks: list = []

    # ---- lifecycle (called by the scheduler) ----

    def add_done_callback(self, fn) -> None:
        """Call ``fn(handle)`` when the job reaches a terminal state
        (immediately if it already has).  Runs on the resolving
        thread — a worker for normal outcomes, the supervisor for
        quarantines; exceptions are logged and swallowed — a failing
        callback must not corrupt the scheduler's accounting."""
        self._callbacks.append(fn)
        if self._done.is_set():
            self._fire_callbacks()

    def _fire_callbacks(self) -> None:
        while True:
            try:
                # pop-then-run, no check-then-pop: add_done_callback
                # on an already-done handle fires concurrently with
                # the resolving worker, and two threads passing the
                # same truthiness check would race for the last
                # element (list.pop itself is atomic)
                fn = self._callbacks.pop(0)
            except IndexError:
                return
            try:
                fn(self)
            except Exception:
                from mdanalysis_mpi_tpu_torch.utils.log import get_logger

                get_logger("mdtpu.service").warning(
                    "job %d done-callback failed", self.job_id,
                    exc_info=True)

    def _mark_queued(self) -> None:
        self.state = JobState.QUEUED
        self.submitted_t = time.monotonic()

    def _mark_running(self) -> None:
        self.state = JobState.RUNNING
        self.started_t = time.monotonic()

    def _mark_done(self) -> None:
        self.state = JobState.DONE
        self.finished_t = time.monotonic()
        self._done.set()
        self._fire_callbacks()

    def _mark_failed(self, exc: BaseException,
                     state: str = JobState.FAILED) -> None:
        self.error = exc
        self.state = state
        self.finished_t = time.monotonic()
        self._done.set()
        self._fire_callbacks()

    @property
    def deadline_expired(self) -> bool:
        # a supervision-requeued job measures from its LAST requeue,
        # same start as queue_wait_s: the first attempt DID get
        # claimed in time, and booking the dead attempt's run time
        # against the queue deadline would fail the retry instantly
        # with a message claiming it never left the queue
        start = (self.requeued_t if self.requeued_t is not None
                 else self.submitted_t)
        return (self.job.deadline_s is not None
                and start is not None
                and time.monotonic() - start > self.job.deadline_s)

    # ---- caller surface ----

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None):
        """The finished analysis (``.results`` populated), or raise the
        job's failure; TimeoutError if still running after ``timeout``."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} still {self.state} after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.job.analysis

    @property
    def queue_wait_s(self) -> float | None:
        """Seconds spent queued before the (most recent) claim.  A
        requeued job measures from its LAST requeue, not its original
        submission — otherwise the dead attempt's run time would be
        booked as queue wait and skew the serving p50/p99."""
        start = (self.requeued_t if self.requeued_t is not None
                 else self.submitted_t)
        if start is None or self.started_t is None:
            return None
        return self.started_t - start

    @property
    def latency_s(self) -> float | None:
        if self.submitted_t is None or self.finished_t is None:
            return None
        return self.finished_t - self.submitted_t

    def __repr__(self):
        return (f"<JobHandle #{self.job_id} "
                f"{type(self.job.analysis).__name__} "
                f"tenant={self.job.tenant!r} {self.state}>")
