"""Serving telemetry: what the multi-tenant layer actually did.

One :class:`ServiceTelemetry` per scheduler accumulates counters
(submissions, completions, coalesce outcomes, admission decisions) and
latency samples (queue wait, end-to-end job latency), and renders them
as a flat JSON-friendly dict — the schema the bench serving leg embeds
in the round artifact and ``tests/test_bench_contract.py`` pins.

Everything here is lock-guarded: scheduler workers record concurrently
and lost counter updates would make the reported rates lie.  Wall-clock
phase time stays in :mod:`mdanalysis_mpi_tpu_torch.utils.timers` (the
per-run decomposition); this module owns the per-JOB distributions a
serving operator reads (p50/p99, rates), and mirrors its snapshots
through :func:`mdanalysis_mpi_tpu_torch.utils.log.log_event` for the
JSON-lines event stream.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque

import numpy as np

#: Sliding window for the latency/queue-wait percentile samples: a
#: serving process runs indefinitely, so unbounded per-job appends
#: would grow memory (and every snapshot's np.percentile cost) linearly
#: with uptime.  p50/p99 over the most recent N jobs is what a serving
#: operator wants anyway.
MAX_SAMPLES = 4096


def percentile(samples, q: float) -> float | None:
    """``np.percentile`` with an empty-sample guard (None, not NaN:
    the snapshot must stay JSON-serializable)."""
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


class ServiceTelemetry:
    """Counters + latency distributions for one scheduler.

    ``slo_targets_s`` maps QoS class → latency-SLO target in seconds
    (None = untargeted); the scheduler wires its
    :class:`~mdanalysis_mpi_tpu_torch.service.qos.QosPolicy` targets in so
    the per-class attainment this object reports (and mirrors as
    ``mdtpu_slo_attainment{class=}``) is measured against the policy
    the operator actually configured."""

    def __init__(self, slo_targets_s: dict | None = None):
        from mdanalysis_mpi_tpu_torch.service.qos import DEFAULT_SLO_TARGETS_S

        self.slo_targets_s = dict(DEFAULT_SLO_TARGETS_S)
        if slo_targets_s:
            self.slo_targets_s.update(slo_targets_s)
        self._lock = threading.Lock()
        # job lifecycle
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.expired = 0
        # queue gauge
        self.queue_depth = 0
        self.queue_depth_peak = 0
        # coalescing
        self.coalesced_jobs = 0        # jobs that ran in a ≥2-member pass
        self.coalesce_batches = 0      # merged passes executed
        self.solo_jobs = 0             # jobs that ran as their own pass
        self.uncoalescable_jobs = 0    # solo because typed-error routed
        self.coalesce_fallbacks = 0    # merged pass failed → members re-run solo
        # cache admission
        self.admission_reserved = 0    # jobs admitted with a reservation
        self.admission_resident = 0    # admitted riding resident entries
        self.admission_deferrals = 0   # admissible-later jobs passed over
        self.admission_uncached = 0    # jobs run without the shared cache
        self.admission_evictions = 0   # evict_unpinned entries reclaimed
        self.admission_shed_serial = 0  # memory-guard sheds to serial
        #                                 (docs/RELIABILITY.md §5)
        # scheduler-driven prefetch (docs/COLDSTART.md)
        self.prefetch_jobs = 0         # queued jobs whose blocks staged
        self.prefetch_blocks = 0       # blocks staged ahead of claim
        self.prefetch_skipped = 0      # skipped by admission/budget
        self.prefetch_skipped_shed = 0  # skipped because the overload
        #                                 controller is about to shed
        #                                 the job (docs/RELIABILITY.md
        #                                 §7 — staging a doomed job
        #                                 wastes the wire AND parks a
        #                                 never-hit cache entry)
        # serving supervision (docs/RELIABILITY.md)
        self.quarantined = 0           # jobs parked with diagnostics
        self.aborted = 0               # failed by shutdown/signal drain
        self.lease_expired = 0         # leases reaped (TTL or death)
        self.jobs_requeued = 0         # supervision requeues (reap or
        #                                merged-pass fallback)
        self.breaker_reroutes = 0      # units routed off a tripped
        #                                backend
        self.workers_respawned = 0     # dead worker threads replaced
        # QoS + overload (docs/RELIABILITY.md §7)
        self.jobs_shed = 0             # dropped by the shed ladder
        self.admission_rejects = 0     # typed submit() refusals
        #                                (queue_full/rate_limit/quota)
        # distributions (seconds), bounded — see MAX_SAMPLES
        self.queue_wait_samples: deque = deque(maxlen=MAX_SAMPLES)
        self.latency_samples: deque = deque(maxlen=MAX_SAMPLES)
        # per-QoS-class accounting (the satellite fix: one
        # undifferentiated pool hid which CLASS was expiring/waiting):
        # class -> {counters, bounded sample deques}
        self._by_class: dict[str, dict] = {}

    def _class_locked(self, qos: str) -> dict:
        st = self._by_class.get(qos)
        if st is None:
            st = {"completed": 0, "failed": 0, "expired": 0,
                  "shed": 0, "slo_met": 0,
                  "queue_wait": deque(maxlen=MAX_SAMPLES),
                  "latency": deque(maxlen=MAX_SAMPLES)}
            self._by_class[qos] = st
        return st

    # ---- recording (scheduler-facing) ----

    def note_submit(self) -> None:
        with self._lock:
            self.submitted += 1
            self.queue_depth += 1
            self.queue_depth_peak = max(self.queue_depth_peak,
                                        self.queue_depth)

    def note_dequeue(self) -> None:
        with self._lock:
            self.queue_depth -= 1

    def note_requeue(self) -> None:
        """An admission deferral put a claimed handle back in the
        queue: the depth gauge recovers WITHOUT counting a new
        submission."""
        with self._lock:
            self.queue_depth += 1
            self.queue_depth_peak = max(self.queue_depth_peak,
                                        self.queue_depth)

    def note_finish(self, handle) -> None:
        """Record a finished handle (any terminal state) with its
        timing samples."""
        from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS
        from mdanalysis_mpi_tpu_torch.service.jobs import JobState

        qos = getattr(handle.job, "qos", "batch")
        slo_target = self.slo_targets_s.get(qos)
        slo_attainment = None
        with self._lock:
            cls = self._class_locked(qos)
            if handle.state == JobState.DONE:
                self.completed += 1
                cls["completed"] += 1
                if handle.coalesced:
                    self.coalesced_jobs += 1
                # attainment only exists for a class WITH a target: an
                # untargeted class reporting 1.0 would be
                # indistinguishable from a class genuinely meeting one
                if slo_target is not None:
                    if (handle.latency_s is not None
                            and handle.latency_s <= slo_target):
                        cls["slo_met"] += 1
                    slo_attainment = cls["slo_met"] / cls["completed"]
            elif handle.state == JobState.EXPIRED:
                self.expired += 1
                cls["expired"] += 1
            elif handle.state == JobState.QUARANTINED:
                self.quarantined += 1
                cls["failed"] += 1
            elif handle.state == JobState.ABORTED:
                self.aborted += 1
                cls["failed"] += 1
            elif handle.state == JobState.SHED:
                self.jobs_shed += 1
                cls["shed"] += 1
            else:
                self.failed += 1
                cls["failed"] += 1
            if handle.queue_wait_s is not None:
                self.queue_wait_samples.append(handle.queue_wait_s)
                cls["queue_wait"].append(handle.queue_wait_s)
            if handle.latency_s is not None:
                self.latency_samples.append(handle.latency_s)
                cls["latency"].append(handle.latency_s)
        if slo_attainment is not None:
            # per-class SLO attainment, live for /metrics scrapes —
            # what fraction of this class's completed jobs met the
            # configured latency target (docs/RELIABILITY.md §7)
            METRICS.set_gauge("mdtpu_slo_attainment",
                              round(slo_attainment, 4),
                              **{"class": qos})
        # fixed-bucket histograms in the process-global metrics
        # registry (docs/OBSERVABILITY.md): unlike the bounded
        # percentile deques above, these see EVERY job for the life of
        # the process — the long-horizon serving distribution
        # observed under the finishing job's trace context so each
        # latency bucket remembers this job's trace id as its exemplar
        # (obs/metrics.py; note_finish runs after the serving context
        # exited, so the id is re-applied here)
        from mdanalysis_mpi_tpu_torch.obs import spans as _spans
        tid = getattr(handle.job, "trace_id", None)
        with _spans.context(trace_id=tid) if tid \
                else contextlib.nullcontext():
            if handle.queue_wait_s is not None:
                METRICS.observe("mdtpu_queue_wait_seconds",
                                handle.queue_wait_s)
            if handle.latency_s is not None:
                METRICS.observe("mdtpu_job_latency_seconds",
                                handle.latency_s)

    def count(self, counter: str, n: int = 1) -> None:
        """Increment a named counter (the scheduler's single entry
        point for coalesce/admission bookkeeping)."""
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    # ---- reading ----

    def snapshot(self, cache=None) -> dict:
        """Flat JSON-friendly dict of everything above, plus the shared
        cache's hit/eviction view when one is attached (the
        ``serving_*`` fields of the bench artifact)."""
        with self._lock:
            out = {
                "jobs_submitted": self.submitted,
                "jobs_completed": self.completed,
                "jobs_failed": self.failed,
                "jobs_expired": self.expired,
                "queue_depth": self.queue_depth,
                "queue_depth_peak": self.queue_depth_peak,
                "coalesced_jobs": self.coalesced_jobs,
                "coalesce_batches": self.coalesce_batches,
                "solo_jobs": self.solo_jobs,
                "uncoalescable_jobs": self.uncoalescable_jobs,
                "coalesce_fallbacks": self.coalesce_fallbacks,
                "admission_reserved": self.admission_reserved,
                "admission_resident": self.admission_resident,
                "admission_deferrals": self.admission_deferrals,
                "admission_uncached": self.admission_uncached,
                "admission_evictions": self.admission_evictions,
                "admission_shed_serial": self.admission_shed_serial,
                "prefetch_jobs": self.prefetch_jobs,
                "prefetch_blocks": self.prefetch_blocks,
                "prefetch_skipped": self.prefetch_skipped,
                "prefetch_skipped_shed": self.prefetch_skipped_shed,
                "jobs_quarantined": self.quarantined,
                "jobs_aborted": self.aborted,
                "jobs_shed": self.jobs_shed,
                "admission_rejects": self.admission_rejects,
                "lease_expired": self.lease_expired,
                "jobs_requeued": self.jobs_requeued,
                "breaker_reroutes": self.breaker_reroutes,
                "workers_respawned": self.workers_respawned,
                "p50_queue_wait_s": percentile(self.queue_wait_samples, 50),
                "p99_queue_wait_s": percentile(self.queue_wait_samples, 99),
                "p50_latency_s": percentile(self.latency_samples, 50),
                "p99_latency_s": percentile(self.latency_samples, 99),
            }
            done = self.completed
            out["coalesce_rate"] = (round(self.coalesced_jobs / done, 4)
                                    if done else None)
            # per-QoS-class breakdown (docs/RELIABILITY.md §7): the
            # deadline/queue-wait/latency view an operator needs to
            # see WHICH class is missing its SLO, not one pooled p99
            out["qos"] = {
                qos: {
                    "completed": cls["completed"],
                    "failed": cls["failed"],
                    "expired": cls["expired"],
                    "shed": cls["shed"],
                    "slo_target_s": self.slo_targets_s.get(qos),
                    "slo_attainment": (
                        round(cls["slo_met"] / cls["completed"], 4)
                        if cls["completed"]
                        and self.slo_targets_s.get(qos) is not None
                        else None),
                    "p50_queue_wait_s": percentile(cls["queue_wait"],
                                                   50),
                    "p99_queue_wait_s": percentile(cls["queue_wait"],
                                                   99),
                    "p50_latency_s": percentile(cls["latency"], 50),
                    "p99_latency_s": percentile(cls["latency"], 99),
                }
                for qos, cls in sorted(self._by_class.items())}
        if cache is not None:
            lookups = cache.hits + cache.misses
            out["cache_hits"] = cache.hits
            out["cache_misses"] = cache.misses
            out["cache_hit_rate"] = (round(cache.hits / lookups, 4)
                                     if lookups else None)
            out["cache_bytes"] = cache._bytes
            out["cache_max_bytes"] = cache.max_bytes
        else:
            out["cache_hit_rate"] = None
        return out

    def log(self, cache=None, **extra) -> None:
        """Emit the snapshot as a structured ``serving`` event
        (JSON-lines under ``MDTPU_LOG_JSON=1``; INFO otherwise)."""
        from mdanalysis_mpi_tpu_torch.utils.log import log_event

        log_event("serving", **{**self.snapshot(cache=cache), **extra})


class FleetTelemetry:
    """Controller-tier counters (docs/RELIABILITY.md §6): host
    membership, host-loss migration, epoch fencing, and the sticky-
    routing residency outcome.  One per
    :class:`~mdanalysis_mpi_tpu_torch.service.fleet.FleetController`; the
    controller mirrors the load-bearing series into the process-global
    metrics registry (``mdtpu_hosts_alive`` & co) at each incident
    site — this object is the flat JSON view the fleet bench leg and
    the ``fleet`` CLI embed."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hosts_joined = 0          # hello handshakes accepted
        self.hosts_lost = 0            # leases expired / sockets EOFed
        self.hosts_rejoined = 0        # lost hosts that came back
        self.jobs_submitted = 0
        self.jobs_completed = 0
        self.jobs_failed = 0
        self.jobs_migrated = 0         # in-flight jobs requeued off a
        #                                lost host onto survivors
        self.epoch_fenced_rejects = 0  # stale-epoch/stale-assignment
        #                                commands + completions refused
        self.home_hits = 0             # jobs that found their tenant's
        #                                state resident on the home host
        self.home_misses = 0           # jobs that had to build it
        # elasticity + overload (docs/RELIABILITY.md §7)
        self.hosts_scaled_up = 0       # hosts spawned by the autoscaler
        self.hosts_scaled_down = 0     # hosts drain-retired by it
        self.jobs_shed = 0             # pending jobs dropped by the
        #                                controller's shed ladder
        self.admission_rejects = 0     # typed submit() refusals
        #                                (tenant logical-job quota)
        # ensemble scale-out (docs/ENSEMBLE.md)
        self.ensembles_submitted = 0   # ensemble parents accepted
        self.ensemble_members = 0      # member children fanned out
        self.ensemble_members_completed = 0
        self.ensemble_members_failed = 0
        self.ensemble_merges = 0       # cross-trajectory reductions

    def count(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "hosts_joined": self.hosts_joined,
                "hosts_lost": self.hosts_lost,
                "hosts_rejoined": self.hosts_rejoined,
                "jobs_submitted": self.jobs_submitted,
                "jobs_completed": self.jobs_completed,
                "jobs_failed": self.jobs_failed,
                "jobs_migrated": self.jobs_migrated,
                "epoch_fenced_rejects": self.epoch_fenced_rejects,
                "home_hits": self.home_hits,
                "home_misses": self.home_misses,
                "hosts_scaled_up": self.hosts_scaled_up,
                "hosts_scaled_down": self.hosts_scaled_down,
                "jobs_shed": self.jobs_shed,
                "admission_rejects": self.admission_rejects,
                "ensembles_submitted": self.ensembles_submitted,
                "ensemble_members": self.ensemble_members,
                "ensemble_members_completed":
                    self.ensemble_members_completed,
                "ensemble_members_failed":
                    self.ensemble_members_failed,
                "ensemble_merges": self.ensemble_merges,
            }
        lookups = out["home_hits"] + out["home_misses"]
        out["home_hit_rate"] = (round(out["home_hits"] / lookups, 4)
                                if lookups else None)
        return out
