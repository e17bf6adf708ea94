"""Serving supervision primitives: leases, heartbeats, fencing.

The scheduler's worker threads are long-lived and mortal: a worker can
die mid-batch (a segfaulting extension, an OOM kill — modeled by
:class:`~mdanalysis_mpi_tpu_torch.reliability.faults.InjectedWorkerDeath`)
or wedge forever inside one dispatch (a hung collective).  Either way
its claimed batch is stranded: the handles never reach a terminal
state and ``drain()`` hangs.  This module is the bookkeeping half of
the fix (docs/RELIABILITY.md, "Serving supervision"); the policy half
— reap, requeue, quarantine, respawn — lives in
:class:`~mdanalysis_mpi_tpu_torch.service.scheduler.Scheduler`, which owns
the locks the two halves share.

Mechanics:

- **Lease**: granted at claim time for the whole batch, with a TTL
  derived from the batch's estimated staged bytes (and capped by the
  job's own deadline when that is tighter).  Held per worker thread.
- **Heartbeat**: rather than threading a callback through every
  executor, the lease renews on every *phase entry* of the holding
  thread (:func:`mdanalysis_mpi_tpu_torch.utils.timers.add_phase_hook`) — a
  worker making progress enters stage/dispatch/wire phases
  continuously; a hung or dead one stops.  The TTL must therefore
  exceed the worst single-phase duration, which is why it scales with
  the batch's bytes.
- **Fencing**: a reaped worker whose thread is still alive (wedged,
  not dead) is *fenced*: its next phase entry raises
  :class:`WorkerFenced` — a ``BaseException`` no run- or policy-layer
  ``except Exception`` swallows — so the zombie aborts at its next
  phase boundary instead of racing the requeued re-run for the
  analysis instance's accumulators.  The scheduler holds the requeue
  until the fenced thread actually exits (bounded by one extra grace
  TTL for a thread hung inside a single phase forever).
"""

from __future__ import annotations

import threading
import time


class WorkerFenced(BaseException):
    """Raised on a reaped-but-still-alive worker's next phase entry:
    the supervisor revoked its lease, so continuing the run would race
    the requeued attempt for the same analysis instance's accumulator
    state.  A ``BaseException`` so no retry/degradation envelope can
    swallow it — the thread unwinds and exits, and the supervisor's
    respawn restores pool capacity."""


#: Floor on the assumed staging/dispatch throughput when deriving a
#: lease TTL from a job's estimated working set: a healthy worker is
#: assumed to move at least this many bytes per second between phase
#: entries (deliberately pessimistic — a too-short TTL reaps healthy
#: workers and pays duplicated work; a too-long one just delays hang
#: detection).
LEASE_MIN_BYTES_PER_S = 32 << 20


def derive_ttl(base_ttl_s: float, est_bytes: int,
               deadline_s: float | None) -> float:
    """Lease TTL for one claimed batch: the configured floor, widened
    for big staged working sets, tightened (never below the floor)
    when the job carries its own deadline."""
    ttl = max(float(base_ttl_s), est_bytes / LEASE_MIN_BYTES_PER_S)
    if deadline_s is not None:
        ttl = max(float(base_ttl_s), min(ttl, float(deadline_s)))
    return ttl


class Lease:
    """One worker's claim on one batch: the handles it still owes, the
    ownership token fencing zombie completions, and the renewable
    deadline.

    Renewal caps (docs/RELIABILITY.md §7): ``max_renewals`` /
    ``hard_deadline`` bound a RUNAWAY batch — one that heartbeats
    forever because it genuinely never finishes (an infinite stream
    mis-submitted as a closed job, a pathological selection).  Past
    either cap :meth:`heartbeat` stops extending the deadline, the
    lease expires like any hang, and the reaper sees
    :meth:`capped` — a typed expiry, not a requeue (re-running a
    runaway is the same runaway)."""

    __slots__ = ("worker", "token", "handles", "ttl", "deadline",
                 "granted_t", "renewals", "max_renewals",
                 "hard_deadline")

    def __init__(self, worker: threading.Thread, handles, ttl: float,
                 now: float, max_renewals: int | None = None,
                 max_runtime_s: float | None = None):
        self.worker = worker
        self.token = object()
        self.handles = set(handles)
        self.ttl = float(ttl)
        self.granted_t = now
        self.deadline = now + self.ttl
        self.renewals = 0
        self.max_renewals = max_renewals
        self.hard_deadline = (None if max_runtime_s is None
                              else now + float(max_runtime_s))

    def capped(self, now: float) -> bool:
        """True when the lease ran out because a renewal CAP engaged
        (the runaway shape), as opposed to a hang/death: the reaper
        fails the handles typed instead of requeueing them."""
        return ((self.max_renewals is not None
                 and self.renewals >= self.max_renewals)
                or (self.hard_deadline is not None
                    and now >= self.hard_deadline))


class LeaseTable:
    """Lease bookkeeping for one scheduler.

    Mutating calls (grant/release/reap) happen under the scheduler's
    condition lock; :meth:`heartbeat` is deliberately lock-free (one
    dict read + attribute store under the GIL) because it runs on
    every phase entry of every worker.
    """

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        #: worker thread -> live Lease
        self.leases: dict[threading.Thread, Lease] = {}
        #: reaped-but-alive workers whose next phase entry must abort
        self.fenced: set[threading.Thread] = set()
        #: thread name -> {"error", "traceback"} recorded by the
        #: worker wrapper when a thread dies by exception, consumed by
        #: the reaper into the job's diagnostics
        self.worker_deaths: dict[str, dict] = {}

    # ---- called under the scheduler lock ----

    def grant(self, handles, ttl: float,
              max_renewals: int | None = None,
              max_runtime_s: float | None = None) -> Lease:
        worker = threading.current_thread()
        lease = Lease(worker, handles, ttl, self.clock(),
                      max_renewals=max_renewals,
                      max_runtime_s=max_runtime_s)
        self.leases[worker] = lease
        for h in handles:
            h._owner = lease.token
        return lease

    def release(self, worker: threading.Thread) -> None:
        """Normal end of a batch: the worker hands its lease back.
        Deliberately NOT called from a finally — a dying worker must
        leave its lease held so the reaper can see the stranded
        batch."""
        self.leases.pop(worker, None)

    def drop_handle(self, handle) -> None:
        """A handle reached a terminal state (or was parked by
        admission): it no longer rides any lease, so a later reap of
        its worker's batch won't requeue it."""
        for lease in self.leases.values():
            lease.handles.discard(handle)

    def expired(self, now: float) -> list:
        """Leases due for reaping: past their deadline, or held by a
        thread that is no longer alive (death reaps immediately — no
        point waiting out the TTL of a corpse)."""
        return [lease for lease in self.leases.values()
                if lease.deadline <= now or not lease.worker.is_alive()]

    def record_worker_death(self, name: str, error: str,
                            tb: str) -> None:
        self.worker_deaths[name] = {"error": error, "traceback": tb}

    # ---- called lock-free from the phase hook ----

    def heartbeat(self, _phase_name: str) -> None:
        """Renew the calling worker's lease; abort a fenced zombie.
        Registered via ``timers.add_phase_hook`` — fires on every
        phase entry process-wide, so the miss path (not a worker of
        this scheduler) must stay one dict lookup."""
        t = threading.current_thread()
        if t in self.fenced:
            raise WorkerFenced(
                f"worker {t.name} was reaped (lease expired) and must "
                "not keep running its revoked batch")
        lease = self.leases.get(t)
        if lease is not None:
            now = self.clock()
            lease.renewals += 1
            if lease.capped(now):
                # renewal cap engaged (docs/RELIABILITY.md §7): stop
                # extending — the lease expires at its CURRENT
                # deadline and the reaper handles the typed expiry.
                # Deliberately not raising here: the hot phase-entry
                # path stays one dict lookup + compare, and the fence
                # mechanism already owns aborting the thread.
                return
            lease.deadline = now + lease.ttl


def capture_diagnostics(handle, *, reason: str, worker: str,
                        ttl: float, death: dict | None = None) -> dict:
    """One supervision incident, as it lands in the quarantined job's
    ``JobQuarantinedError.diagnostics['incidents']``: what happened,
    who held the lease, the dead worker's traceback when there is one,
    and the job's last span-trace events when tracing is on."""
    from mdanalysis_mpi_tpu_torch.obs import spans

    d = {
        "reason": reason,
        "worker": worker,
        "lease_ttl_s": round(float(ttl), 3),
        "t": time.time(),
        "job_id": handle.job_id,
        "tenant": handle.job.tenant,
        "fault_count": handle._faults,
    }
    if death is not None:
        d["error"] = death.get("error")
        d["traceback"] = death.get("traceback")
    trace = spans.tail(limit=25, trace_id=handle.job.trace_id)
    if trace:
        d["last_spans"] = trace
    return d
