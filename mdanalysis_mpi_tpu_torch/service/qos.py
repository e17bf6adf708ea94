"""QoS policy for the multi-tenant serving tier (docs/SERVICE.md
"QoS classes", docs/RELIABILITY.md §7 "Overload and elasticity").

Under overload the PR-10 stack degrades by *accident*: the queue grows
without bound, strict priority can starve low-priority tenants
forever, and nothing distinguishes a latency-SLO interactive request
from a background scrub.  This module is the POLICY half of the fix —
pure bookkeeping, importable by both the in-process
:class:`~mdanalysis_mpi_tpu_torch.service.scheduler.Scheduler` and the
:class:`~mdanalysis_mpi_tpu_torch.service.fleet.FleetController` so the two
tiers cannot drift on what a class, a weight, or a shed ladder means:

- **Classes** (:data:`QOS_CLASSES`): ``interactive`` (latency SLO) >
  ``batch`` (throughput) > ``streaming`` (live tenants tailing a
  growing store — long-lived by design, parked rather than shed;
  docs/STREAMING.md) > ``background`` (scrubs, re-indexing —
  sheddable).  Every job carries one; ``batch`` is the default, so a
  job file that never heard of QoS behaves exactly as before.
- **Weighted-fair claim ordering** (:class:`StrideScheduler`): stride
  scheduling over the per-class weights — a class with weight 8 is
  claimed ~8x as often as a class with weight 1 when both have queued
  work, and a lone backlogged class gets every slot.  Unlike strict
  priority this cannot starve: every class with queued work advances.
  FIFO (and the pre-QoS ``priority`` knob) are preserved *within* a
  class.
- **Admission as policy** (:class:`QosPolicy`): bounded submit
  (``max_queue_depth`` — backpressure, typed reject), per-tenant token
  buckets (``tenant_rate_per_s``) and inflight quotas
  (``tenant_quota``), the overload shed ladder
  (``shed_queue_depth`` + ``shed_classes`` — lowest class first,
  never above the configured set), and the runaway-job lease caps
  (``max_lease_renewals`` / ``max_runtime_s``).
"""

from __future__ import annotations

import dataclasses
import time

#: Tenant QoS classes, highest urgency first.  The tuple order IS the
#: shed ladder read backwards: overload sheds from the END (background
#: first) and never reaches a class outside ``QosPolicy.shed_classes``.
QOS_CLASSES = ("interactive", "batch", "streaming", "background")

#: Class every job gets when none is set — the pre-QoS behavior.
DEFAULT_QOS = "batch"

_QOS_RANK = {c: i for i, c in enumerate(QOS_CLASSES)}

#: Default weighted-fair claim weights (claims per round when every
#: class has queued work).  Deliberately NOT strict priority: a weight
#: ratio bounds interactive's advantage so batch/background always
#: advance.
DEFAULT_WEIGHTS = {"interactive": 8, "batch": 3, "streaming": 2,
                   "background": 1}

#: Default per-class latency-SLO targets (seconds, submission →
#: completion; None = no target).  Surfaced as
#: ``mdtpu_slo_attainment{class=}`` — these are DISCLOSED targets, not
#: enforcement: a missed SLO is counted, never killed.
DEFAULT_SLO_TARGETS_S = {"interactive": 1.0, "batch": 30.0,
                         "streaming": None, "background": None}


def qos_rank(qos: str) -> int:
    """Smaller = more urgent.  Unknown classes sort last (they cannot
    exist on a validated job, but a foreign job-file spec must not
    crash the comparator)."""
    return _QOS_RANK.get(qos, len(QOS_CLASSES))


def validate_qos(qos) -> str:
    """Normalize + validate one job's class at construction — a typo'd
    class must fail the SUBMISSION, not silently ride the default
    weights until someone audits the shed ledger."""
    if qos is None:
        return DEFAULT_QOS
    qos = str(qos)
    if qos not in QOS_CLASSES:
        raise ValueError(
            f"unknown QoS class {qos!r}; one of {QOS_CLASSES}")
    return qos


@dataclasses.dataclass
class QosPolicy:
    """One serving tier's QoS + overload policy (docs/RELIABILITY.md
    §7).  Every knob defaults OFF (``None``) except the weights and
    SLO targets, so ``Scheduler(qos=QosPolicy())`` — or no policy at
    all — changes nothing for existing callers.

    ``weights``
        Weighted-fair claim weights per class (missing classes get
        the :data:`DEFAULT_WEIGHTS` entry).
    ``slo_targets_s``
        Per-class latency-SLO targets in seconds (None = untargeted).
        Attainment (fraction of completed jobs meeting the target) is
        surfaced per class through telemetry and
        ``mdtpu_slo_attainment{class=}``.
    ``max_queue_depth``
        Bounded submit: a submission that would push the queued (not
        running) depth past this bound is REJECTED with a typed
        :class:`~mdanalysis_mpi_tpu_torch.service.jobs.
        AdmissionRejectedError` (reason ``queue_full``) instead of
        growing the queue without bound — backpressure the caller can
        retry against, not an OOM three minutes later.
    ``tenant_rate_per_s`` / ``tenant_rate_burst``
        Per-tenant token bucket on submissions: sustained rate and
        bucket capacity (default burst: ``max(1, rate)``).  Exceeding
        it rejects typed (reason ``rate_limit``).
    ``tenant_quota``
        Max jobs one tenant may have queued+running at once (reason
        ``tenant_quota``) — one 10k-job tenant must not monopolize
        the queue the instant it connects.
    ``tenant_budget_dispatch_s``
        Per-tenant dispatch-seconds budget fed from the LIVE usage
        ledger (obs/usage.py, docs/OBSERVABILITY.md): a submission
        from a tenant whose metered ``dispatch_s`` already reached
        this bound is rejected typed (reason ``budget``) — counted
        and journaled like every other admission reason.  The
        synthetic canary's pseudo-tenant is exempt.
    ``shed_queue_depth`` / ``shed_classes``
        The overload controller's trigger and ladder: when the queued
        depth exceeds ``shed_queue_depth`` while the workers/hosts are
        saturated, queued jobs of the classes in ``shed_classes`` are
        SHED — lowest class first, newest first within a class — with
        a typed :class:`~mdanalysis_mpi_tpu_torch.service.jobs.JobShedError`
        (state ``shed``, journaled terminal record, counted
        ``mdtpu_jobs_shed_total{class=}``).  Classes outside
        ``shed_classes`` are NEVER shed, whatever the depth.
    ``shed_staged_bytes``
        Optional second overload signal: estimated staged bytes in
        flight (the PR-9 memory-guard accounting) beyond which the
        shed ladder also engages.
    ``max_lease_renewals`` / ``max_runtime_s``
        Runaway-job caps (docs/RELIABILITY.md §7): a job that renews
        its lease forever via phase-entry heartbeats can otherwise pin
        a worker/host/cache indefinitely.  Past either cap the lease
        stops renewing, the supervisor reaps it, and the job fails
        with a typed :class:`~mdanalysis_mpi_tpu_torch.service.jobs.
        JobRuntimeExceeded` (never requeued — a runaway re-run is the
        same runaway).  ``streaming`` jobs are EXEMPT: a live tenant
        is unbounded in runtime by design (docs/STREAMING.md); its
        envelope is bounded in RESOURCES (``streaming_staged_bytes``)
        instead.
    ``streaming_staged_bytes``
        The streaming class's sanctioned resource envelope
        (docs/STREAMING.md "Serving live tenants"): the max estimated
        staged bytes ONE streaming job's window may put in flight.  A
        streaming submission whose window estimate exceeds it is
        rejected typed (reason ``stream_envelope``) — the class trades
        its runtime-cap exemption for this bound, never both ways.
    ``stream_park_delay_s``
        How long a streaming job parks after a feed stall before its
        next resume attempt (default 0.5 s).  Parking is NOT a fault:
        it never counts toward the poison threshold, and the shed
        ladder parks streaming tenants instead of killing them.
    """

    weights: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_WEIGHTS))
    slo_targets_s: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_SLO_TARGETS_S))
    max_queue_depth: int | None = None
    tenant_rate_per_s: float | None = None
    tenant_rate_burst: float | None = None
    tenant_quota: int | None = None
    tenant_budget_dispatch_s: float | None = None
    shed_queue_depth: int | None = None
    shed_classes: tuple = ("background",)
    shed_staged_bytes: int | None = None
    max_lease_renewals: int | None = None
    max_runtime_s: float | None = None
    streaming_staged_bytes: int | None = None
    stream_park_delay_s: float = 0.5

    def __post_init__(self):
        w = dict(DEFAULT_WEIGHTS)
        w.update({validate_qos(c): float(v)
                  for c, v in (self.weights or {}).items()})
        bad = [c for c, v in w.items() if v <= 0]
        if bad:
            raise ValueError(f"QoS weights must be > 0 (got {bad})")
        self.weights = w
        t = dict(DEFAULT_SLO_TARGETS_S)
        t.update({validate_qos(c): v
                  for c, v in (self.slo_targets_s or {}).items()})
        self.slo_targets_s = t
        self.shed_classes = tuple(validate_qos(c)
                                  for c in self.shed_classes)

    @classmethod
    def from_spec(cls, spec: dict | None) -> "QosPolicy":
        """Build a policy from a job-file ``"qos"`` block
        (docs/SERVICE.md) — unknown keys fail loudly, like the per-job
        field validation in ``service/cli.py``."""
        spec = dict(spec or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(spec) - known
        if unknown:
            raise ValueError(
                f"unknown qos policy fields {sorted(unknown)}; "
                f"known: {sorted(known)}")
        if "shed_classes" in spec:
            spec["shed_classes"] = tuple(spec["shed_classes"])
        return cls(**spec)

    def sheddable(self, qos: str) -> bool:
        return qos in self.shed_classes

    def shed_ladder(self) -> list[str]:
        """Sheddable classes, LOWEST class first — the order the
        overload controller walks."""
        return sorted(self.shed_classes, key=qos_rank, reverse=True)

    def rate_burst(self) -> float:
        if self.tenant_rate_burst is not None:
            return float(self.tenant_rate_burst)
        return max(1.0, float(self.tenant_rate_per_s or 1.0))


class StrideScheduler:
    """Weighted-fair class picker (stride scheduling).

    Each class advances a virtual ``pass`` by ``1/weight`` per claim;
    :meth:`pick` returns the candidate class with the smallest pass.
    Over any window where a set of classes all have queued work, class
    claims converge to the weight ratio; a class alone in the queue
    gets every slot (work conservation); and no class with queued work
    waits more than ``1/weight`` of a round — the no-starvation
    property strict priority lacks.  Not thread-safe by itself: the
    scheduler calls it under its own condition lock.
    """

    def __init__(self, weights: dict | None = None):
        self.weights = dict(DEFAULT_WEIGHTS)
        if weights:
            self.weights.update(weights)
        self._pass: dict[str, float] = {}
        # global virtual time: the pass of the most recent pick's
        # chosen class AT pick time (== the minimum pass among the
        # then-active classes; monotonically non-decreasing)
        self._vtime = 0.0

    def pick(self, candidates) -> str | None:
        """The next class to claim among ``candidates`` (classes with
        claimable work right now); advances its pass.  None for an
        empty candidate set."""
        candidates = [c for c in candidates]
        if not candidates:
            return None
        # a class entering (or RE-entering) the backlog starts at the
        # current virtual time: it gets its fair share from now on,
        # but cannot claim credit for the idle time it spent with
        # nothing queued.  The clamp is against VTIME, not the
        # candidates' own minimum — a re-entrant's stale low pass
        # would make itself the floor and burst ahead of a class that
        # stayed backlogged (the exact inversion this prevents).
        for c in candidates:
            self._pass[c] = max(self._pass.get(c, self._vtime),
                                self._vtime)
        if len(candidates) == 1:
            chosen = candidates[0]
        else:
            chosen = min(candidates,
                         key=lambda c: (self._pass[c], qos_rank(c)))
        self._vtime = self._pass[chosen]
        w = self.weights.get(chosen, 1.0)
        self._pass[chosen] += 1.0 / w
        return chosen


class TenantBuckets:
    """Per-tenant token buckets for the submission rate limit.  All
    calls run under the scheduler's condition lock; the clock is
    injectable so tests pin refill exactly."""

    def __init__(self, rate_per_s: float, burst: float,
                 clock=time.monotonic):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._state: dict[str, tuple] = {}   # tenant -> (tokens, t)

    def try_take(self, tenant: str) -> bool:
        now = self._clock()
        tokens, last = self._state.get(tenant, (self.burst, now))
        tokens = min(self.burst, tokens + (now - last) * self.rate)
        if tokens < 1.0:
            self._state[tenant] = (tokens, now)
            return False
        self._state[tenant] = (tokens - 1.0, now)
        return True
