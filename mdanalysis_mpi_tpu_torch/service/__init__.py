"""Multi-tenant analysis serving layer.

The ROADMAP north star is a system that "serves heavy traffic from
millions of users", but every entry point below this package is a
single blocking ``AnalysisBase.run()`` — one caller, one trajectory,
one pass, exclusive ownership of the staged-block caches.  This
package is the orchestration layer the task-parallel MD-analysis
literature (Khoshlessan 2019, arXiv:1801.07630; Pretty Fast Analysis,
arXiv:0808.2992) says the scale win actually comes from: a scheduler
that shares decoded/staged trajectory data across concurrent analysis
requests instead of re-reading per request.

- :mod:`~mdanalysis_mpi_tpu_torch.service.jobs` — the job model:
  :class:`AnalysisJob` (analysis + frame window + backend + priority/
  deadline/reliability) and the :class:`JobHandle` future callers wait
  on.
- :mod:`~mdanalysis_mpi_tpu_torch.service.coalesce` — request coalescing:
  jobs pending against the same (trajectory, frame window, backend)
  merge into ONE staged pass via
  :class:`~mdanalysis_mpi_tpu_torch.analysis.base.AnalysisCollection`, with
  per-job result fan-out; analyses that cannot coalesce
  (:class:`~mdanalysis_mpi_tpu_torch.analysis.base.UncoalescableAnalysisError`)
  are routed to solo passes.
- :mod:`~mdanalysis_mpi_tpu_torch.service.scheduler` — the
  :class:`Scheduler`: priority queue, worker threads, cache admission
  control (jobs that would thrash the shared
  :class:`~mdanalysis_mpi_tpu_torch.parallel.executors.DeviceBlockCache`
  run uncached or wait instead of evicting a hot tenant's
  superblocks), per-job reliability integration.
- :mod:`~mdanalysis_mpi_tpu_torch.service.qos` — tenant QoS classes
  (interactive/batch/background), the weighted-fair stride scheduler,
  and the :class:`QosPolicy` admission/overload knobs shared by the
  scheduler and the fleet controller (docs/RELIABILITY.md §7).
- :mod:`~mdanalysis_mpi_tpu_torch.service.telemetry` — serving telemetry:
  queue depth, p50/p99 queue wait and latency (pooled AND per QoS
  class, with SLO attainment), coalesce and cache-hit rates (the
  bench serving leg's fields).
- :mod:`~mdanalysis_mpi_tpu_torch.service.supervision` — job leases renewed
  by phase-entry heartbeats, zombie-worker fencing, and quarantine
  diagnostics capture (docs/RELIABILITY.md, "Serving supervision").
- :mod:`~mdanalysis_mpi_tpu_torch.service.journal` — the crash-consistent
  JSONL job journal behind ``Scheduler(journal=)`` / ``batch
  --journal`` and :meth:`Scheduler.recover`; epoch-stamped records +
  :func:`~mdanalysis_mpi_tpu_torch.service.journal.replay_fleet` fencing for
  the fleet tier.
- :mod:`~mdanalysis_mpi_tpu_torch.service.placement` — sticky
  tenant→home-host rendezvous placement, the fleet controller's table.
- :mod:`~mdanalysis_mpi_tpu_torch.service.fleet` — the controller tier
  over N host worker processes (:class:`FleetController`,
  :class:`FleetJob`): placement, host-loss migration, epoch-fenced
  journal, sharded and ensemble jobs
  (:mod:`~mdanalysis_mpi_tpu_torch.service.ensemble`).
- :mod:`~mdanalysis_mpi_tpu_torch.service.canary` — the synthetic
  canary probing the full serving path; :mod:`~mdanalysis_mpi_tpu_torch.
  service.statusd` — the loopback status endpoint; :mod:`~mdanalysis_
  mpi_tpu_torch.service.cli` — ``python -m mdanalysis_mpi_tpu_torch
  batch``.

The port runs a served job on the card unless the job names the CPU;
on a CUDA device no breaker route or memory-guard shed moves a job to
the serial backend (see :mod:`~mdanalysis_mpi_tpu_torch.service.
scheduler`).  A fleet's hosts serve on its controller's device,
``cuda`` unless given.
"""

from mdanalysis_mpi_tpu_torch.service.jobs import (
    AdmissionRejectedError, AnalysisJob, BackendUnavailableError,
    JobDeadlineExpired, JobHandle, JobQuarantinedError,
    JobRuntimeExceeded, JobShedError, JobState, SchedulerShutdownError,
)
from mdanalysis_mpi_tpu_torch.service.fleet import FleetController, FleetJob
from mdanalysis_mpi_tpu_torch.service.journal import JobJournal, replay_fleet
from mdanalysis_mpi_tpu_torch.service.placement import PlacementTable
from mdanalysis_mpi_tpu_torch.service.qos import QOS_CLASSES, QosPolicy
from mdanalysis_mpi_tpu_torch.service.scheduler import Scheduler
from mdanalysis_mpi_tpu_torch.service.telemetry import (
    FleetTelemetry, ServiceTelemetry,
)

__all__ = [
    "AdmissionRejectedError", "AnalysisJob", "BackendUnavailableError",
    "FleetController", "FleetJob", "FleetTelemetry",
    "JobDeadlineExpired", "JobHandle", "JobJournal",
    "JobQuarantinedError", "JobRuntimeExceeded", "JobShedError",
    "JobState", "PlacementTable", "QOS_CLASSES", "QosPolicy",
    "Scheduler", "SchedulerShutdownError", "ServiceTelemetry",
    "replay_fleet",
]
