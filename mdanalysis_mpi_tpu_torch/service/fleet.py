"""Elastic fleet serving: a controller tier over N host worker
processes (docs/RELIABILITY.md §6, ROADMAP item 1).

The PR-4..PR-9 serving stack supervises *workers inside one process*;
this module promotes every one of those primitives one level up, to
host granularity:

- **Controller** (:class:`FleetController`): owns the tenant→host
  placement table (:mod:`~mdanalysis_mpi_tpu_torch.service.placement` —
  sticky rendezvous routing, so a hot tenant's superblocks stay
  resident in its home host's ``DeviceBlockCache`` and its
  Universe/reader state in the host's tenant cache), the epoch-stamped
  CRC journal (exactly-once application of completions), and host
  membership via heartbeat leases.
- **Hosts** (:func:`host_main`, the ``fleet-host`` CLI): one OS
  process each, running jobs through their own local
  :class:`~mdanalysis_mpi_tpu_torch.service.scheduler.Scheduler` (worker
  leases, breakers, prefetch — the whole PR-7 stack — still apply
  *inside* each host).  Hosts dial the controller's socket, found via
  an atomically-replaced address file beside the journal, heartbeat on
  an interval, and stream completions back (resent until acked — the
  controller's assignment-token check makes re-delivery idempotent).
- **Host loss**: a ``kill -9``'d host EOFs its socket (fast path); a
  partitioned/wedged one misses heartbeats until its lease expires
  (slow path).  Either way its in-flight jobs are REQUEUED onto
  survivors (``jobs_migrated``), its tenants re-placed (and re-warmed
  by the survivors' tenant caches / scheduler prefetch on first
  touch), and placement degrades to fewer hosts — down to one, never
  to failure.  The lost host's per-host circuit breaker records the
  failure, so a flapping host trips out of placement.
- **Controller failover** (:meth:`FleetController.adopt`): a standby
  replays the CRC journal (:func:`~mdanalysis_mpi_tpu_torch.service.journal.
  replay_fleet`), BUMPS the epoch, writes an ``epoch`` record and the
  new address file; hosts reconnect on their next heartbeat tick,
  syncing their in-flight jobs and unacked completions into the new
  controller.  **Epoch fencing** is the ``WorkerFenced`` ownership
  token one level up: every command and completion carries
  ``(epoch, assign_seq, host)``, hosts reject commands from stale
  epochs, the controller rejects completions whose token is not the
  job's CURRENT assignment, and replay rejects records a zombie
  controller appended under an old epoch — counted as
  ``epoch_fenced_rejects``, never applied.

Wire format: one JSON object per line over a loopback/LAN TCP socket.
Deliberately dependency-free (stdlib sockets): the controller and its
hosts share a machine or a rack; cross-DC serving is out of scope
(docs/RELIABILITY.md §6 "Scope").

**Device.**  The fleet runs on the card unless told otherwise: a
controller's ``device`` (``cuda`` by default, checked at construction)
is the device of every host it spawns — by hand, on a respawn after a
loss, or by the autoscaler — and a host with no ``backend`` runs each
job on the analysis' own default backend (``torch`` for all but the
serial-only analyses) on that device.  A host asked for ``cuda`` on a
machine without one raises at start; it never serves on the CPU.  Its
local :class:`~mdanalysis_mpi_tpu_torch.service.scheduler.Scheduler`
keeps the card rule: no job bound for the card ends on serial.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.obs import alerts as _alerts
from mdanalysis_mpi_tpu_torch.obs import flight as _flight
from mdanalysis_mpi_tpu_torch.obs import spans as _spans
from mdanalysis_mpi_tpu_torch.reliability import breaker as _breaker
from mdanalysis_mpi_tpu_torch.service import journal as _journal
from mdanalysis_mpi_tpu_torch.service import placement as _placement
from mdanalysis_mpi_tpu_torch.service.telemetry import FleetTelemetry
from mdanalysis_mpi_tpu_torch.utils.log import get_logger
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

#: Controller-side cap on buffered (not yet exported) trace events
#: per host — overflow evicts oldest, counted
#: (``mdtpu_fleet_obs_trace_dropped_total{site="controller"}``).
HOST_EVENTS_CAP = int(
    os.environ.get("MDTPU_FLEET_TRACE_MAX_EVENTS", "200000"))

#: Files the fleet keeps in its working directory: the epoch-stamped
#: CRC journal, and the atomically-replaced controller address file
#: hosts poll for discovery + failover.
JOURNAL_NAME = "fleet_journal.jsonl"
ADDR_NAME = "controller.addr"

#: Job states a :class:`FleetJob` moves through (strings, like
#: service.jobs.JobState).
QUEUED = "queued"
ASSIGNED = "assigned"
DONE = "done"
FAILED = "failed"
QUARANTINED = "quarantined"
SHED = "shed"          # dropped by the controller's overload shed
#                        ladder (docs/RELIABILITY.md §7)

_TERMINAL = (DONE, FAILED, QUARANTINED, SHED)

#: Fleet-only job-spec keys stripped before the host builds the
#: analysis (everything else is the ``batch`` CLI's job schema).
#: ``ensemble``/``ingest`` are the trajectory-set extension
#: (docs/ENSEMBLE.md): the controller expands them into member +
#: ingest children; the host reads ``ingest`` itself (pre-stage runs,
#: replay-safe store ensure) before the analysis build ever sees the
#: spec.
_FLEET_SPEC_KEYS = ("fixture", "shards", "ensemble", "ingest")


def _send_line(sock: socket.socket, lock: threading.Lock,
               msg: dict) -> bool:
    """One JSON line onto the wire; False (never raise) on a dead
    socket — the caller's lease/EOF machinery owns the failure."""
    data = (json.dumps(msg) + "\n").encode()
    try:
        with lock:
            sock.sendall(data)
        return True
    except OSError:
        return False


def _write_addr_file(workdir: str, host: str, port: int, epoch: int,
                     status_port: int | None = None) -> str:
    """Atomically publish the active controller's address + epoch
    (and, beside them, the live status endpoint's port — the
    ``status`` CLI reads it from here): hosts must never read a torn
    address, and a standby's adoption must flip every host in one
    rename.  The shared integrity helper (tmp → fsync → os.replace)
    also counts and types a failed write — an ENOSPC during failover
    surfaces as a typed
    :class:`~mdanalysis_mpi_tpu_torch.utils.integrity.ArtifactWriteError`
    out of the adoption, never a silently unpublished controller."""
    from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity

    path = os.path.join(workdir, ADDR_NAME)
    info = {"host": host, "port": port, "epoch": epoch}
    if status_port:
        info["status_port"] = status_port
    _integrity.atomic_write_bytes(path, json.dumps(info).encode(),
                                  artifact="controller_addr")
    return path


def _read_addr_file(workdir: str) -> dict | None:
    try:
        with open(os.path.join(workdir, ADDR_NAME),
                  encoding="utf-8") as f:
            info = json.loads(f.read())
    except (OSError, ValueError):
        return None
    if not isinstance(info, dict) or "port" not in info:
        return None
    return info


class FleetJob:
    """Controller-side record + waitable handle for one fleet job."""

    __slots__ = ("fp", "spec", "tenant", "qos", "state", "host",
                 "assign_seq", "assign_epoch", "results", "error",
                 "migrations", "resident", "parent", "children",
                 "shard_index", "member_index", "placement_key",
                 "ingest_children", "submit_t", "done_t", "_event")

    def __init__(self, fp: str, spec: dict, tenant: str):
        from mdanalysis_mpi_tpu_torch.service.qos import validate_qos

        self.fp = fp
        self.spec = spec
        self.tenant = tenant
        #: tenant QoS class (docs/RELIABILITY.md §7): weighted-fair
        #: dispatch ordering across classes, shed eligibility under
        #: overload.  Validated here so a typo'd class fails the
        #: submission, not the audit.
        self.qos = validate_qos(spec.get("qos"))
        self.state = QUEUED
        self.host: str | None = None
        self.assign_seq: int | None = None
        self.assign_epoch: int | None = None
        self.results: dict | None = None
        self.error: str | None = None
        self.migrations = 0
        self.resident: bool | None = None
        self.parent: FleetJob | None = None
        self.children: list[FleetJob] | None = None
        self.shard_index: int | None = None
        #: ensemble extension (docs/ENSEMBLE.md): which member of a
        #: trajectory-set parent this child is (None = not an
        #: ensemble child), an explicit placement key overriding the
        #: tenant/shard routing, and — on the PARENT — the ingest
        #: pre-stage children whose dedup ledger the merge discloses
        self.member_index: int | None = None
        self.placement_key: str | None = None
        self.ingest_children: list[FleetJob] | None = None
        #: submission/settle wall stamps (time.monotonic) — the
        #: per-class latency the QoS bench leg reads off the
        #: controller without a round trip per job
        self.submit_t: float | None = None
        self.done_t: float | None = None
        self._event = threading.Event()

    def _settle(self) -> None:
        """Mark terminal: stamp the completion time once, wake
        waiters.  Every path that ends a job (apply, quarantine,
        shed, merge) funnels here so latency accounting cannot
        drift."""
        if self.done_t is None:
            self.done_t = time.monotonic()
        self._event.set()

    @property
    def latency_s(self) -> float | None:
        if self.submit_t is None or self.done_t is None:
            return None
        return self.done_t - self.submit_t

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def result_arrays(self) -> dict:
        """``{name: np.ndarray}`` of the finished job's results (raises
        the job's failure message as RuntimeError otherwise)."""
        import numpy as np

        if not self._event.is_set():
            raise TimeoutError(f"fleet job {self.fp} still {self.state}")
        if self.state != DONE:
            raise RuntimeError(
                f"fleet job {self.fp} {self.state}: {self.error}")
        return {k: np.asarray(v) for k, v in (self.results or {}).items()}

    def __repr__(self):
        return (f"<FleetJob {self.fp} tenant={self.tenant!r} "
                f"{self.state}@{self.host}>")


class _Host:
    """Controller-side state of one connected host."""

    __slots__ = ("hid", "sock", "send_lock", "deadline", "inflight",
                 "proc", "alive", "epoch")

    def __init__(self, hid: str, sock: socket.socket, deadline: float,
                 epoch: int, proc=None):
        self.hid = hid
        self.sock = sock
        self.send_lock = threading.Lock()
        self.deadline = deadline
        self.inflight: set[str] = set()
        self.proc = proc
        self.alive = True
        self.epoch = epoch


class FleetController:
    """The controller tier: tenant placement, host leases, migration,
    epoch-fenced journal ownership.

    ``workdir``
        Directory holding the fleet journal + controller address file
        (the unit of adoption: a standby pointed at the same workdir
        takes the fleet over).
    ``epoch``
        This controller's fencing epoch (default 1 for a fresh fleet;
        :meth:`adopt` derives ``last + 1`` from the journal).
    ``host_ttl_s`` / ``tick_s``
        Host heartbeat lease TTL and the supervisor tick.  A host is
        declared lost when its socket EOFs (a ``kill -9``, fast) or
        its lease expires (a partition/wedge, bounded by the TTL).
    ``poison_migrations``
        A job migrated this many times (its host died under it each
        time) is QUARANTINED instead of migrated again — one poison
        job must not bleed the fleet host by host.
    ``respawn_hosts``
        Replace a lost spawned host with a fresh process (capacity
        recovery).  Default False: placement DEGRADES to the
        survivors, which is the behavior the chaos suite pins.
    ``host_slots``
        Max jobs assigned-and-unfinished per host at once (None =
        unbounded, the pre-QoS behavior).  With slots, surplus work
        stays PENDING at the controller — which is what makes the
        queue-depth overload signal, the shed ladder, and the
        autoscaler's backlog signal real (an instantly-drained
        controller queue can never look overloaded).
    ``qos``
        A :class:`~mdanalysis_mpi_tpu_torch.service.qos.QosPolicy`
        (docs/RELIABILITY.md §7): weighted-fair dispatch ordering of
        the pending queue across tenant QoS classes, and the
        controller-tier shed ladder (``shed_queue_depth`` /
        ``shed_classes`` — lowest class first, journaled terminal
        ``shed`` records, counted ``mdtpu_jobs_shed_total{class=}``).
    ``autoscale`` / ``min_hosts`` / ``max_hosts`` /
    ``scale_up_backlog`` / ``scale_down_idle_s`` /
    ``scale_cooldown_s`` / ``retire_drain_s`` / ``autoscale_spawn``
        Fleet elasticity (docs/RELIABILITY.md §7 "Autoscale state
        machine"): the supervisor spawns a ``fleet-host`` when the
        pending backlog reaches ``scale_up_backlog`` with every slot
        in use (up to ``max_hosts``), and retires one — drain-first:
        no new assignments, resident tenants re-place minimally, any
        job still in flight after ``retire_drain_s`` migrates via the
        journal-level exactly-once path — after ``scale_down_idle_s``
        of empty backlog (down to ``min_hosts``).  Scale events are
        journaled (``scale_up``/``scale_down``, epoch-stamped so a
        zombie's are fenced) and counted
        ``mdtpu_hosts_scaled_{up,down}_total``.  ``autoscale_spawn``
        is the kwargs dict :meth:`spawn_host` gets for autoscaled
        hosts (backend, cache_mb, env, ...); without a ``device`` key
        they take the controller's.
    ``device``
        The device every host this controller spawns serves on
        (``cuda`` unless given; the CPU tests pass ``"cpu"``).  Checked
        here, so a fleet asked for a card that is not there fails at
        construction, before any host starts.  Respawned and
        autoscaled hosts inherit it.
    ``alerts`` / ``alert_interval_s``
        The alert rules engine (obs/alerts.py, docs/OBSERVABILITY.md
        "Alerting & profiling") evaluated over the FEDERATED
        snapshot on the supervisor tick: transitions are journaled
        (``ev: "alert"``), the first firing of a rule drops one
        flight-recorder black box into the workdir, and the firing
        table rides ``/status``.  ``None`` → seed rules sharing this
        controller's clock/journal/workdir; ``False`` → off.
    """

    def __init__(self, workdir, epoch: int = 1, host_ttl_s: float = 3.0,
                 tick_s: float = 0.05, poison_migrations: int = 3,
                 respawn_hosts: bool = False, breakers=None,
                 telemetry: FleetTelemetry | None = None,
                 bind_host: str = "127.0.0.1", clock=time.monotonic,
                 status: bool = True, trace: bool | None = None,
                 obs_interval_s: float = 0.5,
                 host_slots: int | None = None, qos=None,
                 autoscale: bool = False, min_hosts: int = 1,
                 max_hosts: int = 4, scale_up_backlog: int = 1,
                 scale_down_idle_s: float = 3.0,
                 scale_cooldown_s: float = 1.0,
                 retire_drain_s: float = 10.0,
                 autoscale_spawn: dict | None = None,
                 alerts=None, alert_interval_s: float = 1.0,
                 device: str = "cuda",
                 _recovered: dict | None = None):
        from mdanalysis_mpi_tpu_torch.device import resolve_device
        from mdanalysis_mpi_tpu_torch.service import qos as _qosmod

        #: the hosts' device (a string: it rides their command line)
        self.device = str(resolve_device(device))

        # ---- QoS + elasticity policy (docs/RELIABILITY.md §7) ----
        self.host_slots = (None if host_slots is None
                           else max(1, int(host_slots)))
        self.qos = qos or _qosmod.QosPolicy()
        self._stride = _qosmod.StrideScheduler(self.qos.weights)
        self.autoscale = bool(autoscale)
        self.min_hosts = max(0, int(min_hosts))
        self.max_hosts = max(self.min_hosts, int(max_hosts))
        self.scale_up_backlog = max(1, int(scale_up_backlog))
        self.scale_down_idle_s = float(scale_down_idle_s)
        self.scale_cooldown_s = float(scale_cooldown_s)
        self.retire_drain_s = float(retire_drain_s)
        self.autoscale_spawn = dict(autoscale_spawn or {})
        self._scale_last = float("-inf")
        self._idle_since: float | None = None
        #: hosts mid-retirement: hid -> drain deadline.  A retiring
        #: host takes no new assignments (it left placement) but
        #: finishes what it holds; past the deadline the leftovers
        #: migrate and the host is stopped anyway.
        self._retiring: dict[str, float] = {}
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.epoch = int(epoch)
        self.host_ttl_s = float(host_ttl_s)
        self.tick_s = float(tick_s)
        self.poison_migrations = max(1, int(poison_migrations))
        self.respawn_hosts = bool(respawn_hosts)
        self.telemetry = telemetry or FleetTelemetry()
        self.breakers = breakers or _breaker.BreakerBoard(
            threshold=3, cooldown_s=5.0, clock=clock)
        self.placement = _placement.PlacementTable(
            breakers=self.breakers)
        self._clock = clock
        self._log = get_logger("mdtpu.fleet")
        self._lock = threading.RLock()
        self._hosts: dict[str, _Host] = {}
        self._jobs: dict[str, FleetJob] = {}
        self._pending: list[str] = []
        #: ensemble ingest gating (docs/ENSEMBLE.md "Ingest
        #: pre-stage"): ingest-child fp → the member-analysis fp it
        #: gates.  A gated member is registered + journaled at submit
        #: but enters ``_pending`` only when its ingest child lands
        #: DONE (a failed ingest fails the member typed instead).
        self._gated: dict[str, str] = {}
        self._assign_seq = 0
        self._job_seq = 0
        self._host_seq = 0
        self._shutdown = False
        self._wedged = False
        self._procs: list = []
        # ---- fleet observability (docs/OBSERVABILITY.md "Fleet
        #      federation"): per-host metric snapshots + trace-event
        #      batches ingested off heartbeats, under their own lock
        #      so a scrape never contends with dispatch ----
        self._obs_lock = threading.Lock()
        self._host_metrics: dict[str, dict] = {}
        self._host_events: dict[str, list] = {}
        self._host_pids: dict[str, int] = {}
        #: spawned hosts trace + ship when True (None: follow the
        #: controller process's own tracing state at spawn time)
        self._trace_fleet = (obs.tracing_enabled() if trace is None
                             else bool(trace))
        self.obs_interval_s = float(obs_interval_s)
        self.journal = _journal.JobJournal(
            os.path.join(self.workdir, JOURNAL_NAME), epoch=self.epoch)
        # epoch record FIRST and durable: from this line on, every
        # older-epoch append in the journal is a zombie's and replay
        # fences it (docs/RELIABILITY.md §6)
        self.journal.record("epoch", None, durable=True,
                            controller=os.getpid())
        obs.METRICS.set_gauge("mdtpu_controller_epoch", self.epoch)
        obs.span_event("epoch_adopted", epoch=self.epoch)
        # ---- alert rules engine (obs/alerts.py): evaluated over the
        #      FEDERATED snapshot on the supervisor tick — a class
        #      burning its SLO budget anywhere in the fleet fires at
        #      the controller; transitions are journaled (`ev:
        #      "alert"`) and the first firing drops a black box into
        #      the workdir.  None → seed rules; False → off. ----
        if alerts is False:
            self.alerts = None
        elif isinstance(alerts, _alerts.AlertEngine):
            self.alerts = alerts
        else:
            self.alerts = _alerts.AlertEngine(
                rules=alerts, clock=clock, flight_dir=self.workdir,
                journal=self.journal)
        self.alert_interval_s = float(alert_interval_s)
        self._alert_last = float("-inf")
        if _recovered:
            self._resubmit_recovered(_recovered)
            # pre-seed the usage job meter from the replayed finish
            # ledger: a standby's ledger must account for terminals
            # the dead controller already journaled, or
            # usage_reconcile() would report phantom journal-only
            # outcomes after takeover
            for fp, n in _recovered.get("finishes", {}).items():
                rec = _recovered["jobs"].get(fp, {})
                spec = rec.get("spec") or {}
                for _ in range(n):
                    obs.usage.LEDGER.charge_job(
                        rec.get("tenant") or "default",
                        spec.get("qos") or "batch",
                        rec.get("state", "done"))
            # adoption black box (docs/OBSERVABILITY.md): what the
            # standby saw at takeover, journaled beside the epoch
            fpath = _flight.dump(
                "adoption", self.workdir,
                extra={"epoch": self.epoch,
                       "recovered_jobs": sorted(_recovered["jobs"])})
            if fpath:
                self.journal.record("flight", None,
                                    trigger="adoption", path=fpath)
        # listener FIRST (bound-socket port handoff: the controller
        # binds port 0 itself and hands the RESOLVED port to hosts via
        # the address file — no free-port race), so self.address
        # exists before the status server starts answering /status
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((bind_host, 0))
        self._listener.listen(64)
        self.address = self._listener.getsockname()
        # live status endpoint (service/statusd.py): /status,
        # /healthz, and the MERGED-fleet /metrics exposition — its
        # port is published beside the command address below
        self._statusd = None
        if status:
            from mdanalysis_mpi_tpu_torch.service.statusd import StatusServer

            self._statusd = StatusServer(
                self.status,
                metrics_fn=lambda: obs.to_prometheus(
                    self.fleet_snapshot()),
                health_fn=self.healthz,
                usage_fn=lambda: obs.usage.usage_doc(
                    self.fleet_snapshot()),
                bind_host=bind_host)
        _write_addr_file(self.workdir, self.address[0],
                         self.address[1], self.epoch,
                         status_port=(self._statusd.address[1]
                                      if self._statusd else None))
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="mdtpu-fleet-accept")
        self._accept_thread.start()
        self._sup_thread = threading.Thread(
            target=self._supervisor, daemon=True,
            name="mdtpu-fleet-supervisor")
        self._sup_thread.start()

    # ---- adoption / failover ----

    @classmethod
    def adopt(cls, workdir, **kwargs) -> "FleetController":
        """Standby takeover: replay the fleet journal, bump the epoch
        past every record in it, resubmit the unfinished jobs, publish
        the new address.  The zombie controller's subsequent journal
        appends (old epoch) are fenced at the next replay; its
        subsequent commands are fenced by every host that has seen the
        new address file."""
        path = os.path.join(str(workdir), JOURNAL_NAME)
        recovered = None
        epoch = 1
        if os.path.exists(path):
            recovered = _journal.replay_fleet(path)
            epoch = recovered["epoch"] + 1
        return cls(workdir, epoch=epoch, _recovered=recovered,
                   **kwargs)

    def _resubmit_recovered(self, recovered: dict) -> None:
        n = 0
        for fp, rec in recovered["jobs"].items():
            if rec["state"] not in ("queued", "claimed"):
                continue
            spec = rec.get("spec")
            if spec is None:
                self._log.warning(
                    "adopted journal job %s has no spec record; it "
                    "cannot be re-run from the journal alone", fp)
                continue
            job = FleetJob(fp, dict(spec),
                           rec.get("tenant") or "default")
            with self._lock:
                self._jobs[fp] = job
                self._pending.append(fp)
            n += 1
        if n:
            self._log.warning(
                "adoption (epoch %d): %d unfinished job(s) re-owned "
                "from the journal", self.epoch, n)

    # ---- host lifecycle ----

    def spawn_host(self, host_id: str | None = None,
                   backend: str | None = None, cache_mb: int = 0,
                   workers: int = 1, env: dict | None = None,
                   hb_interval_s: float = 0.25,
                   obs_interval_s: float | None = None,
                   device: str | None = None):
        """Start one ``fleet-host`` worker process against this
        fleet's workdir.  Returns the Popen handle (also tracked for
        shutdown).  ``backend`` None runs each job on its analysis'
        default backend; ``device`` None is the controller's device.
        ``obs_interval_s`` is the host's metrics-piggyback period
        (default: the controller's ``obs_interval_s``; ≤0 disables
        federation shipping from that host)."""
        with self._lock:
            if host_id is None:
                host_id = f"host{self._host_seq}"
            self._host_seq += 1
        cmd = [sys.executable, "-m", "mdanalysis_mpi_tpu_torch",
               "fleet-host", "--workdir", self.workdir,
               "--host-id", host_id,
               "--device", self.device if device is None else device,
               "--cache-mb", str(cache_mb),
               "--workers", str(workers),
               "--hb-interval", str(hb_interval_s),
               "--obs-interval",
               str(self.obs_interval_s if obs_interval_s is None
                   else obs_interval_s)]
        if backend is not None:
            cmd += ["--backend", backend]
        child_env = dict(os.environ)
        if self._trace_fleet:
            # hosts trace in memory and ship batches; the controller
            # owns the one merged file (export_fleet_trace)
            child_env.setdefault("MDTPU_FLEET_TRACE", "1")
        # the host must import THIS package however the controller was
        # launched (repo checkout, odd cwd): pin our root on the path
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        child_env["PYTHONPATH"] = pkg_root + (
            os.pathsep + child_env["PYTHONPATH"]
            if child_env.get("PYTHONPATH") else "")
        if env:
            child_env.update(env)
        proc = subprocess.Popen(cmd, env=child_env)
        proc._mdtpu_host_id = host_id
        with self._lock:
            self._procs.append(proc)
        return proc

    def kill_host(self, host_id: str, sig: int = 9) -> bool:
        """Chaos hook: ``kill -9`` (by default) a spawned host process
        mid-wave.  Returns whether a live process was signalled."""
        import signal as _signal

        with self._lock:
            procs = list(self._procs)
        for proc in procs:
            if getattr(proc, "_mdtpu_host_id", None) == host_id \
                    and proc.poll() is None:
                proc.send_signal(sig if sig else _signal.SIGKILL)
                return True
        return False

    def wait_hosts(self, n: int, timeout: float = 30.0) -> bool:
        """Block until ``n`` hosts are alive members (spawn is async:
        the child has to import, connect and hello)."""
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            with self._lock:
                alive = sum(1 for h in self._hosts.values() if h.alive)
            if alive >= n:
                return True
            time.sleep(0.02)
        return False

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return               # listener closed: shutdown
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(sock,),
                             daemon=True,
                             name="mdtpu-fleet-conn").start()

    def _serve_conn(self, sock: socket.socket) -> None:
        """Per-connection reader: hello handshake, then heartbeats /
        completions / fence notices until EOF."""
        hid = None
        try:
            f = sock.makefile("r", encoding="utf-8")
            for line in f:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if self._wedged:
                    # a wedged controller is the zombie under test: it
                    # neither applies messages nor renews leases
                    continue
                ev = msg.get("ev")
                if ev == "hello":
                    hid = self._host_hello(sock, msg)
                elif hid is None:
                    continue          # no handshake yet
                elif ev == "hb":
                    self._host_beat(hid, msg)
                elif ev == "done":
                    self._apply_done(hid, msg)
                elif ev == "fenced":
                    self._note_fenced(hid, msg)
        except OSError:
            pass
        finally:
            with self._lock:
                # only the host's CURRENT connection may declare it
                # lost: a replaced (reconnected) socket's late EOF
                # must not reap the live successor
                current = (hid is not None
                           and self._hosts.get(hid) is not None
                           and self._hosts[hid].sock is sock)
            if current and not self._shutdown:
                self._lose_host(hid, "socket_eof")
            try:
                sock.close()
            except OSError:
                pass

    def _host_hello(self, sock: socket.socket, msg: dict) -> str:
        hid = str(msg.get("host"))
        now = self._clock()
        rejoin = False
        if msg.get("pid") is not None:
            # the pid keys the host's rows in the merged fleet trace
            with self._obs_lock:
                self._host_pids[hid] = int(msg["pid"])
        with self._lock:
            prev = self._hosts.get(hid)
            rejoin = prev is not None
            host = _Host(hid, sock, now + self.host_ttl_s, self.epoch)
            self._hosts[hid] = host
            # sync: jobs the host is still running under a previous
            # controller (or a previous connection) stay ITS — adopt
            # the host's assignment token so its eventual completion
            # matches exactly; anything we don't know is ignored
            reported = set()
            for rec in msg.get("inflight", ()):
                fp = rec.get("fp")
                job = self._jobs.get(fp)
                if job is None or job.state in _TERMINAL:
                    continue
                reported.add(fp)
                if fp in self._pending:
                    self._pending.remove(fp)
                job.state = ASSIGNED
                job.host = hid
                job.assign_seq = rec.get("assign")
                job.assign_epoch = rec.get("epoch")
                host.inflight.add(fp)
            # a SAME-ID replacement process (operator respawn after a
            # kill -9 whose EOF we haven't seen yet) reports a fresh
            # inflight set: anything the PREVIOUS incarnation was
            # assigned but this one doesn't know died with it —
            # migrate now, or those jobs are stranded forever (the new
            # lease keeps renewing, so no reap would ever catch them)
            orphans, poisoned = [], []
            for fp in sorted(prev.inflight - reported) if prev else ():
                job = self._jobs.get(fp)
                if job is None or job.state in _TERMINAL:
                    continue
                job.migrations += 1
                job.host = None
                job.assign_seq = None
                job.assign_epoch = None
                if job.migrations >= self.poison_migrations:
                    # same poison fence as _lose_host: a job that
                    # kills its host every run must not keep cycling
                    # through same-id respawns forever
                    job.state = QUARANTINED
                    job.error = (f"quarantined after {job.migrations} "
                                 f"host losses (last: {hid}, "
                                 "host_replaced)")
                    poisoned.append(job)
                else:
                    job.state = QUEUED
                    self._pending.append(fp)
                    orphans.append(job)
            self.placement.add_host(hid)
            n_alive = sum(1 for h in self._hosts.values() if h.alive)
        for job in orphans:
            self.telemetry.count("jobs_migrated")
            obs.METRICS.inc("mdtpu_jobs_migrated_total")
            obs.span_event("job_migrated", host=hid, fp=job.fp,
                           tenant=job.tenant)
            self.journal.record("requeue", job.fp, from_host=hid,
                                reason="host_replaced")
        for job in poisoned:
            self.journal.record(
                "quarantine", job.fp,
                reason="poison_migrations:host_replaced", durable=True)
            obs.METRICS.inc("mdtpu_jobs_quarantined_total")
            job._settle()
            if job.parent is not None:
                self._merge_parent(job.parent)
            self._release_gated(job)
        self.telemetry.count("hosts_rejoined" if rejoin
                             else "hosts_joined")
        self.breakers.get(hid, mesh="fleet").record_success()
        obs.METRICS.set_gauge("mdtpu_hosts_alive", n_alive)
        obs.span_event("host_joined", host=hid, rejoin=rejoin,
                       epoch=self.epoch)
        self._log.info("host %s joined (epoch %d, %d alive)", hid,
                       self.epoch, n_alive)
        # completions the host could not deliver to the old controller
        for done in msg.get("done", ()):
            self._apply_done(hid, done)
        self._dispatch()
        return hid

    def _host_beat(self, hid: str, msg: dict | None = None) -> None:
        rejoined = False
        with self._lock:
            host = self._hosts.get(hid)
            if host is None:
                return
            host.deadline = self._clock() + self.host_ttl_s
            if not host.alive:
                # a lease-reaped host whose partition healed: it is a
                # member again (its migrated jobs stay migrated — the
                # assignment tokens moved on, so its late completions
                # fence out), and its breaker decides eligibility
                host.alive = True
                rejoined = True
                self.placement.add_host(hid)
                n_alive = sum(1 for h in self._hosts.values()
                              if h.alive)
        if rejoined:
            self.telemetry.count("hosts_rejoined")
            obs.METRICS.set_gauge("mdtpu_hosts_alive", n_alive)
            obs.span_event("host_joined", host=hid, rejoin=True,
                           epoch=self.epoch)
            self._log.warning("host %s rejoined after lease reap", hid)
            self._dispatch()
        if msg is not None:
            self._ingest_obs(hid, msg)

    # ---- metrics federation + trace stitching
    #      (docs/OBSERVABILITY.md "Fleet federation") ----

    def _ingest_obs(self, hid: str, msg: dict) -> None:
        """Fold one heartbeat's piggybacked federation payload in:
        ``metrics`` is a changed-series subset of the host's
        ``unified_snapshot`` (each series arrives WHOLE, so a lost
        heartbeat costs staleness, never counts — latest wins);
        ``trace`` is a bounded span batch, re-anchored from the host's
        wall clock onto this process's trace timeline at ingest."""
        metrics = msg.get("metrics")
        trace = msg.get("trace")
        if not metrics and not trace:
            return
        n_reporting = None
        overflow = 0
        with self._obs_lock:
            if metrics:
                self._host_metrics.setdefault(hid, {}).update(metrics)
                n_reporting = len(self._host_metrics)
            if trace:
                ctrl_wall0 = _spans.clock_info()[1]
                shift = (float(msg.get("wall0", ctrl_wall0))
                         - ctrl_wall0) * 1e6
                buf = self._host_events.setdefault(hid, [])
                for ev in trace:
                    if "ts" in ev:
                        ev = dict(ev)
                        ev["ts"] = round(ev["ts"] + shift, 1)
                    buf.append(ev)
                overflow = len(buf) - HOST_EVENTS_CAP
                if overflow > 0:
                    del buf[:overflow]
        if n_reporting is not None:
            obs.METRICS.set_gauge("mdtpu_fleet_hosts_reporting",
                                  n_reporting)
        if overflow > 0:
            obs.METRICS.inc("mdtpu_fleet_obs_trace_dropped_total",
                            overflow, site="controller")

    def _prune_host_gauges(self, hid: str) -> None:
        """Drop a LOST host's gauge-type series from its retained
        snapshot.  Counters and histograms stay (fleet totals must
        not dip on a crash), but a gauge is a point-in-time level of
        a process that no longer exists — keeping it would freeze a
        stale reading into the federated document forever, e.g. a bad
        ``mdtpu_slo_attainment`` that holds a burn-rate alert firing
        after every one of that host's jobs migrated and recovered."""
        with self._obs_lock:
            snap = self._host_metrics.get(hid)
            if not snap:
                return
            for name in [n for n, s in snap.items()
                         if isinstance(s, dict)
                         and s.get("type") == "gauge"]:
                del snap[name]

    def host_metrics(self) -> dict:
        """``{host_id: latest merged metric series}`` (copies).  A
        lost host's last-reported counter/histogram series stay —
        fleet totals must not dip when a host dies — while its gauges
        are pruned at the loss (see :meth:`_prune_host_gauges`)."""
        with self._obs_lock:
            return {hid: dict(m)
                    for hid, m in self._host_metrics.items()}

    def host_trace_events(self) -> dict:
        """``{host_id: [trace events]}`` buffered for the merged
        export, timestamps already on this controller's timeline
        (copies)."""
        with self._obs_lock:
            return {hid: [dict(ev) for ev in buf]
                    for hid, buf in self._host_events.items()}

    def fleet_snapshot(self) -> dict:
        """ONE metrics document over the whole fleet
        (``unified_snapshot(fleet=)`` merge rules: host counters and
        histograms summed, host gauges labeled ``host=``,
        controller-local series distinct) — what ``/metrics``
        exposes."""
        return obs.unified_snapshot(fleet=self.host_metrics())

    def usage_reconcile(self, baseline: dict | None = None) -> dict:
        """Audit the fleet-federated usage job meter against this
        controller's journal (exactly-once finish ledger): every
        accepted terminal record must appear as exactly one
        ``mdtpu_usage_jobs_total`` charge with the same tenant and
        outcome — exact across host kill -9 waves, because both sides
        are written at the same journal-then-ack boundary.  Emits the
        ``usage_reconciled`` span instant with the verdict."""
        res = obs.usage.reconcile(
            self.fleet_snapshot(),
            _journal.replay_fleet(self.journal.path),
            baseline=baseline)
        obs.span_event("usage_reconciled", ok=res["ok"],
                       jobs=sum(res["journal"].values()),
                       diff=len(res["diff"]))
        return res

    def export_fleet_trace(self, path: str) -> str | None:
        """Write ONE merged Chrome trace: this controller's own
        events (when it is tracing) plus every host's shipped
        batches, each process on its own pid row with a
        ``process_name`` label, timestamps on a shared axis (host
        batches were re-anchored at ingest; the whole document is
        shifted non-negative for adoption cases).  Returns the path,
        or None on a disclosed write failure."""
        events: list[dict] = []
        if obs.tracing_enabled():
            events.extend(dict(ev) for ev
                          in _spans.document()["traceEvents"])
        events.append({"ph": "M", "name": "process_name",
                       "pid": os.getpid(), "tid": 0,
                       "args": {"name": "fleet-controller"}})
        host_events = self.host_trace_events()
        for hid in sorted(host_events):
            evs = host_events[hid]
            with self._obs_lock:
                pid = self._host_pids.get(hid)
            if pid is None and evs:
                pid = evs[0].get("pid")
            if pid is not None:
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": f"fleet-host {hid}"}})
            events.extend(evs)
        tss = [ev["ts"] for ev in events if "ts" in ev]
        if tss and min(tss) < 0:
            base = min(tss)
            for ev in events:
                if "ts" in ev:
                    ev["ts"] = round(ev["ts"] - base, 1)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"tool": "mdanalysis_mpi_tpu_torch",
                             "controller_epoch": self.epoch,
                             "fleet_hosts": sorted(host_events)}}
        try:
            from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity

            _integrity.atomic_write_bytes(
                path, json.dumps(doc).encode(), artifact="fleet_trace")
        except OSError:
            obs.METRICS.inc("mdtpu_obs_write_errors_total",
                            sink="fleet_trace")
            return None
        return path

    def _note_fenced(self, hid: str, msg: dict) -> None:
        """A host refused a stale-epoch command (the zombie controller
        is still sending): count + disclose it here, on the CURRENT
        controller, where the operator is looking."""
        self.telemetry.count("epoch_fenced_rejects")
        obs.METRICS.inc("mdtpu_epoch_fenced_rejects_total",
                        reason="stale_epoch_cmd")
        obs.span_event("epoch_fenced_reject", host=hid,
                       reason="stale_epoch_cmd",
                       from_epoch=msg.get("from_epoch"))
        self._log.warning(
            "host %s fenced a stale-epoch command (epoch %s < %d)",
            hid, msg.get("from_epoch"), self.epoch)

    # ---- submission / dispatch ----

    def submit(self, spec: dict, tenant: str = "default",
               fingerprint: str | None = None) -> FleetJob:
        """Queue one job spec (the ``batch`` CLI's job schema plus the
        fleet fields ``fixture``, ``shards``, ``ensemble`` and
        ``ingest``).  Returns a waitable :class:`FleetJob`.  With
        ``shards=N`` the frame window is split into N contiguous
        sub-windows (``parallel.partition.shard_windows``) run as
        independent sub-jobs across the fleet, and the parent's
        results are the frame-axis concatenation of the shards' —
        time-series analyses only (per-frame rows), the task-parallel
        decomposition of PAPERS.md 1801.07630.  With ``ensemble``
        (an int member count or a list of per-member override dicts;
        docs/ENSEMBLE.md) the job fans into N per-trajectory member
        children — optionally preceded by a parallel store-first
        ``ingest`` pre-stage — and the parent's results are the
        cross-trajectory reduction (:func:`~mdanalysis_mpi_tpu_torch.
        service.ensemble.merge_member_results`)."""
        spec = dict(spec)
        tenant = str(spec.get("tenant", tenant))
        spec["tenant"] = tenant
        shards = int(spec.pop("shards", 0) or 0)
        ensemble = spec.pop("ensemble", None)
        if ensemble is not None and shards:
            from mdanalysis_mpi_tpu_torch.service.ensemble import (
                EnsembleSpecError,
            )

            raise EnsembleSpecError(
                "ensemble and shards are mutually exclusive on one "
                "job (shard the members' windows in a follow-up pass "
                "instead)")
        dispatchable: list[FleetJob] = []
        enqueue: list[FleetJob] = []
        quota_reject = False
        # fingerprint derivation AND registration under ONE lock
        # scope: two concurrent submits deriving the same auto
        # fingerprint would otherwise silently overwrite each other's
        # FleetJob (one handle orphaned forever, two journal submits
        # for one fp).  The counter survives deletes, unlike len().
        with self._lock:
            if self._shutdown:
                raise RuntimeError("fleet controller is shut down")
            # tenant inflight quota counts LOGICAL jobs — parents and
            # solo jobs, never children: a 10k-member ensemble is ONE
            # unit against its tenant's quota, exactly like one
            # trajectory (docs/ENSEMBLE.md "QoS accounting")
            if self.qos.tenant_quota is not None:
                live = sum(1 for j in self._jobs.values()
                           if j.tenant == tenant
                           and j.parent is None
                           and j.state not in _TERMINAL)
                quota_reject = live >= self.qos.tenant_quota
            if not quota_reject:
                if fingerprint is None:
                    fingerprint = (
                        f"{tenant}|{spec.get('analysis', '?')}"
                        f"#{self._job_seq}")
                self._job_seq += 1
                job = FleetJob(fingerprint, spec, tenant)
                job.submit_t = time.monotonic()
                if shards > 1:
                    self._register_sharded_locked(job, shards)
                    dispatchable = enqueue = job.children
                    if not dispatchable:
                        # an empty frame window shards into nothing:
                        # with no child to ever complete, the parent
                        # would hang drain()/wait() forever — fail it
                        # NOW, typed
                        job.state = FAILED
                        job.error = ("sharded window is empty (no "
                                     "frames between start and stop)")
                elif ensemble is not None:
                    self._register_ensemble_locked(job, ensemble)
                    dispatchable = (list(job.ingest_children or ())
                                    + list(job.children))
                    gated = set(self._gated.values())
                    enqueue = [d for d in dispatchable
                               if d.fp not in gated]
                else:
                    self._jobs[fingerprint] = job
                    dispatchable = enqueue = [job]
        if quota_reject:
            from mdanalysis_mpi_tpu_torch.service.jobs import (
                AdmissionRejectedError,
            )

            self.telemetry.count("admission_rejects")
            obs.METRICS.inc("mdtpu_admission_rejects_total",
                            reason="tenant_quota")
            obs.span_event("admission_reject", tenant=tenant,
                           reason="tenant_quota")
            raise AdmissionRejectedError(
                f"tenant {tenant!r} is at its inflight quota of "
                f"{self.qos.tenant_quota} logical job(s) — an "
                "ensemble counts as one", reason="tenant_quota")
        if shards > 1 and not dispatchable:
            job._settle()
            return job
        if ensemble is not None:
            self.telemetry.count("ensembles_submitted")
            self.telemetry.count("ensemble_members",
                                 len(job.children))
            obs.METRICS.inc("mdtpu_ensemble_jobs_total")
            obs.METRICS.inc("mdtpu_ensemble_members_total",
                            len(job.children))
            obs.span_event("ensemble_submitted", fp=job.fp,
                           tenant=tenant, members=len(job.children),
                           ingest=len(job.ingest_children or ()))
        # journal the spec-bearing submit record BEFORE the job
        # becomes dispatchable: the supervisor tick can assign within
        # milliseconds, and a crash after its `assign` but before this
        # `submit` would leave adopt() a claimed job with no spec —
        # unrecoverable work despite the journal contract
        for d in dispatchable:
            d.submit_t = job.submit_t
            self.telemetry.count("jobs_submitted")
            self.journal.record("submit", d.fp, tenant=d.tenant,
                                spec=d.spec)
        with self._lock:
            for d in enqueue:
                self._pending.append(d.fp)
        self._dispatch()
        # overload check after the enqueue (docs/RELIABILITY.md §7):
        # a burst that outran every host slot sheds the lowest
        # sheddable class NOW, not a supervisor tick later
        self._shed_pending()
        return job

    def _register_sharded_locked(self, parent: FleetJob,
                                 shards: int) -> None:
        # caller holds self._lock
        from mdanalysis_mpi_tpu_torch.parallel.partition import shard_windows

        spec = parent.spec
        n_frames = spec.get("fixture", {}).get("n_frames")
        # a store-backed tenant shards on CHUNK boundaries
        # (docs/STORE.md): each shard child then fetches whole chunks
        # and no chunk is read by two hosts — and the manifest bounds
        # an otherwise-open window, so store jobs shard without an
        # explicit stop
        chunk_frames = None
        store = _store_meta(spec)
        if store is not None:
            chunk_frames = store["chunk_frames"]
            if n_frames is None:
                n_frames = store["n_frames"]
        windows = shard_windows(n_frames, spec.get("start"),
                                spec.get("stop"), spec.get("step"),
                                shards, chunk_frames=chunk_frames)
        parent.children = []
        for i, win in enumerate(windows):
            if win is None:
                continue
            sub = {k: v for k, v in spec.items()}
            sub["start"], sub["stop"], sub["step"] = win
            child = FleetJob(f"{parent.fp}/s{i}", sub, parent.tenant)
            child.parent = parent
            child.shard_index = i
            parent.children.append(child)
        self._jobs[parent.fp] = parent
        for child in parent.children:
            self._jobs[child.fp] = child

    def _register_ensemble_locked(self, parent: FleetJob,
                                  ensemble) -> None:
        # caller holds self._lock.  Trajectory-set fan-out
        # (docs/ENSEMBLE.md): one member-analysis child per
        # trajectory, each routed by its OWN placement key (spreading
        # the set over the fleet, like shards spread one window) —
        # optionally preceded by a store-first ingest pre-stage child
        # per member that GATES the member: the member is registered
        # and journaled now but enters the pending queue only when
        # its ingest child lands DONE (self._gated).
        from mdanalysis_mpi_tpu_torch.service.ensemble import (
            EnsembleSpecError, expand_ensemble, member_store,
        )

        spec = dict(parent.spec)
        spec["ensemble"] = ensemble
        members = expand_ensemble(spec)     # typed EnsembleSpecError
        ingest_cfg = spec.get("ingest")
        if ingest_cfg is not None and (
                not isinstance(ingest_cfg, dict)
                or not ingest_cfg.get("out_root")):
            raise EnsembleSpecError(
                "ensemble ingest must be a dict with out_root (the "
                f"member stores' root directory), got {ingest_cfg!r}")
        parent.children = []
        parent.ingest_children = []
        for i, sub in enumerate(members):
            sub["tenant"] = parent.tenant
            src = sub.get("trajectory")
            if ingest_cfg is not None and src:
                dest = member_store(ingest_cfg["out_root"], i)
                icfg = {"trajectory": src, "out": dest,
                        "out_root": ingest_cfg["out_root"]}
                for k in ("chunk_frames", "quant", "stop"):
                    if ingest_cfg.get(k) is not None:
                        icfg[k] = ingest_cfg[k]
                ispec = {"tenant": parent.tenant, "ingest": icfg}
                if "qos" in sub:
                    ispec["qos"] = sub["qos"]
                ij = FleetJob(f"{parent.fp}/i{i}", ispec,
                              parent.tenant)
                ij.member_index = i
                ij.placement_key = f"{parent.tenant}@i{i}"
                parent.ingest_children.append(ij)
                # the member reads the ingested store, and KEEPS the
                # ingest block on its journaled spec: a member
                # re-dispatched after a controller restart can
                # ensure-store idempotently instead of finding a
                # missing directory
                sub["trajectory"] = dest
                sub["ingest"] = icfg
                self._gated[ij.fp] = f"{parent.fp}/m{i}"
            child = FleetJob(f"{parent.fp}/m{i}", sub, parent.tenant)
            child.parent = parent
            child.member_index = i
            # members route by (tenant, trajectory): distinct
            # trajectories spread across the fleet, while a re-submit
            # of the same member lands back on the host that already
            # holds its store resident
            child.placement_key = (
                f"{parent.tenant}@"
                f"{sub.get('trajectory') or f'm{i}'}")
            parent.children.append(child)
        self._jobs[parent.fp] = parent
        for child in parent.children:
            self._jobs[child.fp] = child
        for ij in parent.ingest_children:
            self._jobs[ij.fp] = ij

    def _ordered_pending_locked(self) -> list[str]:
        """The pending queue in weighted-fair class order
        (docs/RELIABILITY.md §7): stride-pick a class, take its FIFO
        head, repeat — so an interactive backlog is dispatched ~its
        weight-share ahead of batch/background without ever starving
        them.  One class present → plain FIFO, the pre-QoS order."""
        by_class: dict[str, list[str]] = {}
        for fp in self._pending:
            job = self._jobs.get(fp)
            qos_cls = job.qos if job is not None else "batch"
            by_class.setdefault(qos_cls, []).append(fp)
        if len(by_class) <= 1:
            return list(self._pending)
        ordered: list[str] = []
        while True:
            candidates = sorted(c for c, fps in by_class.items()
                                if fps)
            if not candidates:
                return ordered
            cls = self._stride.pick(candidates)
            ordered.append(by_class[cls].pop(0))

    def _slots_free_locked(self, host: "_Host") -> bool:
        return (self.host_slots is None
                or len(host.inflight) < self.host_slots)

    def _dispatch(self) -> None:
        """Assign pending jobs to their tenants' home hosts (sticky
        placement), weighted-fair across QoS classes, bounded by
        ``host_slots``.  Socket sends and journal records run OUTSIDE
        the lock; a failed send loses the host (which re-pends the
        job)."""
        if self._wedged:
            return
        sends = []
        with self._lock:
            if self.host_slots is not None and self._pending:
                free = sum(
                    max(0, self.host_slots - len(h.inflight))
                    for h in self._hosts.values()
                    if h.alive and h.hid not in self._retiring)
                if free == 0:
                    # every slot busy: nothing can place, so skip the
                    # O(pending) weighted-fair reorder entirely — a
                    # standing backlog must not pay it (and distort
                    # the stride passes) on every completion ack
                    return
            still = []
            for fp in self._ordered_pending_locked():
                job = self._jobs.get(fp)
                if job is None or job.state in _TERMINAL:
                    continue
                # a sharded child routes by (tenant, shard), an
                # ensemble child by its (tenant, trajectory)
                # placement_key: the whole point of either fan-out is
                # spreading one tenant's work over the fleet, so the
                # children must not all ride the tenant's sticky home
                key = job.placement_key or (
                    job.tenant if job.shard_index is None
                    else f"{job.tenant}#s{job.shard_index}")
                hid = self.placement.assign(key)
                host = self._hosts.get(hid) if hid else None
                if host is None or not host.alive \
                        or not self._slots_free_locked(host):
                    # degraded to zero hosts, or the sticky home is at
                    # its slot cap: park — the backlog this creates is
                    # exactly the autoscaler's and the shed ladder's
                    # input signal
                    still.append(fp)
                    continue
                self._assign_seq += 1
                job.state = ASSIGNED
                job.host = hid
                job.assign_seq = self._assign_seq
                job.assign_epoch = self.epoch
                host.inflight.add(fp)
                sends.append((host, job,
                              {"cmd": "run", "fp": fp,
                               "assign": job.assign_seq,
                               "epoch": self.epoch,
                               "job": job.spec}))
            self._pending[:] = still
        lost = set()
        for host, job, msg in sends:
            self.journal.record("assign", job.fp, host=host.hid)
            if host.hid not in lost and \
                    not _send_line(host.sock, host.send_lock, msg):
                lost.add(host.hid)
        for hid in lost:
            self._lose_host(hid, "send_failed")

    # ---- completion application (exactly-once) ----

    def _apply_done(self, hid: str, msg: dict) -> None:
        """Apply one host completion iff its ``(host, epoch, assign)``
        token IS the job's current assignment — the epoch fence, one
        level up from ``Scheduler._complete``'s lease token.  A zombie
        host's completion for a migrated job, or any stale-epoch
        leftover, is rejected and counted; a duplicate re-delivery of
        the ALREADY-APPLIED completion (the host resends until acked)
        is re-acked silently."""
        fp = msg.get("fp")
        token = (hid, msg.get("epoch"), msg.get("assign"))
        reject = None
        with self._lock:
            job = self._jobs.get(fp)
            if job is None:
                reject = "unknown_job"
            elif job.state in _TERMINAL:
                cur = (job.host, job.assign_epoch, job.assign_seq)
                reject = "duplicate" if cur == token else \
                    "stale_assignment"
            elif (job.host, job.assign_epoch,
                  job.assign_seq) != token:
                if job.host is None and \
                        (msg.get("epoch") or 0) <= self.epoch:
                    # adoption: a journal-recovered job no controller
                    # has re-dispatched, completed by the host that
                    # was running it under the old epoch — honoring
                    # it IS exactly-once (re-running would not be).
                    # The job adopts the host's token.
                    job.host, job.assign_epoch, job.assign_seq = token
                    if fp in self._pending:
                        self._pending.remove(fp)
                else:
                    reject = ("stale_epoch"
                              if (msg.get("epoch") or 0) < self.epoch
                              and job.assign_epoch != msg.get("epoch")
                              else "stale_assignment")
            if reject is None:
                job.state = DONE if msg.get("state") == "done" \
                    else FAILED
                job.results = msg.get("results")
                job.error = msg.get("error")
                job.resident = msg.get("resident")
                host = self._hosts.get(hid)
                if host is not None:
                    host.inflight.discard(fp)
                    host.deadline = self._clock() + self.host_ttl_s
        ack = {"cmd": "ack", "fp": fp}
        host = self._hosts.get(hid)
        if reject is not None:
            if reject != "duplicate":
                self.telemetry.count("epoch_fenced_rejects")
                obs.METRICS.inc("mdtpu_epoch_fenced_rejects_total",
                                reason=reject)
                obs.span_event("epoch_fenced_reject", host=hid,
                               fp=fp, reason=reject)
                self._log.warning(
                    "rejected completion of %s from %s (%s): token "
                    "%r is not the current assignment", fp, hid,
                    reject, token)
            if host is not None:
                _send_line(host.sock, host.send_lock, ack)
            return
        # accepted: durable terminal record BEFORE the ack — exactly
        # the journal-then-ack order that makes re-delivery idempotent
        # across controller crashes (replay sees the finish; the
        # resent completion is rejected as duplicate)
        self.journal.record("finish", fp, state=job.state,
                            durable=True)
        # usage: the job meter mirrors the journal's exactly-once
        # finish ledger — one charge per accepted terminal record,
        # same tenant/outcome (reconciled by usage_reconcile())
        obs.usage.LEDGER.charge_job(job.tenant, job.qos, job.state)
        self.telemetry.count("jobs_completed" if job.state == DONE
                             else "jobs_failed")
        if job.resident is not None:
            self.telemetry.count("home_hits" if job.resident
                                 else "home_misses")
        self.breakers.get(hid, mesh="fleet").record_success()
        if host is not None:
            _send_line(host.sock, host.send_lock, ack)
        if job.member_index is not None and job.parent is not None:
            self.telemetry.count("ensemble_members_completed"
                                 if job.state == DONE
                                 else "ensemble_members_failed")
            obs.METRICS.inc("mdtpu_ensemble_members_completed_total",
                            state=job.state)
        job._settle()
        if job.parent is not None:
            self._merge_parent(job.parent)
        self._release_gated(job)
        self._dispatch()

    def _merge_parent(self, parent: FleetJob) -> None:
        """Complete a fanned-out parent once every child is terminal.
        Sharded parents get the frame-axis concatenation of the
        shards' result arrays, in shard order (partition-aware merge
        — the map-reduce half of the task-parallel decomposition);
        ensemble parents get the cross-trajectory reduction
        (:func:`~mdanalysis_mpi_tpu_torch.service.ensemble.
        merge_member_results`: pooled-Welford RMSF, frame-weighted
        RDF, pairwise mean-structure RMSD, per-member fan-out) plus
        the ingest pre-stage's dedup ledger."""
        import numpy as np

        merged_ok = False
        with self._lock:
            children = list(parent.children or ())
            if parent.state in _TERMINAL or \
                    not all(c.done() for c in children):
                return
            failed = [c for c in children if c.state != DONE]
            ensemble = any(c.member_index is not None
                           for c in children)
            if failed:
                parent.state = FAILED
                parent.error = (
                    f"{len(failed)} "
                    f"{'member' if ensemble else 'shard'}(s) failed: "
                    f"{failed[0].error}")
            elif ensemble:
                from mdanalysis_mpi_tpu_torch.service.ensemble import (
                    merge_member_results,
                )

                ordered = sorted(children,
                                 key=lambda c: c.member_index)
                try:
                    merged = merge_member_results(
                        [(c.member_index, c.spec, c.results or {})
                         for c in ordered])
                except Exception as exc:      # malformed member data
                    parent.state = FAILED
                    parent.error = (f"ensemble merge failed: "
                                    f"{type(exc).__name__}: {exc}")
                else:
                    # fold the ingest pre-stage's dedup ledger into
                    # the parent's results — the replica-dedup
                    # disclosure the bench leg and the chaos test
                    # read off the merged job
                    ing = [j for j in (parent.ingest_children or ())
                           if j.state == DONE and j.results]
                    if ing:
                        tb = sum(float(j.results.get("bytes", 0)
                                       or 0) for j in ing)
                        db = sum(float(j.results.get("dedup_bytes",
                                                     0) or 0)
                                 for j in ing)
                        merged["ensemble_ingest_members"] = len(ing)
                        merged["ensemble_ingest_bytes"] = tb
                        merged["ensemble_ingest_dedup_bytes"] = db
                        merged["ensemble_ingest_dedup_chunks"] = sum(
                            int(j.results.get("dedup_chunks", 0)
                                or 0) for j in ing)
                        merged["ensemble_dedup_ratio"] = (
                            round(db / tb, 4) if tb else 0.0)
                    parent.state = DONE
                    parent.results = merged
                    merged_ok = True
            else:
                merged: dict = {}
                ordered = sorted(children,
                                 key=lambda c: c.shard_index)
                for name in (ordered[0].results or {}):
                    try:
                        arrays = [np.asarray(c.results[name])
                                  for c in ordered]
                        # a concatenation is only a correct merge when
                        # each shard's leading axis IS its frame
                        # window — anything else (per-atom RMSF, a
                        # scalar) would concat fine and be silently
                        # WRONG, the exact failure class PR-9 forbids
                        for c, arr in zip(ordered, arrays):
                            n = len(range(c.spec["start"],
                                          c.spec["stop"],
                                          c.spec["step"]))
                            if arr.ndim == 0 or arr.shape[0] != n:
                                raise ValueError(
                                    f"shard {c.shard_index} produced "
                                    f"shape {arr.shape}, not a "
                                    f"{n}-frame series")
                        merged[name] = np.concatenate(
                            arrays, axis=0).tolist()
                    except (KeyError, ValueError) as exc:
                        parent.state = FAILED
                        parent.error = (
                            f"shard merge failed for {name!r}: {exc} "
                            "(sharded jobs must produce per-frame "
                            "series)")
                        break
                else:
                    parent.state = DONE
                    parent.results = merged
        if merged_ok:
            self.telemetry.count("ensemble_merges")
            obs.METRICS.inc("mdtpu_ensemble_merges_total")
            ratio = (parent.results or {}).get(
                "ensemble_dedup_ratio")
            if ratio is not None:
                obs.METRICS.set_gauge("mdtpu_ensemble_dedup_ratio",
                                      float(ratio))
            obs.span_event("ensemble_merged", fp=parent.fp,
                           members=len(parent.children or ()))
        parent._settle()

    def _release_gated(self, job: FleetJob) -> None:
        """An ingest pre-stage child reached a terminal state: open
        (or fail) the member-analysis job it gates.  DONE → the
        member enters the pending queue and dispatches; any other
        terminal (failed / shed / quarantined) → the member fails
        typed NOW — its store never materialized, so dispatching it
        would burn a host timeout to learn the same thing."""
        dispatch = False
        fail_member: FleetJob | None = None
        with self._lock:
            member_fp = self._gated.pop(job.fp, None)
            if member_fp is None:
                return
            member = self._jobs.get(member_fp)
            if member is None or member.state in _TERMINAL:
                return
            if job.state == DONE:
                self._pending.append(member_fp)
                dispatch = True
            else:
                member.state = FAILED
                member.error = (f"ingest pre-stage {job.fp} "
                                f"{job.state}: {job.error}")
                fail_member = member
        if dispatch:
            self._dispatch()
            return
        # failing the member is itself a terminal transition: journal
        # it durably (exactly-once on replay), count it, and let the
        # parent merge observe the failure
        self.journal.record("finish", fail_member.fp, state=FAILED,
                            durable=True)
        obs.usage.LEDGER.charge_job(fail_member.tenant,
                                    fail_member.qos, FAILED)
        self.telemetry.count("jobs_failed")
        self.telemetry.count("ensemble_members_failed")
        obs.METRICS.inc("mdtpu_ensemble_members_completed_total",
                        state=FAILED)
        fail_member._settle()
        if fail_member.parent is not None:
            self._merge_parent(fail_member.parent)

    # ---- host loss / migration ----

    def _lose_host(self, hid: str, reason: str) -> None:
        with self._lock:
            host = self._hosts.get(hid)
            if host is None or not host.alive or self._shutdown \
                    or self._wedged:
                # a wedged (zombie) controller must not act on the
                # fleet — migration is the adopting standby's job
                return
            host.alive = False
            self._retiring.pop(hid, None)   # a killed retiring host
            #                                 is a LOSS, not a retire
            self.placement.remove_host(hid)
            migrate, quarantine = [], []
            for fp in sorted(host.inflight):
                job = self._jobs.get(fp)
                if job is None or job.state in _TERMINAL:
                    continue
                job.migrations += 1
                job.state = QUEUED
                # the assignment token moves on NOW: the dead/zombie
                # host's eventual completion can no longer match
                job.host = None
                job.assign_seq = None
                job.assign_epoch = None
                if job.migrations >= self.poison_migrations:
                    quarantine.append(job)
                else:
                    migrate.append(job)
                    self._pending.append(fp)
            host.inflight.clear()
            n_alive = sum(1 for h in self._hosts.values() if h.alive)
        self.telemetry.count("hosts_lost")
        self._prune_host_gauges(hid)
        obs.METRICS.inc("mdtpu_hosts_lost_total", reason=reason)
        obs.METRICS.set_gauge("mdtpu_hosts_alive", n_alive)
        obs.span_event("host_lost", host=hid, reason=reason,
                       n_migrated=len(migrate))
        self.breakers.get(hid, mesh="fleet").record_failure()
        self._log.warning(
            "host %s lost (%s): %d job(s) migrating to %d survivor(s)",
            hid, reason, len(migrate), n_alive)
        # black box for the loss (docs/OBSERVABILITY.md): recent
        # timeline + fleet counters at the moment of the incident,
        # journaled so the post-mortem can find it from the replay
        fpath = _flight.dump(
            "host_loss", self.workdir,
            extra={"host": hid, "reason": reason,
                   "migrated": [j.fp for j in migrate],
                   "quarantined": [j.fp for j in quarantine]})
        if fpath:
            self.journal.record("flight", None, trigger="host_loss",
                                path=fpath, host=hid)
        for job in migrate:
            self.telemetry.count("jobs_migrated")
            obs.METRICS.inc("mdtpu_jobs_migrated_total")
            obs.span_event("job_migrated", host=hid, fp=job.fp,
                           tenant=job.tenant)
            self.journal.record("requeue", job.fp, from_host=hid,
                                reason=reason)
        for job in quarantine:
            with self._lock:
                job.state = QUARANTINED
                job.error = (f"quarantined after {job.migrations} "
                             f"host losses (last: {hid}, {reason})")
            self.journal.record("quarantine", job.fp,
                                reason=f"poison_migrations:{reason}",
                                durable=True)
            obs.usage.LEDGER.charge_job(job.tenant, job.qos,
                                        QUARANTINED)
            obs.METRICS.inc("mdtpu_jobs_quarantined_total")
            job._settle()
            if job.parent is not None:
                # a quarantined shard is its parent's LAST terminal
                # child as far as _apply_done is concerned — without
                # this, the parent never resolves and drain() hangs
                self._merge_parent(job.parent)
            self._release_gated(job)
        if self.respawn_hosts and not self._shutdown:
            # the replacement serves on the controller's device
            self.spawn_host()
        self._dispatch()

    # ---- overload shedding (docs/RELIABILITY.md §7) ----

    def _shed_pending(self) -> list[FleetJob]:
        """One controller-tier shed pass: when the PENDING backlog
        (jobs no host slot could take) exceeds
        ``QosPolicy.shed_queue_depth``, drop the lowest sheddable
        class first — newest first within a class, never a class
        outside ``shed_classes`` — each with a journaled terminal
        ``shed`` record (exactly-once ledger entry) and the
        ``mdtpu_jobs_shed_total{class=}`` counter.  Journal writes
        run OUTSIDE the lock."""
        p = self.qos
        if p.shed_queue_depth is None:
            return []
        sheds: list[FleetJob] = []
        with self._lock:
            if self._wedged or self._shutdown:
                return []
            depth = len(self._pending)
            if depth <= p.shed_queue_depth:
                return []
            # capacity predicate (the fleet twin of the scheduler's
            # _overloaded_locked): depth with ZERO alive hosts is the
            # degraded-to-zero rung — the placement ladder PARKS
            # there, never sheds — and depth with a free slot
            # anywhere (or no slot bound at all) is a dispatch in
            # flight, not overload.  Only a backlog every alive host
            # slot cannot absorb is policy-sheddable.
            alive = [h for h in self._hosts.values()
                     if h.alive and h.hid not in self._retiring]
            if not alive or self.host_slots is None or any(
                    len(h.inflight) < self.host_slots
                    for h in alive):
                return []
            for qos_cls in p.shed_ladder():
                for fp in list(reversed(self._pending)):
                    if len(self._pending) <= p.shed_queue_depth:
                        break
                    job = self._jobs.get(fp)
                    if job is None or job.state in _TERMINAL \
                            or job.qos != qos_cls:
                        continue
                    self._pending.remove(fp)
                    job.state = SHED
                    job.error = (
                        f"shed by the overload controller (class "
                        f"{qos_cls}: backlog {depth} > "
                        f"{p.shed_queue_depth}); resubmit once the "
                        "burst passes")
                    sheds.append(job)
        for job in sheds:
            self.telemetry.count("jobs_shed")
            obs.METRICS.inc("mdtpu_jobs_shed_total",
                            **{"class": job.qos})
            obs.span_event("job_shed", fp=job.fp, tenant=job.tenant,
                           qos=job.qos)
            # terminal record, durable: the exactly-once audit counts
            # sheds like any other settled outcome, and a recovering
            # controller must not re-own a job the policy dropped
            self.journal.record("finish", job.fp, state=SHED,
                                durable=True)
            obs.usage.LEDGER.charge_job(job.tenant, job.qos, SHED)
            job._settle()
            if job.parent is not None:
                self._merge_parent(job.parent)
            self._release_gated(job)
        if sheds:
            self._log.warning(
                "overload: shed %d pending job(s) (classes %s) — "
                "backlog over %d with every host slot in use",
                len(sheds), sorted({j.qos for j in sheds}),
                p.shed_queue_depth)
        return sheds

    # ---- autoscaling (docs/RELIABILITY.md §7) ----

    def _autoscale_tick(self, now: float) -> None:
        """One autoscaler pass, from signals the controller already
        owns: the pending backlog (jobs no host slot could take —
        the queue-depth signal) and per-host slot occupancy (the
        lease-utilization signal).  Scale-up spawns; scale-down is
        DRAIN-FIRST retirement (see :meth:`_retire_host`)."""
        if not self.autoscale or self._shutdown or self._wedged:
            return
        spawn = False
        retire_hid = None
        finish = []
        with self._lock:
            alive = [h for h in self._hosts.values()
                     if h.alive and h.hid not in self._retiring]
            pending = len(self._pending)
            # spawned-but-not-yet-joined children count as capacity
            # in flight, or one burst would spawn max_hosts at once
            joining = sum(
                1 for pr in self._procs
                if pr.poll() is None
                and getattr(pr, "_mdtpu_host_id", None)
                not in self._hosts)
            # drain-finished (or drain-expired) retirements
            for hid, deadline in list(self._retiring.items()):
                host = self._hosts.get(hid)
                if host is None or not host.alive:
                    self._retiring.pop(hid, None)
                    continue
                if not host.inflight or now >= deadline:
                    finish.append(hid)
            if pending > 0:
                self._idle_since = None
            elif self._idle_since is None:
                self._idle_since = now
            cooled = now - self._scale_last >= self.scale_cooldown_s
            if (pending >= self.scale_up_backlog
                    and len(alive) + joining < self.max_hosts
                    and cooled):
                spawn = True
                self._scale_last = now
            elif (pending == 0 and not self._retiring and cooled
                  and len(alive) > self.min_hosts
                  and self._idle_since is not None
                  and now - self._idle_since >= self.scale_down_idle_s):
                # retire the emptiest host: fewest in-flight jobs →
                # fewest tenants disturbed, shortest drain
                retire_hid = min(alive,
                                 key=lambda h: (len(h.inflight),
                                                h.hid)).hid
                self._scale_last = now
        for hid in finish:
            self._finish_retire(hid)
        if spawn:
            proc = self.spawn_host(**self.autoscale_spawn)
            hid = proc._mdtpu_host_id
            self.telemetry.count("hosts_scaled_up")
            obs.METRICS.inc("mdtpu_hosts_scaled_up_total")
            obs.span_event("host_scaled_up", host=hid,
                           pending=pending)
            self.journal.record("scale_up", None, host=hid,
                                pending=pending)
            self._log.warning(
                "autoscale: spawned %s (backlog %d over %d host(s))",
                hid, pending, len(alive))
        elif retire_hid is not None:
            self._retire_host(retire_hid)

    def _retire_host(self, hid: str) -> None:
        """Begin drain-first retirement: the host leaves placement NOW
        (new work re-derives homes minimally — only ITS tenants move,
        the rendezvous property), takes no new assignments, and keeps
        running what it holds until empty or ``retire_drain_s``
        expires."""
        with self._lock:
            host = self._hosts.get(hid)
            if host is None or not host.alive \
                    or hid in self._retiring:
                return
            self._retiring[hid] = self._clock() + self.retire_drain_s
            self.placement.remove_host(hid)
            inflight = len(host.inflight)
        obs.span_event("host_retiring", host=hid, inflight=inflight)
        self._log.warning(
            "autoscale: retiring %s drain-first (%d job(s) still "
            "in flight)", hid, inflight)

    def _finish_retire(self, hid: str) -> None:
        """Complete a retirement: migrate whatever the drain deadline
        left in flight (the PR-10 journal-level exactly-once path —
        requeue records, new assignment tokens, so the stopping
        host's late completions fence out), stop the host process,
        and journal the epoch-stamped ``scale_down`` record."""
        migrate = []
        with self._lock:
            host = self._hosts.get(hid)
            self._retiring.pop(hid, None)
            if host is None or not host.alive:
                return
            host.alive = False     # before the stop: the socket EOF
            #                        path must not double-lose it
            for fp in sorted(host.inflight):
                job = self._jobs.get(fp)
                if job is None or job.state in _TERMINAL:
                    continue
                job.migrations += 1
                job.state = QUEUED
                job.host = None
                job.assign_seq = None
                job.assign_epoch = None
                migrate.append(job)
                self._pending.append(fp)
            host.inflight.clear()
            n_alive = sum(1 for h in self._hosts.values() if h.alive)
        for job in migrate:
            self.telemetry.count("jobs_migrated")
            obs.METRICS.inc("mdtpu_jobs_migrated_total")
            obs.span_event("job_migrated", host=hid, fp=job.fp,
                           tenant=job.tenant)
            self.journal.record("requeue", job.fp, from_host=hid,
                                reason="scale_down")
        _send_line(host.sock, host.send_lock,
                   {"cmd": "stop", "epoch": self.epoch})
        # a retired process's gauge levels are as dead as a crashed
        # one's: prune them like _lose_host does, or a bad last-ship
        # (queue depth, attainment) stays frozen in the federated
        # snapshot and holds alerts firing forever
        self._prune_host_gauges(hid)
        self.telemetry.count("hosts_scaled_down")
        obs.METRICS.inc("mdtpu_hosts_scaled_down_total")
        obs.METRICS.set_gauge("mdtpu_hosts_alive", n_alive)
        obs.span_event("host_scaled_down", host=hid,
                       migrated=len(migrate))
        self.journal.record("scale_down", None, host=hid,
                            migrated=len(migrate))
        self._log.warning(
            "autoscale: retired %s (%d alive, %d job(s) migrated "
            "at the drain deadline)", hid, n_alive, len(migrate))
        if migrate:
            self._dispatch()

    # ---- supervisor ----

    def _supervisor(self) -> None:
        while True:
            time.sleep(self.tick_s)
            if self._shutdown:
                return
            if self._wedged:
                continue
            now = self._clock()
            with self._lock:
                expired = [h.hid for h in self._hosts.values()
                           if h.alive and h.deadline <= now]
                dead_procs = [
                    getattr(p, "_mdtpu_host_id", None)
                    for p in self._procs
                    if p.poll() is not None
                    and getattr(p, "_mdtpu_host_id", None)
                    in self._hosts
                    and self._hosts[p._mdtpu_host_id].alive]
            for hid in expired:
                self._lose_host(hid, "lease_expired")
            for hid in dead_procs:
                if hid is not None:
                    self._lose_host(hid, "host_death")
            self._dispatch()
            # QoS + elasticity ticks (docs/RELIABILITY.md §7): shed
            # what capacity cannot absorb, then breathe the host set
            self._shed_pending()
            self._autoscale_tick(now)
            # alert tick (obs/alerts.py): the rules read the MERGED
            # fleet snapshot — the same document /metrics exposes
            self._alert_tick(now)

    def _alert_tick(self, now: float | None = None,
                    force: bool = False) -> list:
        """Evaluate the alert rules over the federated snapshot (the
        supervisor calls this every tick; the interval bound keeps
        the merge cost off the tick cadence).  Returns this tick's
        transitions."""
        if self.alerts is None:
            return []
        if now is None:
            now = self._clock()
        if not force and now - self._alert_last < self.alert_interval_s:
            return []
        self._alert_last = now
        snap = self.fleet_snapshot()
        # the controller's OWN backlog (jobs no host slot could take)
        # is the fleet-tier saturation signal, and it lives in neither
        # the host snapshots nor FleetTelemetry — overlay it as the
        # unlabeled mdtpu_queue_depth series (hosts' depths arrive
        # labeled host=, distinct) so queue_saturated sees the fleet
        # actually saturating, not just each host's bounded local queue
        with self._lock:
            pending = len(self._pending)
        snap.setdefault("mdtpu_queue_depth",
                        {"type": "gauge", "values": {}})
        if snap["mdtpu_queue_depth"]["type"] == "gauge":
            snap["mdtpu_queue_depth"]["values"][""] = pending
        return self.alerts.evaluate(snap, now=now)

    # ---- lifecycle ----

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted job is terminal."""
        deadline = None if timeout is None else self._clock() + timeout
        while True:
            with self._lock:
                jobs = list(self._jobs.values())
            open_jobs = [j for j in jobs if not j.done()]
            if not open_jobs:
                return True
            if deadline is not None and self._clock() >= deadline:
                return False
            open_jobs[0].wait(0.05)

    def wedge(self) -> None:
        """Chaos hook: this controller stops processing — incoming
        messages are dropped, leases stop renewing, dispatch stops —
        but its sockets and journal stay OPEN: the zombie-controller
        shape epoch fencing exists for."""
        with self._lock:
            self._wedged = True
        self._log.error("controller (epoch %d) wedged — standing by "
                        "for adoption", self.epoch)

    def zombie_send(self, host_id: str, spec: dict | None = None) -> bool:
        """Chaos hook for a WEDGED controller: send one (stale-epoch)
        run command down its old socket to ``host_id``, as a zombie
        that briefly wakes would.  Returns whether the bytes left."""
        with self._lock:
            host = self._hosts.get(host_id)
        if host is None:
            return False
        return _send_line(host.sock, host.send_lock, {
            "cmd": "run", "fp": f"zombie-{self.epoch}",
            "assign": -1, "epoch": self.epoch,
            "job": spec or {"analysis": "rmsf"}})

    def jobs(self) -> dict:
        """``{fingerprint: FleetJob}`` snapshot (a standby's adopted
        jobs are ITS objects — the failover tests read results from
        the adopting controller, not the wedged one)."""
        with self._lock:
            return dict(self._jobs)

    def status(self) -> dict:
        """The ``/status`` document (service/statusd.py): queue
        depth, per-host membership/leases, breaker states, epoch,
        quarantine — what an operator greps per-host logs for
        today, as one JSON fetch."""
        now = self._clock()
        with self._lock:
            hosts = {
                h.hid: {"alive": h.alive,
                        "inflight": len(h.inflight),
                        "lease_expires_in_s": round(h.deadline - now,
                                                    3),
                        "epoch": h.epoch}
                for h in self._hosts.values()}
            jobs = list(self._jobs.values())
            pending = len(self._pending)
            by_class: dict = {}
            for fp in self._pending:
                j = self._jobs.get(fp)
                if j is not None:
                    by_class[j.qos] = by_class.get(j.qos, 0) + 1
            retiring = sorted(self._retiring)
            wedged = self._wedged
        out = {
            "role": "fleet-controller",
            "epoch": self.epoch,
            "wedged": wedged,
            "workdir": self.workdir,
            "addr": f"{self.address[0]}:{self.address[1]}",
            "queue_depth": pending,
            "queue_depth_by_class": by_class,
            "autoscale": self.autoscale,
            "hosts_retiring": retiring,
            "hosts_alive": sum(1 for h in hosts.values()
                               if h["alive"]),
            "hosts_reporting": len(self._host_metrics),
            "jobs_total": len(jobs),
            "jobs_done": sum(1 for j in jobs if j.state == DONE),
            "jobs_failed": sum(1 for j in jobs if j.state == FAILED),
            "quarantined": [j.fp for j in jobs
                            if j.state == QUARANTINED],
            "hosts": hosts,
            "breakers": {
                (backend if mesh is None else f"{backend}@{mesh}"): st
                for (backend, mesh), st
                in self.breakers.states().items()},
            "telemetry": self.telemetry.snapshot(),
            # firing/resolved alerts (obs/alerts.py) — what
            # `mdtpu status --alerts` renders
            "alerts": (self.alerts.status()
                       if self.alerts is not None else None),
        }
        return out

    def healthz(self) -> dict:
        """The ``/healthz`` document: ok while this controller is
        neither wedged nor shut down (a wedged zombie answers 503 —
        exactly what a load balancer probing for adoption wants)."""
        with self._lock:
            ok = not self._wedged and not self._shutdown
            alive = sum(1 for h in self._hosts.values() if h.alive)
        return {"ok": ok, "role": "fleet-controller",
                "epoch": self.epoch, "hosts_alive": alive}

    def stats(self) -> dict:
        """Flat JSON snapshot: fleet telemetry + membership +
        placement (the fleet bench leg's fields)."""
        with self._lock:
            alive = sorted(h.hid for h in self._hosts.values()
                           if h.alive)
            jobs = list(self._jobs.values())
        out = self.telemetry.snapshot()
        out.update({
            "epoch": self.epoch,
            "hosts_alive": len(alive),
            "hosts": alive,
            "jobs_total": len(jobs),
            "jobs_done": sum(1 for j in jobs if j.state == DONE),
            "placement": self.placement.snapshot(),
        })
        return out

    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            hosts = list(self._hosts.values())
            procs = list(self._procs)
        for host in hosts:
            _send_line(host.sock, host.send_lock,
                       {"cmd": "stop", "epoch": self.epoch})
        try:
            self._listener.close()
        except OSError:
            pass
        if self._statusd is not None:
            self._statusd.close()
        for proc in procs:
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for host in hosts:
            try:
                host.sock.close()
            except OSError:
                pass
        self.journal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


# ---------------------------------------------------------------------------
# host worker process (the `fleet-host` CLI)
# ---------------------------------------------------------------------------

def _store_meta(spec: dict) -> dict | None:
    """Verified block-store manifest for a job spec whose trajectory
    is an ingested store directory (docs/STORE.md), else None — what
    the controller consults to route per-shard chunk ranges."""
    traj = spec.get("trajectory")
    if not traj:
        return None
    from mdanalysis_mpi_tpu_torch.io.store import store_meta

    return store_meta(traj)


def _build_universe(spec: dict):
    """Tenant state: a synthetic fixture (``fixture`` key — the chaos
    tests' deterministic shape, reproducible in every process from the
    seed alone) or real files.

    A spec carrying BOTH ``fixture`` and ``trajectory`` combines them:
    the fixture supplies the topology (reproducible from the seed, no
    file shipping) while the trajectory — a store directory or a
    remote store URL (docs/STORE.md) — supplies the coordinates
    through ``trajectory_files.open``.  This is how store-backed fleet
    jobs read exactly their ``shard_windows`` chunk ranges over the
    hardened remote boundary."""
    fixture = spec.get("fixture")
    if fixture:
        from mdanalysis_mpi_tpu_torch import testing as _testing

        kind = fixture.get("kind", "protein")
        kwargs = {k: v for k, v in fixture.items() if k != "kind"}
        if kind == "protein":
            u = _testing.make_protein_universe(**kwargs)
        elif kind == "md":
            u = _testing.make_md_universe(**kwargs)
        else:
            raise ValueError(f"unknown fixture kind {kind!r}")
        traj = spec.get("trajectory")
        if traj:
            from mdanalysis_mpi_tpu_torch import Universe

            return Universe(u.topology, traj)
        return u
    from mdanalysis_mpi_tpu_torch import Universe

    return Universe(spec["topology"], spec.get("trajectory"))


def _tenant_key(spec: dict) -> str:
    """The identity of a tenant's resident state on a host: its data
    source.  Wave 2 of a sticky tenant hits this key on its home host
    — the host-level analog of a cache hit.  The trajectory is part of
    the identity even WITH a fixture (a fixture+trajectory spec reads
    coordinates from the trajectory — ensemble members share one
    fixture topology over N different trajectories, and keying on the
    fixture alone would serve every member the first member's
    frames)."""
    fixture = spec.get("fixture")
    src = {"fixture": fixture,
           "trajectory": spec.get("trajectory")} if fixture else \
        {"topology": spec.get("topology"),
         "trajectory": spec.get("trajectory")}
    return json.dumps({"tenant": spec.get("tenant"), "src": src},
                      sort_keys=True)


def _ensure_member_store(icfg: dict) -> dict:
    """Idempotent store-first member ingest (docs/ENSEMBLE.md "Ingest
    pre-stage"): an existing verified store at ``icfg["out"]`` IS the
    answer; otherwise decode ``icfg["trajectory"]`` into it — through
    the ensemble's shared CAS hardlink pool when ``out_root`` rides
    along, so replica members dedup chunk bytes across hosts that
    share the filesystem.  Returns the ingest summary the controller
    folds into the parent's dedup ledger."""
    import os as _os

    from mdanalysis_mpi_tpu_torch.io.store import store_meta
    from mdanalysis_mpi_tpu_torch.io.store.ingest import ingest

    out = icfg["out"]
    try:
        existing = None if icfg.get("force") else store_meta(out)
    except Exception:
        existing = None            # a torn half-store re-ingests
    if existing is not None:
        return {"store": out, "already_ingested": True,
                "n_frames": existing["n_frames"],
                "n_chunks": len(existing["chunks"]),
                "bytes": 0, "dedup_bytes": 0, "dedup_chunks": 0}
    backend = None
    if icfg.get("out_root"):
        from mdanalysis_mpi_tpu_torch.io.store.parallel import (
            POOL_DIR, PooledCasBackend,
        )

        backend = PooledCasBackend(
            out, _os.path.join(_os.fspath(icfg["out_root"]),
                               POOL_DIR))
    if backend is not None:
        summary = dict(ingest(icfg["trajectory"], backend=backend,
                              chunk_frames=icfg.get("chunk_frames"),
                              quant=icfg.get("quant", "int16"),
                              stop=icfg.get("stop")))
    else:
        summary = dict(ingest(icfg["trajectory"], out,
                              chunk_frames=icfg.get("chunk_frames"),
                              quant=icfg.get("quant", "int16"),
                              stop=icfg.get("stop")))
    summary["store"] = out
    return summary


class _HostWorker:
    """One fleet host: local scheduler + controller link.

    ``backend`` None runs each job on its analysis' default backend;
    ``device`` (``cuda`` unless given) is where its jobs, its block
    cache and its canary run — resolved here, so a host asked for a
    card that is not there raises before it ever dials the controller.
    """

    def __init__(self, workdir: str, host_id: str, backend: str | None,
                 cache_mb: int, workers: int, hb_interval_s: float,
                 obs_interval_s: float = 0.5, device: str = "cuda"):
        from mdanalysis_mpi_tpu_torch.device import resolve_device
        from mdanalysis_mpi_tpu_torch.service.scheduler import Scheduler

        self.workdir = workdir
        self.host_id = host_id
        self.backend = backend
        self.device = str(resolve_device(device))
        # the device backends (the analysis default is one for all but
        # the serial-only analyses): cache and canary apply to these
        on_device = backend in (None, "torch", "mesh")
        self.hb_interval_s = hb_interval_s
        # federation shipping (docs/OBSERVABILITY.md "Fleet
        # federation"): metrics piggyback period (≤0 disables all
        # shipping from this host) + the last successfully shipped
        # series, so each heartbeat carries only what changed
        self.obs_interval_s = float(obs_interval_s)
        self._obs_next = 0.0
        self._last_shipped: dict = {}
        # MDTPU_FLEET_TRACE (set by spawn_host when the fleet is
        # tracing): record spans in memory and ship batches — the
        # controller owns the one merged trace file
        trace_knob = os.environ.get("MDTPU_FLEET_TRACE")
        if trace_knob not in (None, "", "0", "false", "no") \
                and not obs.tracing_enabled():
            # repo-wide knob convention (utils/log.py): 0/false/no
            # mean OFF, never "truthy string"
            obs.enable_tracing(None)
        if obs.tracing_enabled() and self.obs_interval_s > 0:
            _spans.enable_ship_buffer()
        cache = None
        if cache_mb and on_device:
            from mdanalysis_mpi_tpu_torch.parallel.executors import (
                DeviceBlockCache,
            )

            cache = DeviceBlockCache(max_bytes=int(cache_mb) << 20)
        self.cache = cache
        # MDTPU_CANARY_INTERVAL_S (set by spawn_host / the operator):
        # each host probes its OWN serving path — a fleet canary that
        # only ran on the controller would miss a single broken host
        canary_knob = os.environ.get("MDTPU_CANARY_INTERVAL_S")
        try:
            canary_interval = float(canary_knob) if canary_knob else None
        except ValueError:
            canary_interval = None
        self.sched = Scheduler(n_workers=workers, cache=cache,
                               prefetch=cache is not None)
        if canary_interval and canary_interval > 0 and on_device:
            from mdanalysis_mpi_tpu_torch.service.canary import CanaryProbe

            # the probe runs where this host's jobs run
            self.sched.canary = CanaryProbe(
                self.sched, interval_s=canary_interval,
                device=self.device)
        # the job-outcome usage meter mirrors the CONTROLLER's
        # exactly-once journal ledger; the host-local scheduler must
        # not also charge it or fleet federation would double-count
        self.sched._usage_charge_jobs = False
        self._log = get_logger("mdtpu.fleet")
        self._lock = threading.Lock()
        self._universes: dict[str, object] = {}
        self._inflight: dict[str, tuple] = {}   # fp -> (assign, epoch)
        self._unacked: dict[str, dict] = {}     # fp -> done msg
        self._fenced = 0
        self._epoch = 0
        self._sock: socket.socket | None = None
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        # deterministic partition fault for the chaos tests:
        # MDTPU_FLEET_HB_PAUSE="<fp-substring>:<seconds>" silences ALL
        # outgoing traffic (heartbeats AND completions) for <seconds>
        # once a matching run command arrives — the lease expires, the
        # controller migrates, and this host's late completion must
        # fence out
        self._pause_until = 0.0
        self._pause_spec = os.environ.get("MDTPU_FLEET_HB_PAUSE")
        self._run_delay = float(
            os.environ.get("MDTPU_FLEET_RUN_DELAY", "0") or 0)
        # span attribution per host (docs/OBSERVABILITY.md): every
        # span/instant this process records carries its host id
        obs.set_process_args(fleet_host=host_id)

    # ---- outgoing ----

    def _paused(self) -> bool:
        return time.monotonic() < self._pause_until

    def _send(self, msg: dict) -> bool:
        if self._paused():
            return False
        sock = self._sock
        if sock is None:
            return False
        return _send_line(sock, self._send_lock, msg)

    # ---- controller link ----

    def _connect(self, info: dict) -> None:
        try:
            sock = socket.create_connection(
                (info.get("host", "127.0.0.1"), info["port"]),
                timeout=5.0)
        except OSError:
            return
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # a (new) controller starts with no state for this host: the
        # thread-row labels (shipped once per tid) must re-ship or an
        # adopted controller's merged trace shows bare tids
        _spans.reship_thread_meta()
        with self._lock:
            self._epoch = int(info.get("epoch", 0))
            # ... and the next metrics piggyback must be the FULL
            # snapshot (the delta base resets)
            self._last_shipped = {}
            # the OLD socket stays open and its reader keeps running:
            # a zombie controller's late commands must be READ to be
            # fenced (and EOF cleans it up)
            self._sock = sock
            hello = {"ev": "hello", "host": self.host_id,
                     "pid": os.getpid(), "epoch": self._epoch,
                     "inflight": [
                         {"fp": fp, "assign": a, "epoch": e}
                         for fp, (a, e) in self._inflight.items()],
                     "done": list(self._unacked.values())}
        _send_line(sock, self._send_lock, hello)
        threading.Thread(target=self._reader, args=(sock,),
                         daemon=True,
                         name=f"mdtpu-fleet-{self.host_id}-rx").start()
        self._log.info("host %s connected to controller (epoch %d)",
                       self.host_id, self._epoch)

    def _reader(self, sock: socket.socket) -> None:
        try:
            f = sock.makefile("r", encoding="utf-8")
            for line in f:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                cmd = msg.get("cmd")
                if cmd == "run":
                    self._handle_run(msg)
                elif cmd == "ack":
                    with self._lock:
                        self._unacked.pop(msg.get("fp"), None)
                elif cmd == "stop":
                    with self._lock:
                        stale = (msg.get("epoch") or 0) < self._epoch
                    if stale:
                        # a zombie controller must not be able to
                        # stop the fleet's hosts — same fence as run
                        self._fenced += 1
                        self._send({"ev": "fenced",
                                    "host": self.host_id,
                                    "fp": None,
                                    "from_epoch": msg.get("epoch")})
                        continue
                    self._stop.set()
                    return
        except OSError:
            pass
        finally:
            with self._lock:
                if self._sock is sock:
                    self._sock = None     # reconnect on next hb tick
            try:
                sock.close()
            except OSError:
                pass

    # ---- command handling ----

    def _handle_run(self, msg: dict) -> None:
        fp = msg.get("fp")
        with self._lock:
            epoch = self._epoch
        if (msg.get("epoch") or 0) < epoch:
            # epoch fence, host side: a zombie controller's command.
            # Refused here AND disclosed to the CURRENT controller.
            self._fenced += 1
            obs.span_event("epoch_fenced_reject", fp=fp,
                           reason="stale_epoch_cmd",
                           from_epoch=msg.get("epoch"))
            self._log.warning(
                "host %s fenced stale-epoch command for %s "
                "(epoch %s < %d)", self.host_id, fp,
                msg.get("epoch"), epoch)
            self._send({"ev": "fenced", "host": self.host_id,
                        "fp": fp, "from_epoch": msg.get("epoch")})
            return
        # instant BEFORE any chaos delay or the run itself: a host
        # killed while holding this job still leaves "the job reached
        # host X" on the merged timeline (shipped by the heartbeat
        # loop), so a migration shows one trace_id spanning both hosts
        obs.span_event("fleet_job_received", fp=fp, trace_id=fp,
                       host=self.host_id)
        spec = dict(msg.get("job") or {})
        if self._pause_spec:
            sub, _, secs = self._pause_spec.partition(":")
            if sub and sub in str(fp):
                # one-shot per host: a migrated matching job must not
                # re-partition every host it lands on forever
                self._pause_spec = None
                self._pause_until = time.monotonic() + float(secs or 1)
                self._log.warning(
                    "host %s: simulating partition for %ss (fault "
                    "knob)", self.host_id, secs)
        if self._run_delay:
            # deterministic chaos window (MDTPU_FLEET_RUN_DELAY): the
            # job is accepted but held here, so a kill -9 / wedge
            # landing "mid-wave" in a test reliably finds work in
            # flight instead of racing millisecond jobs
            time.sleep(self._run_delay)
        token = (msg.get("assign"), msg.get("epoch"))
        with self._lock:
            self._inflight[fp] = token
        if spec.get("ingest") and not spec.get("analysis"):
            # a store-first ingest pre-stage child (docs/ENSEMBLE.md):
            # pure host decode+pack, device-free and scheduler-free —
            # run it off the command loop so other tenants' jobs keep
            # landing while the decode streams
            threading.Thread(
                target=self._run_ingest, args=(fp, token, spec),
                daemon=True, name=f"mdtpu-ingest-{fp}").start()
            return
        try:
            handle, resident = self._submit_local(fp, spec)
        except Exception as exc:
            self._finish(fp, token, state="failed",
                         error=f"{type(exc).__name__}: {exc}",
                         resident=False)
            return
        handle.add_done_callback(
            lambda h, fp=fp, token=token, resident=resident:
            self._on_local_done(fp, token, resident, h))

    def _run_ingest(self, fp: str, token, spec: dict) -> None:
        try:
            summary = _ensure_member_store(spec["ingest"])
        except Exception as exc:
            self._finish(fp, token, state="failed",
                         error=f"{type(exc).__name__}: {exc}",
                         resident=False)
            return
        self._finish(fp, token, state="done", results=summary,
                     resident=False)

    def _submit_local(self, fp: str, spec: dict):
        from mdanalysis_mpi_tpu_torch.service.cli import _build_job

        icfg = spec.get("ingest")
        if icfg and icfg.get("out"):
            # replay safety for ensemble members: a member
            # re-dispatched after a controller restart (or a member
            # adopted straight from the journal) may land without its
            # ingest child having run on THIS host's filesystem —
            # ensure the store idempotently before opening it
            _ensure_member_store(icfg)
        key = _tenant_key(spec)
        with self._lock:
            u = self._universes.get(key)
            resident = u is not None
        if u is None:
            u = _build_universe(spec)
            with self._lock:
                self._universes[key] = u
        clean = {k: v for k, v in spec.items()
                 if k not in _FLEET_SPEC_KEYS}
        # the host's device, never a backend name: a job without a
        # backend takes its analysis' default on this host's device
        # (on the card, the card), as the batch CLI decides
        if self.backend is not None:
            clean.setdefault("backend", self.backend)
        clean.setdefault("device", self.device)
        clean.pop("output", None)     # results travel the wire instead
        job, _cfg, _output = _build_job(clean, {}, u)
        job.fingerprint = fp
        # the FLEET fingerprint is the job's trace identity: every
        # span the local scheduler records for it carries the same
        # trace_id on every host it ever runs on — what lets one
        # migrated job read as one stitched timeline across pids
        job.trace_id = fp
        return self.sched.submit(job), resident

    def _on_local_done(self, fp: str, token, resident: bool,
                       handle) -> None:
        from mdanalysis_mpi_tpu_torch.service.cli import _result_arrays

        if handle.error is None:
            try:
                results = {k: v.tolist()
                           for k, v in
                           _result_arrays(handle.job.analysis).items()}
                self._finish(fp, token, state="done",
                             results=results, resident=resident)
                return
            except Exception as exc:
                self._finish(fp, token, state="failed",
                             error=f"{type(exc).__name__}: {exc}",
                             resident=resident)
                return
        self._finish(fp, token, state="failed",
                     error=f"{type(handle.error).__name__}: "
                           f"{handle.error}", resident=resident)

    def _finish(self, fp: str, token, **fields) -> None:
        msg = {"ev": "done", "host": self.host_id, "fp": fp,
               "assign": token[0], "epoch": token[1], **fields}
        with self._lock:
            self._inflight.pop(fp, None)
            self._unacked[fp] = msg
        self._send(msg)

    def _augment_hb(self, hb: dict):
        """Piggyback the federation payload on one heartbeat
        (docs/OBSERVABILITY.md "Fleet federation"): every tick drains
        the bounded trace ship queue (drops disclosed); every
        ``obs_interval_s`` attaches the changed-series subset of this
        host's ``unified_snapshot``.  Returns ``(trace_events,
        full_snapshot | None)`` so the caller can requeue the events
        on a failed send and mark the snapshot shipped on a
        successful one."""
        if self.obs_interval_s <= 0:
            return [], None
        events, dropped = _spans.drain_ship()
        if events:
            hb["trace"] = events
            hb["wall0"] = _spans.clock_info()[1]
        if dropped:
            obs.METRICS.inc("mdtpu_fleet_obs_trace_dropped_total",
                            dropped, site="host")
        snap = None
        now = time.monotonic()
        if now >= self._obs_next:
            self._obs_next = now + self.obs_interval_s
            snap = obs.unified_snapshot(
                timers=TIMERS, telemetry=self.sched.telemetry,
                cache=self.cache)
            delta = {k: v for k, v in snap.items()
                     if self._last_shipped.get(k) != v}
            if delta:
                hb["metrics"] = delta
            else:
                snap = None
        return events, snap

    # ---- main loop ----

    def run(self) -> int:
        while not self._stop.is_set():
            info = _read_addr_file(self.workdir)
            with self._lock:
                sock = self._sock
                epoch = self._epoch
            if info is not None and (sock is None
                                     or int(info.get("epoch", 0))
                                     > epoch):
                if not self._paused():
                    # failover: a newer controller published itself —
                    # switch, syncing in-flight + unacked completions
                    self._connect(info)
            hb = {"ev": "hb", "host": self.host_id,
                  "epoch": self._epoch}
            events, snap = self._augment_hb(hb)
            if self._send(hb):
                # ship accounting only on a SOCKET-accepted send: a
                # failed heartbeat requeues its events, and counting
                # at drain time would re-count them on every retry
                if events:
                    obs.METRICS.inc(
                        "mdtpu_fleet_obs_trace_events_total",
                        len(events), site="host")
                if snap is not None:
                    # delta base advances only on a SOCKET-accepted
                    # ship; a dead link re-ships the full difference
                    # after reconnect (and _connect resets the base)
                    with self._lock:
                        self._last_shipped = snap
                    obs.METRICS.inc(
                        "mdtpu_fleet_obs_metrics_ships_total")
            elif events:
                _spans.requeue_ship(events)
            # completion re-delivery until acked (idempotent on the
            # controller: token match → duplicate → re-ack)
            with self._lock:
                unacked = list(self._unacked.values())
            for msg in unacked:
                self._send(msg)
            self._stop.wait(self.hb_interval_s)
        self.sched.shutdown(wait=False)
        return 0


def host_main(argv=None) -> int:
    """Entry point of the ``fleet-host`` subcommand (one fleet host
    worker process; spawned by :meth:`FleetController.spawn_host`)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="mdanalysis_mpi_tpu_torch fleet-host")
    p.add_argument("--workdir", required=True)
    p.add_argument("--host-id", required=True)
    p.add_argument("--backend", default=None,
                   choices=("serial", "torch", "mesh"),
                   help="every job's backend (default: each analysis' "
                        "own, torch for all but the serial-only ones)")
    p.add_argument("--device", default="cuda",
                   help="the device this host serves on (default cuda; "
                        "it raises where there is none)")
    p.add_argument("--cache-mb", type=int, default=0)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--hb-interval", type=float, default=0.25)
    p.add_argument("--obs-interval", type=float, default=0.5,
                   help="metrics-federation piggyback period in "
                        "seconds (<=0 disables shipping)")
    ns = p.parse_args(argv)
    worker = _HostWorker(ns.workdir, ns.host_id, ns.backend,
                         ns.cache_mb, ns.workers, ns.hb_interval,
                         obs_interval_s=ns.obs_interval,
                         device=ns.device)
    return worker.run()


# ---------------------------------------------------------------------------
# dryrun smoke (scripts/verify.sh) + fleet CLI
# ---------------------------------------------------------------------------

def qos_elasticity_smoke(workdir, device: str = "cuda") -> dict:
    """The QoS + elasticity half of the dryrun smoke
    (docs/RELIABILITY.md §7): ONE host with one slot, autoscale up to
    3, a mixed-class burst whose background tail exceeds the shed
    depth.  Asserbable outcomes: the backlog scales hosts UP, the
    post-burst idle retires them back DOWN (drain-first), both as
    epoch-stamped journaled ``scale_up``/``scale_down`` records;
    background jobs shed with journaled terminal ``shed`` records
    while every interactive/batch job completes.  The hosts serve on
    ``device``.  Returns the phase's fields for the smoke record."""
    from mdanalysis_mpi_tpu_torch.service.journal import replay_fleet as _rf
    from mdanalysis_mpi_tpu_torch.service.qos import QosPolicy

    out: dict = {}
    policy = QosPolicy(shed_queue_depth=4,
                       shed_classes=("background",))
    with FleetController(
            workdir, host_ttl_s=5.0, host_slots=1, qos=policy,
            autoscale=True, min_hosts=1, max_hosts=3,
            scale_up_backlog=2, scale_down_idle_s=0.4,
            scale_cooldown_s=0.2, retire_drain_s=5.0,
            autoscale_spawn={"hb_interval_s": 0.1,
                             "env": {"MDTPU_FLEET_RUN_DELAY": "0.3"}},
            status=False, device=device) as ctrl:
        ctrl.spawn_host(hb_interval_s=0.1,
                        env={"MDTPU_FLEET_RUN_DELAY": "0.3"})
        if not ctrl.wait_hosts(1, timeout=60.0):
            out["error"] = "qos phase: first host never joined"
            return out
        fixture = {"kind": "protein", "n_residues": 6, "n_frames": 8,
                   "noise": 0.2, "seed": 7}
        jobs = []
        # the burst: interactive + batch fill the slots and the
        # backlog (scale-up signal); the background tail pushes the
        # pending depth past shed_queue_depth=4 → the ladder drops
        # background ONLY, newest first
        for i in range(2):
            jobs.append(ctrl.submit({"analysis": "rmsf",
                                     "fixture": fixture,
                                     "tenant": f"qi{i}",
                                     "qos": "interactive"}))
        for i in range(4):
            jobs.append(ctrl.submit({"analysis": "rmsf",
                                     "fixture": fixture,
                                     "tenant": f"qb{i}",
                                     "qos": "batch"}))
        for i in range(6):
            jobs.append(ctrl.submit({"analysis": "rmsf",
                                     "fixture": fixture,
                                     "tenant": f"qg{i}",
                                     "qos": "background"}))
        if not ctrl.drain(timeout=120.0):
            out["error"] = "qos phase: drain timed out"
            return out
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and \
                ctrl.telemetry.hosts_scaled_down < 1:
            time.sleep(0.05)
        snap = ctrl.telemetry.snapshot()
        out["qos_scaled_up"] = snap["hosts_scaled_up"]
        out["qos_scaled_down"] = snap["hosts_scaled_down"]
        out["qos_shed"] = snap["jobs_shed"]
        out["qos_shed_fps"] = [j.fp for j in jobs if j.state == SHED]
        out["qos_shed_above_background"] = sum(
            1 for j in jobs
            if j.state == SHED and j.qos != "background")
        out["qos_unserved"] = [
            j.fp for j in jobs
            if j.qos != "background" and j.state != DONE]
    meta = _rf(os.path.join(str(workdir), JOURNAL_NAME))
    events = [r["ev"] for r in meta["scale_events"]]
    out["qos_journal_scale_up"] = events.count("scale_up")
    out["qos_journal_scale_down"] = events.count("scale_down")
    out["qos_journal_shed_records"] = sum(
        1 for fp, rec in meta["jobs"].items()
        if rec["state"] == "shed")
    out["qos_exactly_once"] = all(
        n == 1 for n in meta["finishes"].values())
    out["qos_ok"] = (
        out["qos_scaled_up"] >= 1
        and out["qos_scaled_down"] >= 1
        and out["qos_journal_scale_up"] >= 1
        and out["qos_journal_scale_down"] >= 1
        and out["qos_shed"] >= 1
        and out["qos_journal_shed_records"] == len(out["qos_shed_fps"])
        and out["qos_shed_above_background"] == 0
        and not out["qos_unserved"]
        and out["qos_exactly_once"])
    return out


def ensemble_smoke(workdir, device: str = "cuda") -> dict:
    """The ensemble scale-out phase of the dryrun smoke
    (docs/ENSEMBLE.md): one 4-member trajectory-set job with a
    store-first ingest pre-stage — members 2 and 3 are an identical
    replica pair — through ONE single-slot host, so the pre-stage
    ingests run in a deterministic serial order and the replica
    pair's dedup is exact (2 of the 8 member chunks link instead of
    writing).  Assertable outcomes: the parent merges DONE with
    the pooled-Welford ``rmsf``, the replica pair's ``pairwise_rmsd``
    entry is ~0 while distinct members' is not, the ingest ledger
    discloses the dedup, and the journal audits exactly-once across
    ingest children AND members.  The host serves on ``device``."""
    import numpy as np

    from mdanalysis_mpi_tpu_torch import testing as _testing
    from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc
    from mdanalysis_mpi_tpu_torch.service.journal import replay_fleet as _rf

    out: dict = {}
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    fixture = {"kind": "protein", "n_residues": 6, "seed": 3}
    n_atoms = len(_testing.make_protein_universe(
        n_residues=6, seed=3).atoms)
    rng = np.random.default_rng(11)
    xtcs = []
    frames_by_member = []
    for i in range(4):
        if i == 3:
            frames = frames_by_member[2]     # the replica pair
        else:
            frames = rng.normal(scale=3.0, size=(8, n_atoms, 3)) \
                .astype(np.float32)
        frames_by_member.append(frames)
        path = os.path.join(workdir, f"member{i}.xtc")
        write_xtc(path, frames,
                  dimensions=np.array([40.0, 40, 40, 90, 90, 90]),
                  times=np.arange(8, dtype=np.float32))
        xtcs.append(path)
    with FleetController(os.path.join(workdir, "ctl"), host_ttl_s=5.0,
                         host_slots=1, status=False,
                         device=device) as ctrl:
        ctrl.spawn_host(hb_interval_s=0.1)
        if not ctrl.wait_hosts(1, timeout=60.0):
            out["error"] = "ensemble phase: host never joined"
            return out
        job = ctrl.submit({
            "analysis": "rmsf", "fixture": fixture, "tenant": "ens",
            "ensemble": [{"trajectory": x} for x in xtcs],
            "ingest": {"out_root": os.path.join(workdir, "stores"),
                       "chunk_frames": 4}})
        if not ctrl.drain(timeout=120.0):
            out["error"] = "ensemble phase: drain timed out"
            return out
        out["ensemble_state"] = job.state
        res = job.results or {}
        snap = ctrl.telemetry.snapshot()
        out["ensemble_members_completed"] = \
            snap["ensemble_members_completed"]
        out["ensemble_merges"] = snap["ensemble_merges"]
    out["ensemble_error"] = job.error
    out["ensemble_n_frames"] = res.get("n_frames")
    out["ensemble_dedup_ratio"] = res.get("ensemble_dedup_ratio")
    out["ensemble_dedup_chunks"] = res.get(
        "ensemble_ingest_dedup_chunks")
    pw = np.asarray(res.get("pairwise_rmsd", np.zeros((0, 0))))
    out["ensemble_replica_rmsd"] = (float(pw[2, 3])
                                    if pw.shape == (4, 4) else None)
    out["ensemble_distinct_rmsd"] = (float(pw[0, 1])
                                     if pw.shape == (4, 4) else None)
    meta = _rf(os.path.join(workdir, "ctl", JOURNAL_NAME))
    out["ensemble_exactly_once"] = all(
        n == 1 for n in meta["finishes"].values()) and \
        len(meta["finishes"]) == 8          # 4 ingests + 4 members
    out["ensemble_ok"] = (
        out["ensemble_state"] == DONE
        and res.get("ensemble_members") == 4
        and out["ensemble_n_frames"] == 32.0
        and "rmsf" in res and "member0_rmsf" in res
        # the replica pair's 2 chunks link instead of writing — ~1/4
        # of the byte volume (zlib sizes vary slightly per member)
        and out["ensemble_dedup_chunks"] == 2
        and 0.15 < (out["ensemble_dedup_ratio"] or 0) < 0.35
        and out["ensemble_replica_rmsd"] is not None
        and out["ensemble_replica_rmsd"] < 1e-6
        and out["ensemble_distinct_rmsd"] > 0.1
        and out["ensemble_members_completed"] == 4
        and out["ensemble_merges"] == 1
        and out["ensemble_exactly_once"])
    return out


def streaming_smoke(workdir, device: str = "cuda") -> dict:
    """The streaming-tier phase of the dryrun smoke
    (docs/STREAMING.md): a live writer thread appends into an
    append-able store — with one deliberate mid-feed stall longer
    than the tenant's ``stall_timeout_s`` — while a follow-mode
    streaming job tails it through an in-process scheduler.
    Assertable outcomes: partial snapshots are MONOTONE in frames,
    the final result matches the closed-file oracle over the sealed
    store at 1e-5, the stall PARKED the tenant (``mdtpu_stream_parks_
    total`` moved) without charging a fault, and the job still
    finished DONE after resume.  The tenant runs on the ``torch``
    backend on ``device``; the oracle is the serial backend."""
    import threading

    import numpy as np

    from mdanalysis_mpi_tpu_torch import obs
    from mdanalysis_mpi_tpu_torch import testing as _testing
    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import RMSF
    from mdanalysis_mpi_tpu_torch.io.store import LiveIngest, StoreReader
    from mdanalysis_mpi_tpu_torch.service.qos import QosPolicy
    from mdanalysis_mpi_tpu_torch.service.scheduler import Scheduler

    out: dict = {}
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "live-store")
    n_frames, chunk = 24, 8
    u_src = _testing.make_protein_universe(
        n_residues=6, n_frames=n_frames, noise=0.3, seed=7)
    frames, _ = u_src.trajectory.read_block(0, n_frames)
    obs.maybe_enable_from_env()

    def _parks() -> float:
        series = obs.METRICS.snapshot().get(
            "mdtpu_stream_parks_total", {})
        return float(sum(series.get("values", {}).values()))

    parks0 = _parks()
    live = LiveIngest(out=store, n_atoms=u_src.atoms.n_atoms,
                      chunk_frames=chunk)

    def writer():
        for i in range(n_frames):
            live.append(frames[i])
            if i == 15:
                time.sleep(1.0)     # > stall_timeout_s: forces a park
            else:
                time.sleep(0.003)
        live.seal()

    sr = StoreReader(store, follow=True)
    u_live = Universe(u_src.topology, sr)
    streamer = RMSF(u_live.select_atoms("name CA"))
    # daemon: joined below on the success path; must not pin a failed
    # smoke's interpreter alive
    t = threading.Thread(target=writer, daemon=True)
    with Scheduler(n_workers=1,
                   qos=QosPolicy(stream_park_delay_s=0.1)) as sched:
        t.start()
        h = sched.submit(
            streamer, backend="torch", executor_kwargs={"device": device},
            streaming={"window": chunk, "stall_timeout_s": 0.25,
                       "poll_interval_s": 0.01})
        res = h.result(timeout=120)
        sched.drain(timeout=60)
    t.join()
    snaps = res.results.stream_snapshots
    seq = [s["frames"] for s in snaps]
    out["streaming_frames"] = seq[-1] if seq else 0
    out["streaming_snapshots"] = len(snaps)
    out["streaming_monotone"] = seq == sorted(seq) and \
        len(set(seq)) == len(seq)
    out["streaming_parks"] = _parks() - parks0
    out["streaming_faults"] = h._faults
    out["streaming_state"] = str(h.state)
    oracle = RMSF(Universe(u_src.topology, StoreReader(store))
                  .select_atoms("name CA")).run(backend="serial")
    out["streaming_divergence"] = float(np.abs(
        np.asarray(res.results.rmsf)
        - np.asarray(oracle.results.rmsf)).max())
    out["streaming_ok"] = (
        out["streaming_frames"] == n_frames
        and out["streaming_snapshots"] >= 2
        and out["streaming_monotone"]
        and out["streaming_parks"] >= 1
        and out["streaming_faults"] == 0
        and out["streaming_divergence"] <= 1e-5)
    return out


def fleet_smoke(workdir=None, n_hosts: int = 2,
                kill_mid_wave: bool = True, device: str = "cuda") -> dict:
    """The dryrun serving leg at smoke scale: K tenants across
    ``n_hosts`` host processes, one ``kill -9`` mid-wave, exactly-once
    audited against the journal — PLUS the fleet-observability audit
    (docs/OBSERVABILITY.md "Fleet federation"): the merged Chrome
    trace shows distinct per-host pids and the migrated job's single
    stitched ``trace_id`` on both, the ``/metrics`` scrape's
    fleet-summed completion counter equals the journal's exactly-once
    ledger, and the lost host left a flight-recorder dump — PLUS the
    QoS/elasticity phase (:func:`qos_elasticity_smoke`, its own
    controller + journal in a sub-workdir): journaled
    scale-up/scale-down events and shed records, zero sheds above the
    configured class.  Every host (and the streaming tenant) serves on
    ``device``.  Returns the outcome record (``ok`` + the controller
    stats); raises nothing — failures land in the record so the caller
    can print-and-exit."""
    import glob as _glob
    import shutil
    import tempfile

    from mdanalysis_mpi_tpu_torch.service.statusd import fetch_status

    # ALWAYS a fresh subdirectory (under the caller's dir when given):
    # a reused journal would carry earlier smokes' identical
    # fingerprints, making any exactly-once audit ambiguous
    if workdir is not None:
        os.makedirs(str(workdir), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="mdtpu-fleet-smoke-",
                               dir=workdir)
    fixture = {"kind": "protein", "n_residues": 8, "n_frames": 10,
               "noise": 0.2, "seed": 3}
    record: dict = {"ok": False}
    victim = None
    stitched = None
    try:
        with FleetController(workdir, host_ttl_s=2.0,
                             trace=True, device=device) as ctrl:
            for _ in range(n_hosts):
                # the run-delay knob keeps received jobs in flight
                # long enough that the kill below provably lands on
                # working hosts (same knob as the bench fleet leg)
                # 1.0 s run delay >> the ~0.15 s between a job's
                # received-instant shipping and the kill below: the
                # victim provably completes NOTHING before it dies,
                # so no completed-counter increment can be stranded
                # unshipped (which would break the scrape==ledger
                # equality this smoke asserts)
                ctrl.spawn_host(hb_interval_s=0.1,
                                env={"MDTPU_FLEET_RUN_DELAY": "1.0"})
            if not ctrl.wait_hosts(n_hosts, timeout=60.0):
                record["error"] = "hosts never joined"
                return record
            jobs = [ctrl.submit({"analysis": "rmsf",
                                 "fixture": fixture,
                                 "tenant": f"t{i % 4}"})
                    for i in range(8)]
            if kill_mid_wave:
                # kill a host whose "job received" instant already
                # made it back on a heartbeat: that job is provably
                # in flight there (still inside its run delay), so
                # the migration — and the stitched trace id — is
                # deterministic, not a race against dispatch
                deadline = time.monotonic() + 20.0
                while victim is None and time.monotonic() < deadline:
                    for hid, evs in ctrl.host_trace_events().items():
                        if any(ev.get("name") == "fleet_job_received"
                               for ev in evs):
                            victim = hid
                            break
                    time.sleep(0.02)
                if victim is None:          # shipping never arrived
                    victim = sorted(ctrl.placement.hosts())[0]
                ctrl.kill_host(victim)
            if not ctrl.drain(timeout=120.0):
                record["error"] = "drain timed out"
                return record
            record["jobs_done"] = sum(1 for j in jobs
                                      if j.state == DONE)
            # ---- metrics federation: the fleet-summed completion
            #      counter must equal this wave's ledger exactly ----
            expected = record["jobs_done"]
            deadline = time.monotonic() + 10.0
            summed = -1
            while time.monotonic() < deadline:
                snap = ctrl.fleet_snapshot()
                summed = sum(snap["mdtpu_jobs_completed_total"]
                             ["values"].values())
                if summed >= expected:
                    break
                time.sleep(0.05)
            record["fleet_jobs_completed"] = summed
            try:
                text = fetch_status(workdir, route="/metrics")
                line = next(
                    ln for ln in text.splitlines()
                    if ln.startswith("mdtpu_jobs_completed_total "))
                record["scrape_jobs_completed"] = int(
                    float(line.split()[-1]))
            except Exception as exc:
                record["error"] = (f"/metrics scrape failed: "
                                   f"{type(exc).__name__}: {exc}")
                return record
            # ---- stitched trace: the migrated job's trace_id must
            #      appear on BOTH the victim's and a survivor's pid ----
            migrated = [j.fp for j in jobs if j.migrations > 0]
            record["jobs_migrated"] = len(migrated)
            deadline = time.monotonic() + 10.0
            while migrated and stitched is None \
                    and time.monotonic() < deadline:
                per_fp: dict = {}
                for hid, evs in ctrl.host_trace_events().items():
                    for ev in evs:
                        if ev.get("ph") == "M":
                            continue
                        args = ev.get("args") or {}
                        for fp in migrated:
                            if (args.get("trace_id") == fp
                                    or fp in (args.get("trace_ids")
                                              or ())):
                                per_fp.setdefault(fp, set()).add(
                                    ev.get("pid"))
                stitched = next((fp for fp, pids in per_fp.items()
                                 if len(pids) >= 2), None)
                if stitched is None:
                    time.sleep(0.1)
            trace_path = os.path.join(workdir, "fleet_trace.json")
            if ctrl.export_fleet_trace(trace_path) is None:
                # disclosed write failure (ENOSPC etc.): a failure
                # RECORD, never an exception out of the smoke
                record["error"] = "merged trace export failed"
                return record
            with open(trace_path) as f:
                doc = json.load(f)
            pids = {ev["pid"] for ev in doc["traceEvents"]
                    if ev.get("ph") != "M"}
            record["trace_pids"] = len(pids)
            record["trace_stitched_fp"] = stitched
            record["stats"] = ctrl.stats()
        # ---- flight recorder: the lost host left its black box ----
        flight_ok = False
        for p in _glob.glob(os.path.join(workdir,
                                         "flight_host_loss_*.json")):
            with open(p) as f:
                d = json.load(f)
            if d.get("trigger") == "host_loss" \
                    and d.get("extra", {}).get("host") == victim:
                flight_ok = True
        record["flight_dump"] = flight_ok
        meta = _journal.replay_fleet(
            os.path.join(workdir, JOURNAL_NAME))
        # audit THIS run's jobs only: a reused --workdir journal
        # legitimately carries earlier runs' finishes too
        record["exactly_once"] = all(
            meta["finishes"].get(j.fp) == 1 for j in jobs)
        record["federation_match"] = (
            record["fleet_jobs_completed"] == len(jobs)
            and record.get("scrape_jobs_completed") == len(jobs))
        # ---- QoS + elasticity phase (docs/RELIABILITY.md §7): its
        #      own controller + journal in a sub-workdir, so the main
        #      wave's exactly-once ledger stays unambiguous ----
        record.update(qos_elasticity_smoke(
            os.path.join(workdir, "qos"), device=device))
        # ---- phase 4: ensemble scale-out (docs/ENSEMBLE.md) — its
        #      own controller + journal too: a 4-member trajectory-set
        #      job with the CAS ingest pre-stage, merged reductions,
        #      replica-pair dedup ----
        record.update(ensemble_smoke(
            os.path.join(workdir, "ensemble"), device=device))
        # ---- phase 5: streaming tier (docs/STREAMING.md) — its own
        #      in-process scheduler: a live writer with a deliberate
        #      stall, a follow-mode tenant parked (not faulted) and
        #      resumed to sealed-store parity ----
        record.update(streaming_smoke(
            os.path.join(workdir, "streaming"), device=device))
        record["ok"] = (record["jobs_done"] == len(jobs)
                        and record["exactly_once"]
                        and record["federation_match"]
                        and record["trace_pids"] >= n_hosts
                        and record.get("qos_ok", False)
                        and record.get("ensemble_ok", False)
                        and record.get("streaming_ok", False)
                        and (not kill_mid_wave
                             or (record["jobs_migrated"] >= 1
                                 and stitched is not None
                                 and flight_ok)))
        return record
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _write_output(job: FleetJob) -> str | None:
    """A finished job's result arrays to its spec's ``output`` as an
    ``.npz``, written tmp → fsync → rename; None on a write failure
    (counted by the integrity helper)."""
    import io

    import numpy as np

    from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity

    buf = io.BytesIO()
    np.savez(buf, **job.result_arrays())
    try:
        _integrity.atomic_write_bytes(job.spec["output"], buf.getvalue(),
                                      artifact="job_output")
    except OSError:
        return None
    return job.spec["output"]


def _write_metrics(ctrl: FleetController, path: str,
                   timeout: float = 10.0) -> str | None:
    """The federated snapshot to ``path`` as JSON, once the hosts'
    completion counters account for every finished analysis job (they
    ship on heartbeats, after the completions themselves)."""
    from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity

    done = sum(1 for j in ctrl.jobs().values()
               if j.state == DONE and not j.children
               and j.spec.get("analysis"))
    deadline = time.monotonic() + timeout
    while True:
        snap = ctrl.fleet_snapshot()
        shipped = sum(snap["mdtpu_jobs_completed_total"]
                      ["values"].values())
        if shipped >= done or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    try:
        _integrity.atomic_write_bytes(path, json.dumps(snap).encode(),
                                      artifact="fleet_metrics")
    except OSError:
        return None
    return path


def fleet_main(argv=None) -> int:
    """Entry point of the ``fleet`` subcommand: ``--smoke`` runs the
    dryrun chaos smoke (scripts/verify.sh stage 2); otherwise a JSON
    job file (the ``batch`` schema plus ``hosts``/``fixture``/
    ``shards``/``ensemble``/``ingest`` fields — docs/ENSEMBLE.md) is
    served across spawned host processes.  A job's ``output`` (the
    batch schema's ``.npz`` path) receives its result arrays from the
    controller once the fleet drains, and ``--metrics-out`` writes the
    federated metrics snapshot — what ``/metrics`` exposes — as JSON:
    the command's own record of where its jobs ran (the hosts'
    ``mdtpu_fused_blocks_total``, their serial sheds)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="mdanalysis_mpi_tpu_torch fleet",
        description="serve a job file across N fleet host processes "
                    "(controller tier: sticky placement, host-loss "
                    "migration, epoch-fenced journal — "
                    "docs/RELIABILITY.md §6)")
    p.add_argument("jobs_file", nargs="?", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="run the dryrun chaos smoke (2 hosts, one "
                        "kill -9 mid-wave, exactly-once audit) and "
                        "exit 0/1")
    p.add_argument("--hosts", type=int, default=2)
    p.add_argument("--workdir", default=None,
                   help="fleet journal/address directory (default: "
                        "a temp dir; pass the SAME dir to a standby "
                        "for adoption)")
    p.add_argument("--backend", default=None,
                   choices=("serial", "torch", "mesh"),
                   help="every job's backend (default: each analysis' "
                        "own, torch for all but the serial-only ones)")
    p.add_argument("--device", default="cuda",
                   help="the device every host serves on (default cuda; "
                        "the fleet raises where there is none)")
    p.add_argument("--cache-mb", type=int, default=0)
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write ONE merged Chrome trace of the whole "
                        "fleet to FILE: hosts trace in memory and "
                        "ship batches on their heartbeats, the "
                        "controller stitches them per-pid "
                        "(docs/OBSERVABILITY.md \"Fleet federation\")")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write the fleet's federated metrics snapshot "
                        "(the /metrics document, as JSON) to FILE once "
                        "every finished job's host counters arrived")
    ns = p.parse_args(argv)

    if ns.smoke:
        record = fleet_smoke(workdir=ns.workdir, device=ns.device)
        print(json.dumps(record))
        return 0 if record.get("ok") else 1
    if not ns.jobs_file:
        p.error("a jobs file (or --smoke) is required")
    with open(ns.jobs_file, encoding="utf-8") as f:
        spec = json.load(f)

    import shutil
    import tempfile

    owns = ns.workdir is None
    workdir = ns.workdir or tempfile.mkdtemp(prefix="mdtpu-fleet-")
    n_hosts = int(spec.get("hosts", ns.hosts))
    defaults = dict(spec.get("defaults", {}))
    # top-level (topology, trajectory) fold into every job, the batch
    # CLI's documented job-file shape — a fleet job file should not
    # need them repeated per job or nested under "defaults"
    for key in ("topology", "trajectory"):
        if spec.get(key) is not None:
            defaults.setdefault(key, spec[key])
    t0 = time.perf_counter()
    try:
        with FleetController(
                workdir,
                trace=bool(ns.trace_out) or None,
                device=ns.device) as ctrl:
            for _ in range(n_hosts):
                ctrl.spawn_host(backend=ns.backend,
                                cache_mb=ns.cache_mb)
            if not ctrl.wait_hosts(n_hosts, timeout=120.0):
                print(json.dumps({"error": "hosts never joined"}))
                return 1
            jobs = [ctrl.submit({**defaults, **js})
                    for js in spec.get("jobs", [])]
            ok = ctrl.drain(timeout=float(spec.get("timeout_s", 3600)))
            records = [{"fp": j.fp, "tenant": j.tenant,
                        "state": j.state, "host": j.host,
                        "error": j.error} for j in jobs]
            for j, rec in zip(jobs, records):
                if j.state == DONE and j.spec.get("output"):
                    rec["output"] = _write_output(j)
            out = {"jobs": records,
                   "wall_s": round(time.perf_counter() - t0, 4),
                   "drained": ok, "fleet": ctrl.stats()}
            if ns.metrics_out:
                out["metrics_out"] = _write_metrics(ctrl,
                                                    ns.metrics_out)
            if ns.trace_out:
                # let the last heartbeat batches land before merging
                time.sleep(0.5)
                out["trace_out"] = ctrl.export_fleet_trace(
                    ns.trace_out)
            if ctrl._statusd is not None:
                addr = ctrl._statusd.address
                out["status_addr"] = f"{addr[0]}:{addr[1]}"
        print(json.dumps(out))
        return 0 if ok and all(j.state == DONE for j in jobs) else 1
    finally:
        if owns:
            shutil.rmtree(workdir, ignore_errors=True)
