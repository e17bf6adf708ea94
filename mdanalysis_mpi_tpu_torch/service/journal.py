"""Crash-consistent job journal: append-only JSONL + fsync batching.

A crashed ``batch`` process (power loss, ``kill -9``, OOM) must not
lose its queue: ``Scheduler(journal=path)`` logs every job-lifecycle
transition — ``submit`` / ``claim`` / ``requeue`` / ``quarantine`` /
``finish`` — as one JSON object per line, and
:func:`replay` reconstructs each job's last known state from whatever
prefix of the file survived the crash (a torn final line — the write
the crash interrupted — is skipped, not fatal).  Jobs are identified
by their :attr:`~mdanalysis_mpi_tpu_torch.service.jobs.AnalysisJob.
fingerprint`, which must be reproducible across process restarts; the
``batch --journal`` CLI derives it from the job's spec + position in
the job file, so a restarted process resubmits exactly the jobs the
journal shows as unfinished and skips the ones already done
(docs/RELIABILITY.md, "Serving supervision").

Durability model (fsync batching): every record is flushed to the OS
immediately; ``fsync`` is paid either when ``fsync_batch`` unsynced
records accumulate or — always — on *terminal* records (``finish`` /
``quarantine``), because those are the ones recovery must never
double-run.  A crash can therefore lose at most the last
``fsync_batch`` non-terminal records, which recovery treats as
"still pending" — jobs re-run, never vanish.

Integrity model (docs/RELIABILITY.md §5): every record carries a
``crc`` field — CRC32C over its own canonical JSON — and
:func:`replay` VERIFIES it.  A torn final line (the write the crash
interrupted) is still skipped, but a record inside the surviving
prefix that parses and fails its CRC — bit rot, a concurrent writer,
hand editing — raises a typed
:class:`~mdanalysis_mpi_tpu_torch.utils.integrity.JournalCorruptError`
instead of silently replaying corrupt job state.  And a journal whose
disk fills mid-run DEGRADES instead of killing the scheduler: the
first ``OSError`` flips the journal to in-memory mode (records land in
:attr:`JobJournal.memory_records`), counted loudly as
``mdtpu_integrity_write_errors_total{artifact="journal"}`` plus the
``mdtpu_integrity_journal_degraded`` gauge — the serving process keeps
running; only its crash-recovery story is (disclosed as) gone.
"""

from __future__ import annotations

import json
import os
import threading
import time

from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity
from mdanalysis_mpi_tpu_torch.utils.log import get_logger

#: Every terminal journal state a ``finish``/``quarantine`` record can
#: carry.
TERMINAL_STATES = ("done", "quarantined", "failed", "expired",
                   "aborted", "shed")

#: Terminal states a recovering ``batch --journal`` process does NOT
#: resubmit: the job ran to a settled verdict (its output is on disk,
#: or it failed/expired deterministically, or it was quarantined as
#: poison).  ``aborted`` is deliberately absent — an operator's ^C
#: aborts the queue, and the re-run must run those jobs — and so is
#: ``shed`` (docs/RELIABILITY.md §7): a shed is the overload
#: controller's answer to a transient burst, and the restarted
#: process must re-run the job now that the burst has passed
#: (service/cli.py consumes this).
SETTLED_STATES = ("done", "quarantined", "failed", "expired")

#: States a later ``submit`` record may NOT resurrect during replay:
#: a done or quarantined job is settled forever, but an aborted /
#: failed / expired one is legitimately resubmitted by a restarted
#: ``batch --journal`` process (an operator's ^C aborts the queue;
#: the re-run must run those jobs, and its submit records must flip
#: their replayed state back to ``queued``).
_PROTECTED_STATES = ("done", "quarantined")


class JobJournal:
    """Append-side of the journal (one per scheduler)."""

    def __init__(self, path, fsync_batch: int = 16,
                 epoch: int | None = None):
        self.path = str(path)
        self.fsync_batch = max(1, int(fsync_batch))
        #: Controller epoch stamped into every record (fleet tier,
        #: docs/RELIABILITY.md §6).  None — the single-process
        #: scheduler journal — writes epoch-less records, which replay
        #: treats as epoch 0 (always current).  A standby that adopts
        #: the journal constructs its JobJournal with the BUMPED epoch,
        #: and :func:`replay_fleet` then fences every record a zombie
        #: controller appends under the old one.
        self.epoch = epoch
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")
        self._unsynced = 0
        #: flipped by the first failed write: the journal stopped
        #: persisting and keeps records in memory instead (loud
        #: counter + gauge; the scheduler keeps serving)
        self.degraded = False
        #: records accepted after degradation — still inspectable in
        #: process, just no longer crash-durable.  BOUNDED: a serving
        #: process can outlive its full disk by days, and the
        #: disk-exhaustion incident must not morph into a memory-
        #: exhaustion crash — past the cap the oldest records drop,
        #: counted in :attr:`memory_dropped`.
        self.memory_records: list[dict] = []
        self.memory_max = 10_000
        self.memory_dropped = 0

    def record(self, ev: str, fingerprint: str | None,
               durable: bool = False, **fields) -> None:
        """Append one CRC-framed event.  ``durable=True`` forces an
        immediate fsync (terminal events); otherwise the fsync is
        batched.  A write failure (ENOSPC, EIO, ...) degrades the
        journal to in-memory — counted, never fatal to the worker."""
        rec = {"ev": ev, "fp": fingerprint,
               "t": round(time.time(), 3), **fields}
        if self.epoch is not None:
            rec.setdefault("epoch", self.epoch)
        rec["crc"] = _integrity.record_crc(rec)
        line = json.dumps(rec, sort_keys=True) + "\n"
        with self._lock:
            if self._f.closed:
                return
            if self.degraded:
                self._remember_locked(rec)
                return
            try:
                self._f.write(line)
                self._f.flush()
                self._unsynced += 1
                if durable or self._unsynced >= self.fsync_batch:
                    os.fsync(self._f.fileno())
                    self._unsynced = 0
            except OSError as exc:
                self._degrade_locked(rec, exc)

    def _remember_locked(self, rec: dict) -> None:
        # caller holds self._lock
        self.memory_records.append(rec)
        if len(self.memory_records) > self.memory_max:
            del self.memory_records[0]
            self.memory_dropped += 1

    def _degrade_locked(self, rec: "dict | None", exc: OSError) -> None:
        # caller holds self._lock.  The scheduler (and its workers)
        # must survive a full disk: from here on records accumulate in
        # memory, and the loss of crash-durability is DISCLOSED — a
        # pinned counter, a gauge, and a warning — never silent.
        from mdanalysis_mpi_tpu_torch.obs import METRICS

        self.degraded = True
        if rec is not None:
            self._remember_locked(rec)
        _integrity.note_write_error("journal", self.path)
        METRICS.set_gauge("mdtpu_integrity_journal_degraded", 1)
        get_logger("mdtpu.service").warning(
            "journal %s degraded to in-memory after write failure "
            "(%s: %s): records are no longer crash-durable",
            self.path, type(exc).__name__, exc)

    def close(self) -> None:
        with self._lock:
            if self._f.closed:
                return
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except OSError as exc:
                if not self.degraded:
                    self._degrade_locked(None, exc)
            finally:
                try:
                    self._f.close()
                except OSError as exc:
                    # close() re-attempts the buffered flush; on a
                    # full disk that raises AGAIN — swallow it (the
                    # degradation already counted the loss) so
                    # Scheduler.shutdown() never dies on the exact
                    # failure the ladder promises to survive
                    if not self.degraded:
                        self._degrade_locked(None, exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def replay(path) -> dict:
    """Reconstruct per-job state from a journal file.

    Returns ``{fingerprint: {"state", "claims", "submits",
    "requeues", "reason"}}`` where ``state`` is the job's LAST
    recorded transition: ``queued`` (submitted or requeued, not yet
    finished), ``claimed`` (a worker took it and no terminal record
    followed — the crash caught it mid-run; it must re-run), or a
    terminal state from the ``finish``/``quarantine`` record.

    Integrity (docs/RELIABILITY.md §5): every record must verify its
    CRC32C frame.  Only the FINAL non-empty line may be unparseable —
    that is the torn write the crash interrupted, and it is skipped;
    an unparseable *interior* line, a record with no ``crc``, or a
    record whose CRC mismatches raises a typed
    :class:`~mdanalysis_mpi_tpu_torch.utils.integrity.JournalCorruptError`:
    recovery must reject corrupt history, not replay it.  One
    grandfather clause: a journal where NO record carries a ``crc``
    was written before CRC framing existed and replays with a warning
    (an upgrade must not strand a healthy crash journal); a journal
    where SOME records carry frames and others don't is tampered or
    torn mid-record and is rejected.
    """
    jobs: dict = {}
    for rec in _verified_records(path):
        _fold_record(jobs, rec)
    return jobs


def _verified_records(path) -> list[dict]:
    """Parse + CRC-verify a journal file: every surviving record, in
    order (the shared front half of :func:`replay` and
    :func:`replay_fleet` — torn-tail skip, typed interior rejection,
    and the pre-CRC grandfather clause live HERE so the two replays
    cannot drift on what counts as a valid record)."""
    # errors="replace": a flipped byte that breaks UTF-8 must surface
    # as an unparseable RECORD (typed rejection / torn-tail skip, per
    # position), not as a UnicodeDecodeError escaping the replay
    with open(path, encoding="utf-8", errors="replace") as f:
        lines = [ln.strip() for ln in f]
    lines = [(i + 1, ln) for i, ln in enumerate(lines) if ln]
    parsed: list = []
    for pos, (lineno, line) in enumerate(lines):
        try:
            rec = json.loads(line)
        except ValueError:
            if pos == len(lines) - 1:
                continue         # torn write at the crash point
            raise _integrity.JournalCorruptError(
                f"journal {path!r} line {lineno} does not parse but "
                "is not the torn tail — the file is corrupt, refusing "
                "to replay it (recover from a backup or delete it to "
                "start over)", artifact="journal", path=str(path))
        parsed.append((lineno, rec))
    legacy = parsed and all(rec.get("crc") is None
                            for _, rec in parsed)
    if legacy:
        get_logger("mdtpu.service").warning(
            "journal %s carries no CRC frames (written before "
            "integrity framing): replaying unverified", path)
    out = []
    for lineno, rec in parsed:
        if not legacy and not _integrity.verify_record(rec):
            _integrity.note_corrupt("journal", str(path))
            raise _integrity.JournalCorruptError(
                f"journal {path!r} line {lineno} fails its CRC frame "
                "— the record's bytes are not the bytes that were "
                "written; refusing to replay corrupt job state",
                artifact="journal", path=str(path))
        out.append(rec)
    return out


def _fold_record(jobs: dict, rec: dict) -> None:
    """Fold one verified record into the per-job state map (shared by
    both replays; ``assign`` is the fleet tier's name for ``claim`` —
    a host took the job)."""
    fp = rec.get("fp")
    ev = rec.get("ev")
    if fp is None or ev is None:
        return
    st = jobs.setdefault(fp, {"state": None, "claims": 0,
                              "submits": 0, "requeues": 0,
                              "reason": None})
    if ev == "submit":
        st["submits"] += 1
        if st["state"] not in _PROTECTED_STATES:
            st["state"] = "queued"
    elif ev in ("claim", "assign"):
        st["claims"] += 1
        if st["state"] not in _PROTECTED_STATES:
            st["state"] = "claimed"
    elif ev == "requeue":
        st["requeues"] += 1
        if st["state"] not in _PROTECTED_STATES:
            st["state"] = "queued"
    elif ev == "quarantine":
        st["state"] = "quarantined"
        st["reason"] = rec.get("reason")
    elif ev == "finish":
        st["state"] = rec.get("state", "done")


def replay_fleet(path) -> dict:
    """Fleet-journal replay with **epoch fencing**
    (docs/RELIABILITY.md §6): records carry the writing controller's
    epoch, ``epoch`` records mark a controller (re)taking ownership,
    and any record stamped with an epoch OLDER than the highest
    ``epoch`` record seen so far is a zombie controller's append —
    REJECTED (counted, never folded), so a wedged old controller that
    keeps writing after a standby adopted the journal cannot corrupt
    the replayed job state.

    Returns ``{"jobs": {fp: record}, "epoch": last adopted epoch,
    "stale_records": zombie appends rejected, "finishes": {fp: n},
    "scale_events": [record, ...]}`` — ``finishes`` counts ACCEPTED
    terminal records per job, the exactly-once ledger the chaos tests
    audit, and ``scale_events`` are the accepted (epoch-current)
    ``scale_up``/``scale_down`` records the autoscaler journaled
    (docs/RELIABILITY.md §7) — a zombie controller's scale records
    are fenced exactly like its job records.  Epoch-less records
    (a pre-fleet journal) are treated as epoch 0: always current
    until the first ``epoch`` record appears.
    """
    jobs: dict = {}
    finishes: dict = {}
    scale_events: list = []
    current = 0
    stale = 0
    for rec in _verified_records(path):
        e = rec.get("epoch")
        if rec.get("ev") == "epoch":
            if e is not None and e >= current:
                current = e
            else:
                stale += 1
            continue
        if e is not None and e < current:
            stale += 1
            continue
        if rec.get("ev") in ("scale_up", "scale_down"):
            scale_events.append(rec)
            continue
        _fold_record(jobs, rec)
        if rec.get("ev") == "submit" and rec.get("fp") in jobs:
            # the fleet submit record carries the job's SPEC: a
            # standby can re-own unfinished jobs from the journal
            # alone, without the original submitter
            jobs[rec["fp"]]["spec"] = rec.get("spec")
            jobs[rec["fp"]]["tenant"] = rec.get("tenant")
        if rec.get("ev") in ("finish", "quarantine") \
                and rec.get("fp") is not None:
            finishes[rec["fp"]] = finishes.get(rec["fp"], 0) + 1
    if stale:
        get_logger("mdtpu.service").warning(
            "journal %s: rejected %d record(s) from stale controller "
            "epochs (< %d) — a zombie controller kept writing after "
            "adoption", path, stale, current)
    return {"jobs": jobs, "epoch": current, "stale_records": stale,
            "finishes": finishes, "scale_events": scale_events}
