"""Flight recorder: the per-process black box (docs/OBSERVABILITY.md).

The span buffer is already a bounded ring of the most recent spans,
instants and mirrored log events (``obs/spans.py``); this module dumps
that window — plus a full metrics snapshot and the process's fleet
attribution — to an atomically written JSON file at the moments an
operator most wants one:

- **quarantine**: a poison job is parked — the dump path lands in its
  :class:`~mdanalysis_mpi_tpu_torch.service.jobs.JobQuarantinedError`
  diagnostics (``flight_recorder``);
- **worker_fence**: the supervisor fenced a wedged-but-alive worker;
- **host_loss**: the fleet controller lost a host (lease expiry,
  socket EOF, dead process) — the dump is also recorded in the fleet
  journal (``ev: "flight"``);
- **adoption**: a standby controller took the journal over.

Every dump is counted (``mdtpu_flight_dumps_total{trigger=}``) and
marked on the trace timeline (``flight_dump`` instant).  Writes ride
:func:`~mdanalysis_mpi_tpu_torch.utils.integrity.atomic_write` (tmp → fsync
→ rename, typed + counted failures), and a failed write returns None
instead of ever failing the incident path that asked for it.  With no
directory resolvable the recorder is off (``dump`` returns None).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

#: How many trailing events a dump captures (the black-box window).
FLIGHT_EVENTS = int(os.environ.get("MDTPU_FLIGHT_EVENTS", "512"))

_SEQ = itertools.count()
_SEQ_LOCK = threading.Lock()


def flight_dir(explicit=None, journal=None) -> str | None:
    """Resolve where a process's flight dumps land: an explicit
    directory, else ``MDTPU_FLIGHT_DIR``, else beside a path-backed
    journal, else None (recorder off)."""
    if explicit:
        return str(explicit)
    env = os.environ.get("MDTPU_FLIGHT_DIR")
    if env:
        return env
    if isinstance(journal, (str, bytes)) or hasattr(journal,
                                                    "__fspath__"):
        return os.path.dirname(os.path.abspath(os.fspath(journal)))
    return None


def dump(trigger: str, directory: str | None,
         extra: dict | None = None,
         limit: int = FLIGHT_EVENTS) -> str | None:
    """Write one black-box file under ``directory`` and return its
    path (None: recorder off, or the write failed — counted either
    way by the integrity layer, never raised into the incident path).
    """
    if not directory:
        return None
    from mdanalysis_mpi_tpu_torch.obs import metrics as _metrics
    from mdanalysis_mpi_tpu_torch.obs import prof as _prof
    from mdanalysis_mpi_tpu_torch.obs import spans as _spans

    with _SEQ_LOCK:
        seq = next(_SEQ)
    pid = os.getpid()
    path = os.path.join(str(directory),
                        f"flight_{trigger}_{pid}_{seq}.json")
    doc = {
        "trigger": trigger,
        "t": time.time(),
        "pid": pid,
        "process_args": _spans.process_args(),
        "extra": extra or {},
        # the ring's most recent window, spans + instants + log marks
        # in shared monotonic order (empty when tracing is off — the
        # metrics snapshot below still captures the counters)
        "events": _spans.tail(limit=limit),
        "tracing": _spans.enabled(),
        "metrics": _metrics.unified_snapshot(),
        # the memory picture at the incident: sampler peaks when the
        # continuous profiler ran, a one-shot RSS read when it did
        # not (obs/prof.py watermark_block)
        "profiler": _prof.watermark_block(),
    }
    try:
        # intra-package import: obs stays stdlib-only externally, and
        # the integrity layer (numpy) loads only when a dump fires
        from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity

        os.makedirs(str(directory), exist_ok=True)
        _integrity.atomic_write_bytes(
            path, json.dumps(doc, default=str).encode(),
            artifact="flight")
    except OSError:
        # ArtifactWriteError included: already counted + typed by the
        # integrity layer; the incident path must not fail on it
        return None
    _metrics.METRICS.inc("mdtpu_flight_dumps_total", trigger=trigger)
    _spans.span_event("flight_dump", trigger=trigger, path=path)
    return path
