"""Structured logging (SURVEY.md §5.5).

Plain-text logs via stdlib ``logging`` plus an optional JSON-lines
event stream for machine consumption (bench scripts, notebooks).
Level is controlled by ``MDTPU_LOG`` (default WARNING, so library use
is silent); ``MDTPU_LOG_JSON=1`` switches events to one-JSON-per-line
on stderr, and ``MDTPU_LOG_JSON=<file>`` appends the same lines to a
file — long serving runs persist their event stream without
redirecting stderr (docs/OBSERVABILITY.md).

Every JSON event carries ``ts`` (wall clock, ISO-8601 UTC), ``pid``
and ``thread`` — without them a multi-worker serving log cannot be
correlated with a span trace or across restarts.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import threading

_CONFIGURED = False
_FILE_LOCK = threading.Lock()
_DROP_WARNED = False          # one warning per process, drops counted


def get_logger(name: str = "mdtpu") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("MDTPU_LOG", "WARNING").upper()
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        root = logging.getLogger("mdtpu")
        root.addHandler(h)
        root.setLevel(getattr(logging, level, logging.WARNING))
        _CONFIGURED = True
    return logging.getLogger(name)


def log_event(event: str, **fields) -> None:
    """Emit a structured event.

    ``MDTPU_LOG_JSON=1`` → one JSON line on stderr;
    ``MDTPU_LOG_JSON=<path>`` → the same line appended to that file
    (open-per-event append: survives rotation, needs no handler
    lifecycle); unset → a normal INFO log record (visible when
    ``MDTPU_LOG=INFO``).  JSON events carry ``ts``/``pid``/``thread``
    identity fields; explicit same-named ``fields`` win.
    """
    # mirror onto the span timeline (one "log"-category instant, the
    # SCALAR fields only — a serving snapshot's nested dicts stay in
    # the JSON stream), so tail()/flight dumps show log lines
    # interleaved with phases and incidents in one monotonic order
    from mdanalysis_mpi_tpu_torch.obs import spans as _spans

    if _spans.enabled():
        _spans.log_mark(event, **{
            k: v for k, v in fields.items()
            if isinstance(v, (str, int, float, bool))})
    mode = os.environ.get("MDTPU_LOG_JSON")
    # the repo-wide knob convention: 0/false/no mean OFF, never a file
    # named "0" in the cwd
    if mode in (None, "", "0", "false", "no"):
        mode = None
    if mode:
        rec = {
            "event": event,
            "ts": datetime.datetime.now(datetime.timezone.utc)
            .isoformat(timespec="milliseconds"),
            "pid": os.getpid(),
            "thread": threading.current_thread().name,
            **fields,
        }
        line = json.dumps(rec, default=str)
        if mode in ("1", "true", "yes"):
            print(line, file=sys.stderr, flush=True)
        else:
            # cross-thread append under one lock; cross-process safety
            # rides POSIX O_APPEND line atomicity for these short lines
            try:
                with _FILE_LOCK, open(mode, "a") as f:
                    f.write(line + "\n")
            except OSError as exc:
                # a full disk / unwritable event file must not fail
                # the caller — but the drop is COUNTED
                # (mdtpu_obs_write_errors_total{sink="log_json"}) and
                # warned once, never silently swallowed
                # (docs/RELIABILITY.md §5)
                from mdanalysis_mpi_tpu_torch.obs import METRICS

                METRICS.inc("mdtpu_obs_write_errors_total",
                            sink="log_json")
                global _DROP_WARNED
                if not _DROP_WARNED:
                    _DROP_WARNED = True
                    get_logger().warning(
                        "MDTPU_LOG_JSON append to %s failed (%s); "
                        "events are being dropped (counted in "
                        "mdtpu_obs_write_errors_total)", mode, exc)
    else:
        get_logger().info("%s %s", event,
                          " ".join(f"{k}={v}" for k, v in fields.items()))
