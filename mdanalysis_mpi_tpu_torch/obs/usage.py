"""Per-tenant usage metering: the tenant-facing accounting ledger.

The obs tier below this module is operator-facing — it can say the
fleet is slow, but not *which tenant consumed what*.  This module adds
the accounting layer the QoS/shed/autoscale machinery needs to be
tuned against real per-tenant cost (the per-task resource attribution
argument of 1907.00097 / 1801.07630 at serving scale): a
:class:`UsageLedger` of **monotone meters per (tenant, qos_class)**,
charged at the existing span/phase boundaries:

==========================  =============================================
meter                       charge site
==========================  =============================================
``frames``                  scheduler ``_run_unit`` / ``_run_solo`` /
                            ``_run_streaming_unit`` (per member, exact)
``dispatch_s``              same sites — wall seconds around the run,
                            split pro-rata for coalesced passes
``staged_bytes``            executors ``_stage_op`` (every host stage)
``cache_byte_seconds``      executors ``_run_batches`` — bytes × seconds
                            resident from cache insert to pass end
``store_chunks/bytes``      store reader ``_load_raw``, labeled
                            ``source=`` local / remote / cache
``jobs`` (by outcome)       the journal's terminal-record sites — the
                            scheduler's ``_finish`` standalone, the
                            controller's four finish/quarantine/shed
                            sites on a fleet — so the jobs meter
                            reconciles EXACTLY against the journal's
                            finish ledger (:func:`reconcile`)
==========================  =============================================

**Pro-rata policy (disclosed):** a coalesced pass does one physical
read+stage+dispatch for N member jobs; shared meters are split by
member frame count via :func:`split_amount` — integer meters by
largest remainder, float meters remainder-to-last — so the member
charges sum EXACTLY to the merged pass's total (invariant-tested).
The scheduler stamps ``usage_weights=[(tenant, class, frames), ...]``
into the span trace context; :func:`charge_current` anywhere
downstream (staging threads, the store reader) reads it back and
splits.  No context → no charge: direct ``run()`` calls outside the
serving path cost nothing.

Every charge also mirrors into the global :data:`~mdanalysis_mpi_tpu_torch.
obs.metrics.METRICS` registry (``mdtpu_usage_*`` counters labeled
``tenant=``/``class=``), so the fleet heartbeat piggyback federates
per-tenant usage across a fleet for free; :func:`ledger_from_snapshot`
parses the federated view back out of any unified snapshot and
:func:`usage_doc` renders the ``/usage`` endpoint / ``mdtpu usage``
document.  Kill -9 semantics: resource meters shipped on heartbeats
are best-effort lower bounds (a killed host's unshipped deltas are
lost with the host), but the **jobs meter is exact** — only the
journal writer charges it, so it survives anything the journal
survives.

Metering defaults ON; ``MDTPU_USAGE=0`` (or :func:`disable`) turns it
off — the bench's ``usage_*`` leg measures the on/off overhead.
"""

from __future__ import annotations

import os
import re
import threading

from mdanalysis_mpi_tpu_torch.obs import metrics as _metrics

#: Resource meter name -> mirrored registry counter (tenant=/class=
#: labels).  Store meters and the jobs meter carry extra labels and
#: are mirrored separately.
METER_METRICS = {
    "frames": "mdtpu_usage_frames_total",
    "staged_bytes": "mdtpu_usage_staged_bytes_total",
    "cache_byte_seconds": "mdtpu_usage_cache_byte_seconds_total",
    "dispatch_s": "mdtpu_usage_dispatch_seconds_total",
}

#: Meters split as integers (largest-remainder) by
#: :func:`split_amount`; everything else splits as floats
#: (remainder-to-last).
_INT_METERS = frozenset(("frames", "staged_bytes"))

_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def _env_enabled() -> bool:
    return os.environ.get("MDTPU_USAGE", "1").strip().lower() \
        not in ("0", "false", "no", "off")


def parse_labels(key: str) -> dict:
    """Invert :func:`~mdanalysis_mpi_tpu_torch.obs.metrics.label_key`:
    ``'class="batch",tenant="a"'`` → ``{"class": "batch",
    "tenant": "a"}`` ("" → ``{}``)."""
    return dict(_LABEL_RE.findall(key))


def split_amount(total, weights):
    """Split ``total`` over ``weights`` (member frame counts),
    returning one share per weight that **sums exactly to total**.

    Integer totals use largest-remainder apportionment (ties broken by
    position); float totals give every member its exact pro-rata share
    except the last, which absorbs the floating-point remainder.  Zero
    or empty weights fall back to an equal split."""
    n = len(weights)
    if n == 0:
        return []
    if n == 1:
        return [total]
    wsum = float(sum(weights))
    if wsum <= 0:
        weights = [1] * n
        wsum = float(n)
    if isinstance(total, int):
        raw = [total * w / wsum for w in weights]
        shares = [int(r) for r in raw]
        short = total - sum(shares)
        # largest fractional part first; stable on ties
        order = sorted(range(n), key=lambda i: raw[i] - shares[i],
                       reverse=True)
        for i in order[:short]:
            shares[i] += 1
        return shares
    shares = [total * w / wsum for w in weights[:-1]]
    shares.append(total - sum(shares))
    return shares


class UsageLedger:
    """Locked in-memory rows of monotone meters per (tenant, class),
    mirrored into a :class:`~mdanalysis_mpi_tpu_torch.obs.metrics.
    MetricsRegistry` on every charge (federation rides the metrics
    ships).  The in-memory rows exist for fast LIVE reads — budget
    admission (:meth:`dispatch_s_for`) runs on the submit path."""

    def __init__(self, registry: _metrics.MetricsRegistry | None = None):
        self._lock = threading.Lock()
        # (tenant, qos) -> {meter: value}
        self._rows: dict[tuple, dict] = {}
        self._registry = registry
        self.enabled = _env_enabled()

    @property
    def registry(self) -> _metrics.MetricsRegistry:
        return self._registry if self._registry is not None \
            else _metrics.METRICS

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def _row_locked(self, tenant: str, qos: str) -> dict:
        # `_locked` suffix: the caller holds self._lock (MDT001)
        return self._rows.setdefault((str(tenant), str(qos)), {})

    def charge(self, tenant: str, qos: str, **meters) -> None:
        """Charge resource meters (keys of :data:`METER_METRICS`) to
        one (tenant, class) row; zero/falsy meters are skipped."""
        if not self.enabled:
            return
        live = {k: v for k, v in meters.items() if v}
        if not live:
            return
        with self._lock:
            row = self._row_locked(tenant, qos)
            for k, v in live.items():
                row[k] = row.get(k, 0) + v
        reg = self.registry
        for k, v in live.items():
            reg.inc(METER_METRICS[k], v, tenant=tenant, **{"class": qos})

    def charge_store(self, tenant: str, qos: str, source: str,
                     chunks: int = 0, nbytes: int = 0) -> None:
        """Charge a store read, attributed to its serving rung
        (``source=`` local / remote / cache)."""
        if not self.enabled or not (chunks or nbytes):
            return
        with self._lock:
            row = self._row_locked(tenant, qos)
            key = f"store_chunks[{source}]"
            row[key] = row.get(key, 0) + chunks
            key = f"store_bytes[{source}]"
            row[key] = row.get(key, 0) + nbytes
        reg = self.registry
        if chunks:
            reg.inc("mdtpu_usage_store_chunks_total", chunks,
                    tenant=tenant, source=source, **{"class": qos})
        if nbytes:
            reg.inc("mdtpu_usage_store_bytes_total", nbytes,
                    tenant=tenant, source=source, **{"class": qos})

    def charge_job(self, tenant: str, qos: str, outcome: str) -> None:
        """Charge one finished job by outcome.  NOT gated on
        :attr:`enabled`: this is the exactly-once meter
        :func:`reconcile` audits against the journal, so it stays
        exact even while resource metering is benched off."""
        with self._lock:
            row = self._row_locked(tenant, qos)
            key = f"jobs[{outcome}]"
            row[key] = row.get(key, 0) + 1
        self.registry.inc("mdtpu_usage_jobs_total", tenant=tenant,
                          outcome=outcome, **{"class": qos})

    def charge_split(self, weights, **meters) -> None:
        """Split meters pro-rata over ``weights`` (``[(tenant, qos,
        frames), ...]``) and charge each member — the disclosed
        coalesced-pass policy (module docstring)."""
        if not self.enabled or not weights:
            return
        counts = [w[2] for w in weights]
        for k, total in meters.items():
            if not total:
                continue
            if k in _INT_METERS:
                total = int(total)
            shares = split_amount(total, counts)
            for (tenant, qos, _), share in zip(weights, shares):
                if share:
                    self.charge(tenant, qos, **{k: share})

    def dispatch_s_for(self, tenant: str) -> float:
        """Live dispatch-seconds consumed by one tenant across all
        classes — what budget admission reads."""
        tenant = str(tenant)
        with self._lock:
            return float(sum(row.get("dispatch_s", 0.0)
                             for (t, _), row in self._rows.items()
                             if t == tenant))

    def rows(self) -> dict:
        """Deep-copied ``{(tenant, class): {meter: value}}``."""
        with self._lock:
            return {k: dict(v) for k, v in self._rows.items()}

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()


#: Process-global ledger — the charge sink for the scheduler,
#: executors, and store reader.
LEDGER = UsageLedger()


def enabled() -> bool:
    return LEDGER.enabled


def enable() -> None:
    LEDGER.enable()


def disable() -> None:
    LEDGER.disable()


def current_weights():
    """The ``usage_weights`` the scheduler stamped into the span trace
    context for the pass running on this thread (``[(tenant, class,
    frames), ...]``), or None outside the serving path."""
    from mdanalysis_mpi_tpu_torch.obs import spans as _spans
    ctx = _spans.current_context()
    if not ctx:
        return None
    return ctx.get("usage_weights")


def charge_current(**meters) -> None:
    """Charge meters to whatever pass is running on this thread, split
    pro-rata over the context's ``usage_weights``.  **No-op without a
    serving context** — direct ``run()`` calls cost nothing."""
    if not LEDGER.enabled:
        return
    weights = current_weights()
    if weights:
        LEDGER.charge_split(weights, **meters)


def charge_current_store(source: str, chunks: int = 0,
                         nbytes: int = 0) -> None:
    """Store-read variant of :func:`charge_current` (``source=``
    attribution; chunk counts split largest-remainder)."""
    if not LEDGER.enabled or not (chunks or nbytes):
        return
    weights = current_weights()
    if not weights:
        return
    counts = [w[2] for w in weights]
    cshares = split_amount(int(chunks), counts)
    bshares = split_amount(int(nbytes), counts)
    for (tenant, qos, _), cs, bs in zip(weights, cshares, bshares):
        if cs or bs:
            LEDGER.charge_store(tenant, qos, source,
                                chunks=cs, nbytes=bs)


# ---------------------------------------------------------------------------
# Federated view: parse the ledger back out of a unified snapshot
# ---------------------------------------------------------------------------

def ledger_from_snapshot(snap: dict) -> dict:
    """Rebuild ``{(tenant, class): {meter: value}}`` from the
    ``mdtpu_usage_*`` series of a (possibly fleet-merged) unified
    snapshot — the federated twin of :meth:`UsageLedger.rows`.
    Zero-injected unlabeled series are skipped."""
    rows: dict[tuple, dict] = {}

    def _fold(name, meter, extra=None):
        series = snap.get(name)
        if not series:
            return
        for lk, v in series.get("values", {}).items():
            lb = parse_labels(lk)
            tenant = lb.get("tenant")
            if tenant is None:
                continue
            key = (tenant, lb.get("class", ""))
            m = meter if extra is None else f"{meter}[{lb.get(extra, '')}]"
            row = rows.setdefault(key, {})
            row[m] = row.get(m, 0) + v

    for meter, name in METER_METRICS.items():
        _fold(name, meter)
    _fold("mdtpu_usage_store_chunks_total", "store_chunks", extra="source")
    _fold("mdtpu_usage_store_bytes_total", "store_bytes", extra="source")
    _fold("mdtpu_usage_jobs_total", "jobs", extra="outcome")
    return rows


def usage_doc(snap: dict, top: int | None = None) -> dict:
    """The tenant-facing usage document the ``/usage`` endpoint and
    ``mdtpu usage`` CLI serve: per-tenant totals (meters summed over
    classes, store/jobs kept split), per-class rollups, and the top-N
    tenants by dispatch-seconds."""
    rows = ledger_from_snapshot(snap)
    tenants: dict[str, dict] = {}
    classes: dict[str, dict] = {}
    for (tenant, qos), row in rows.items():
        t = tenants.setdefault(tenant, {"classes": {}})
        c = t["classes"].setdefault(qos, {})
        cls = classes.setdefault(qos, {})
        for meter, v in row.items():
            t[meter] = round(t.get(meter, 0) + v, 6)
            c[meter] = round(c.get(meter, 0) + v, 6)
            cls[meter] = round(cls.get(meter, 0) + v, 6)
    ranked = sorted(tenants,
                    key=lambda t: tenants[t].get("dispatch_s", 0.0),
                    reverse=True)
    if top is not None:
        ranked = ranked[:top]
    return {"tenants": tenants, "classes": classes, "top": ranked}


def render_usage(doc: dict, top: int | None = None) -> str:
    """Human rendering of :func:`usage_doc` for the CLI: one row per
    tenant, ranked by dispatch-seconds."""
    ranked = doc.get("top") or []
    if top is not None:
        ranked = ranked[:top]
    lines = [f"{'tenant':<20} {'dispatch_s':>11} {'frames':>10} "
             f"{'staged_MB':>10} {'jobs':>6}"]
    for tenant in ranked:
        row = doc["tenants"].get(tenant, {})
        jobs = sum(v for k, v in row.items() if k.startswith("jobs["))
        lines.append(
            f"{tenant:<20} {row.get('dispatch_s', 0.0):>11.3f} "
            f"{int(row.get('frames', 0)):>10} "
            f"{row.get('staged_bytes', 0) / 1e6:>10.2f} {int(jobs):>6}")
    if not ranked:
        lines.append("(no usage recorded)")
    cls = doc.get("classes") or {}
    if cls:
        lines.append("")
        lines.append(f"{'class':<20} {'dispatch_s':>11} {'frames':>10} "
                     f"{'jobs':>6}")
        for qos in sorted(cls):
            row = cls[qos]
            jobs = sum(v for k, v in row.items()
                       if k.startswith("jobs["))
            lines.append(
                f"{qos:<20} {row.get('dispatch_s', 0.0):>11.3f} "
                f"{int(row.get('frames', 0)):>10} {int(jobs):>6}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Reconciliation against the journal's finish ledger
# ---------------------------------------------------------------------------

def _jobs_by_outcome(snap: dict) -> dict:
    """``{"tenant/outcome": n}`` from one snapshot's jobs meter."""
    got: dict[str, int] = {}
    for (tenant, _), row in ledger_from_snapshot(snap).items():
        for meter, v in row.items():
            if meter.startswith("jobs["):
                key = f"{tenant}/{meter[5:-1]}"
                got[key] = got.get(key, 0) + int(v)
    return got


def reconcile(snap: dict, journal, baseline: dict | None = None) -> dict:
    """Audit the federated jobs meter against the journal's
    exactly-once finish ledger: every accepted terminal record
    (finish/quarantine) must appear as exactly one
    ``mdtpu_usage_jobs_total`` charge with the same tenant and
    outcome.  ``journal`` is a :func:`~mdanalysis_mpi_tpu_torch.service.
    journal.replay_fleet` result or a journal path; ``baseline`` is
    an optional earlier snapshot whose job counts are subtracted
    first — how a process that served OTHER work before this journal
    opened (the bench) still reconciles exactly.  Returns
    ``{"ok", "usage", "journal", "diff"}`` with ``(tenant, outcome)``
    count maps (rendered as ``"tenant/outcome"`` keys)."""
    if isinstance(journal, (str, os.PathLike)):
        try:
            from mdanalysis_mpi_tpu_torch.service.journal import (
                replay_fleet)
        except ImportError as exc:
            raise NotImplementedError(
                "reconciling against a journal path needs "
                "service/journal, which the port does not have yet "
                "(ROADMAP A10); pass a replayed journal dict") from exc
        journal = replay_fleet(journal)
    want: dict[str, int] = {}
    for fp, n in journal.get("finishes", {}).items():
        job = journal.get("jobs", {}).get(fp, {})
        tenant = job.get("tenant") or "default"
        outcome = job.get("state", "done")
        key = f"{tenant}/{outcome}"
        want[key] = want.get(key, 0) + n
    got = _jobs_by_outcome(snap)
    if baseline is not None:
        for k, n in _jobs_by_outcome(baseline).items():
            got[k] = got.get(k, 0) - n
        got = {k: v for k, v in got.items() if v}
    diff = {k: {"usage": got.get(k, 0), "journal": want.get(k, 0)}
            for k in set(got) | set(want)
            if got.get(k, 0) != want.get(k, 0)}
    return {"ok": not diff, "usage": got, "journal": want, "diff": diff}
