"""Metrics registry: counters, gauges, histograms — one snapshot.

Before this module, four subsystems each tracked their numbers
privately: ``PhaseTimers`` (phase seconds/calls), ``BlockCache``
(hit/miss/bytes), ``ServiceTelemetry`` (job lifecycle, coalesce and
admission counters, latency percentiles), and the reliability report
(retries, drops, fallbacks).  The registry unifies them behind one
schema:

- **Live series** — recorded directly by instrumented code paths into
  the process-global :data:`METRICS`: run counts, reliability retry /
  drop / fallback / fault counters, and the fixed-bucket queue-wait and
  job-latency histograms the scheduler feeds per finished job.
- **Collected series** — adapters in :func:`unified_snapshot` pull a
  ``PhaseTimers``, a ``BlockCache`` and a ``ServiceTelemetry`` into the
  same document at snapshot time (they stay the single source of truth
  for their own numbers; the registry does not fork the accounting).

Snapshot shape (JSON-friendly, pinned by
``tests/test_bench_contract.py``)::

    {"mdtpu_runs_total": {"type": "counter",
                          "values": {'backend="serial"': 3}},
     "mdtpu_queue_wait_seconds": {"type": "histogram",
        "values": {"": {"count": 9, "sum": 0.04,
                        "buckets": {"0.001": 2, ..., "+Inf": 9}}}},
     ...}

:func:`to_prometheus` renders the same snapshot as Prometheus text
exposition (``# TYPE`` lines, cumulative ``_bucket{le=...}`` series).
Everything is lock-guarded; recording costs one lock + dict update —
cheap enough to stay always-on (per block / per job, never per frame).

The known-metric tables below are the JAX package's schema, kept whole
so both packages' snapshots carry the same names.
"""

from __future__ import annotations

import threading

#: Fixed histogram buckets for queue-wait / latency seconds ("le"
#: upper bounds; "+Inf" is implicit).  Fixed by design: merged or
#: long-lived snapshots stay comparable across processes and rounds.
TIME_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0)


def label_key(labels: dict) -> str:
    """Canonical label rendering: ``k="v"`` pairs, sorted, joined by
    commas; "" for the unlabeled series."""
    return ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))


class MetricsRegistry:
    """Counters, gauges and fixed-bucket histograms, keyed by
    ``(name, labels)``; one JSON snapshot, one Prometheus rendering."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"type": t, "values": {label_key: scalar | hist}}
        self._series: dict[str, dict] = {}
        self._buckets: dict[str, tuple] = {}

    def _values_locked(self, name: str, typ: str) -> dict:
        # `_locked` suffix: the caller holds self._lock (the repo
        # convention `mdtpu lint` MDT001 enforces — docs/LINT.md)
        s = self._series.get(name)
        if s is None:
            s = {"type": typ, "values": {}}
            self._series[name] = s
        elif s["type"] != typ:
            raise ValueError(
                f"metric {name!r} is a {s['type']}, not a {typ}")
        return s["values"]

    def inc(self, name: str, value: float = 1, **labels) -> None:
        key = label_key(labels)
        with self._lock:
            vals = self._values_locked(name, "counter")
            vals[key] = vals.get(key, 0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._values_locked(name, "gauge")[label_key(labels)] = value

    def observe(self, name: str, value: float,
                buckets: tuple = TIME_BUCKETS, **labels) -> None:
        key = label_key(labels)
        # exemplar: the trace id attributed to the observing thread
        # (the span context) — resolved outside the lock; the bucket
        # this observation lands in remembers the LAST such id, so a
        # p99 bucket links to an actual Chrome trace
        tid = None
        from mdanalysis_mpi_tpu_torch.obs import spans as _spans
        ids = _spans.current_trace_ids()
        if ids:
            tid = sorted(ids)[0]
        with self._lock:
            bk = self._buckets.setdefault(name, tuple(buckets))
            vals = self._values_locked(name, "histogram")
            h = vals.get(key)
            if h is None:
                h = {"count": 0, "sum": 0.0,
                     "buckets": [0] * (len(bk) + 1)}
                vals[key] = h
            h["count"] += 1
            h["sum"] += float(value)
            # cumulative counts, the Prometheus "le" convention
            for i, le in enumerate(bk):
                if value <= le:
                    h["buckets"][i] += 1
            h["buckets"][-1] += 1                    # +Inf
            if tid is not None:
                # non-cumulative: keyed by the FIRST bucket the value
                # fits (its natural bucket), latest observation wins
                idx = next((i for i, le in enumerate(bk)
                            if value <= le), len(bk))
                h.setdefault("exemplars", {})[idx] = [tid, float(value)]

    def counter(self, name: str) -> dict:
        """A copy of counter ``name``'s values by label key ({} when
        nothing recorded it) — what a run report subtracts against,
        without the whole snapshot's copy."""
        with self._lock:
            s = self._series.get(name)
            return dict(s["values"]) if s is not None else {}

    def snapshot(self) -> dict:
        """Deep-copied JSON document of every series (see module
        docstring for the shape)."""
        with self._lock:
            out = {}
            for name, s in self._series.items():
                if s["type"] == "histogram":
                    bk = self._buckets[name]
                    les = [repr(float(le)) for le in bk] + ["+Inf"]
                    vals = {}
                    for k, h in s["values"].items():
                        entry = {"count": h["count"],
                                 "sum": round(h["sum"], 6),
                                 "buckets": dict(zip(les, h["buckets"]))}
                        ex = h.get("exemplars")
                        if ex:
                            entry["exemplars"] = {
                                les[i]: {"trace_id": t, "value": v}
                                for i, (t, v) in sorted(ex.items())}
                        vals[k] = entry
                else:
                    vals = dict(s["values"])
                out[name] = {"type": s["type"], "values": vals}
            return out

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._buckets.clear()


#: Process-global default registry — the live-series sink for
#: AnalysisBase.run, the scheduler, and the reliability runtime.
METRICS = MetricsRegistry()


#: ServiceTelemetry snapshot key → metric name (all counters except the
#: two depth gauges).  One table so the adapter and the schema test
#: cannot drift apart.
_TELEMETRY_COUNTERS = (
    "jobs_submitted", "jobs_completed", "jobs_failed", "jobs_expired",
    "coalesced_jobs", "coalesce_batches", "solo_jobs",
    "uncoalescable_jobs", "coalesce_fallbacks", "admission_reserved",
    "admission_resident", "admission_deferrals", "admission_uncached",
    "admission_evictions", "admission_shed_serial", "prefetch_jobs",
    "prefetch_blocks", "prefetch_skipped", "jobs_aborted",
    "breaker_reroutes", "workers_respawned",
)
_TELEMETRY_GAUGES = ("queue_depth", "queue_depth_peak")

#: Compile/AOT counters owned by utils/compile_cache.py (which imports
#: this table — obs imports stdlib only).  Zero-injected into
#: :func:`unified_snapshot` so the pinned schema
#: (tests/test_bench_contract.py PINNED_METRICS) holds even in
#: processes that never touched jax — e.g. the bench host legs, which
#: deliberately run before any accelerator contact.
COMPILE_METRICS = (
    "mdtpu_compile_total",
    "mdtpu_compile_seconds",
    "mdtpu_compile_cache_hits_total",
    "mdtpu_compile_cache_misses_total",
    "mdtpu_aot_compiled_total",
    "mdtpu_aot_dispatches_total",
)

#: Circuit-breaker series owned by reliability/breaker.py (written
#: live into the global registry on every state transition).
#: Zero-injected into :func:`unified_snapshot` so the pinned schema
#: (tests/test_bench_contract.py PINNED_METRICS) holds in processes
#: where no breaker ever tripped — the healthy case.
BREAKER_COUNTERS = ("mdtpu_breaker_transitions_total",)
BREAKER_GAUGES = ("mdtpu_breaker_state",)

#: Supervision counters owned by service/scheduler.py, written live
#: into the global registry at the incident site — WITH labels
#: (``mdtpu_lease_expired_total`` carries ``reason=``) that a flat
#: ServiceTelemetry mapping would overwrite, so these are deliberately
#: NOT in :data:`_TELEMETRY_COUNTERS`.  Zero-injected like the breaker
#: series so the pinned schema holds in healthy processes.
SUPERVISION_COUNTERS = (
    "mdtpu_lease_expired_total",
    "mdtpu_jobs_quarantined_total",
    "mdtpu_jobs_requeued_total",
)

#: Reliability-runtime counters (reliability/policy.py, faults.py) —
#: labeled at the incident site (``site=``), recorded live.  Newly
#: zero-injected so the healthy-process snapshot carries the full
#: schema and the names can be pinned (`mdtpu lint` MDT201 flagged
#: them as recorded-but-unpinned).
RELIABILITY_COUNTERS = (
    "mdtpu_retries_total",
    "mdtpu_dropped_frames_total",
    "mdtpu_executor_fallbacks_total",
    "mdtpu_faults_injected_total",
)

#: Static-analysis outcome gauges (lint/cli.py sets them after a run:
#: how many rules ran, how many unbaselined findings remain —
#: docs/LINT.md).  Zero-injected so the schema holds in processes
#: that never linted.
LINT_GAUGES = (
    "mdtpu_lint_rules",
    "mdtpu_lint_findings",
)

#: End-to-end data-integrity counters (utils/integrity.py, the
#: journal's in-memory degradation, obs' own disclosed write drops —
#: docs/RELIABILITY.md §5).  Labeled at the incident site
#: (``artifact=`` / ``sink=``), recorded live; zero-injected so the
#: healthy-process snapshot carries the full schema.
INTEGRITY_COUNTERS = (
    "mdtpu_integrity_write_errors_total",
    "mdtpu_integrity_verifications_total",
    "mdtpu_integrity_corrupt_total",
    "mdtpu_obs_write_errors_total",
)

#: Integrity gauges: ``mdtpu_integrity_journal_degraded`` flips to 1
#: when the journal falls back to in-memory on a failed write;
#: ``mdtpu_staged_bytes_peak`` is the staged-pressure high-water the
#: scheduler's memory watchdog reads (0 = never under pressure /
#: no cache attached).
INTEGRITY_GAUGES = (
    "mdtpu_integrity_journal_degraded",
    "mdtpu_staged_bytes_peak",
)

#: SDC-scrub counters (DeviceBlockCache.scrub, the scheduler's
#: ``scrub=`` thread — docs/RELIABILITY.md §5): passes run, resident
#: blocks verified, mismatches quarantined.
SCRUB_COUNTERS = (
    "mdtpu_scrub_passes_total",
    "mdtpu_scrub_blocks_total",
    "mdtpu_scrub_corrupt_total",
    "mdtpu_scrub_fetch_errors_total",
)

#: Block-store counters (io/store — docs/STORE.md): chunks written at
#: ingest, chunks fetched+verified at read, and read-time fingerprint
#: rejections (the SDC-scrub comparison moved to the read boundary).
#: Recorded live at the codec boundary; zero-injected so a process
#: that never touched a store still carries the schema.
STORE_COUNTERS = (
    "mdtpu_store_chunks_ingested_total",
    "mdtpu_store_chunks_read_total",
    "mdtpu_store_chunk_crc_rejects_total",
)

#: Remote-store-tier counters (io/store/remote.py — docs/STORE.md
#: "Remote backend"): HTTP round trips (labeled ``verb=``), classified
#: transport failures (labeled ``kind=`` — timeout / reset / truncated
#: / http_5xx / corrupt), the retry/hedge envelope, degradation-ladder
#: traffic (mirror reads, terminal unavailability), and the
#: content-addressing dedup ledger (chunks skipped because the CAS
#: object already existed, and the bytes those skips did not move).
#: Recorded live at the network boundary; zero-injected so a process
#: that never touched a remote store still carries the schema.
STORE_REMOTE_COUNTERS = (
    "mdtpu_store_remote_requests_total",
    "mdtpu_store_remote_errors_total",
    "mdtpu_store_remote_retries_total",
    "mdtpu_store_remote_hedges_total",
    "mdtpu_store_mirror_reads_total",
    "mdtpu_store_unavailable_total",
    "mdtpu_store_chunks_deduped_total",
    "mdtpu_store_dedup_bytes_total",
)

#: Per-host read-through chunk-cache series (io/store/remote.py
#: ChunkCache — step 2 of the degradation ladder): hit/miss counters
#: and the resident-byte gauge.  Distinct from the staged BlockCache
#: series (``mdtpu_cache_*``): this cache holds verified chunk BYTES
#: below the decode boundary, not staged arrays.
STORE_CACHE_COUNTERS = (
    "mdtpu_store_cache_hits_total",
    "mdtpu_store_cache_misses_total",
)
STORE_CACHE_GAUGES = (
    "mdtpu_store_cache_bytes",
)

#: Fleet-tier series (service/fleet.py, docs/RELIABILITY.md §6):
#: host-loss migration and epoch fencing, recorded live at the
#: controller's incident sites (labeled ``reason=``) and zero-injected
#: so a process that never ran a fleet still carries the schema.
FLEET_COUNTERS = (
    "mdtpu_hosts_lost_total",
    "mdtpu_jobs_migrated_total",
    "mdtpu_epoch_fenced_rejects_total",
)

#: Fleet gauges: live host membership and the controller's fencing
#: epoch (0 = this process is not a fleet controller).
FLEET_GAUGES = (
    "mdtpu_hosts_alive",
    "mdtpu_controller_epoch",
)

#: Fleet-observability counters (docs/OBSERVABILITY.md "Fleet
#: federation"): host-side metric ships and trace-event batches
#: piggybacked on heartbeats (drops disclosed, labeled ``site=``),
#: flight-recorder dumps (labeled ``trigger=`` — obs/flight.py), and
#: status-endpoint requests (labeled ``route=`` —
#: service/statusd.py).  Recorded live at each site; zero-injected so
#: a process that never federated still carries the schema.
FLEET_OBS_COUNTERS = (
    "mdtpu_fleet_obs_metrics_ships_total",
    "mdtpu_fleet_obs_trace_events_total",
    "mdtpu_fleet_obs_trace_dropped_total",
    "mdtpu_flight_dumps_total",
    "mdtpu_status_requests_total",
)

#: Fleet-observability gauges: how many hosts have a metrics snapshot
#: merged into the controller's fleet view (0 = not federating).
FLEET_OBS_GAUGES = (
    "mdtpu_fleet_hosts_reporting",
)

#: QoS + elasticity counters (docs/RELIABILITY.md §7 "Overload and
#: elasticity"): overload sheds (labeled ``class=``), typed admission
#: rejects (labeled ``reason=`` — queue_full/rate_limit/tenant_quota),
#: and the autoscaler's host scale events.  Recorded live at the
#: scheduler's/controller's incident sites; zero-injected so a process
#: that never overloaded still carries the schema.
QOS_COUNTERS = (
    "mdtpu_jobs_shed_total",
    "mdtpu_admission_rejects_total",
    "mdtpu_hosts_scaled_up_total",
    "mdtpu_hosts_scaled_down_total",
)

#: QoS gauges: per-class latency-SLO attainment (labeled ``class=`` —
#: the fraction of completed jobs meeting the configured target,
#: docs/RELIABILITY.md §7).  0 = no completed jobs in that class yet.
QOS_GAUGES = (
    "mdtpu_slo_attainment",
)

#: Continuous-profiler counters (obs/prof.py —
#: docs/OBSERVABILITY.md "Alerting & profiling"): sampler ticks, recorded live
#: by the sampling thread; zero-injected so a process that never profiled still
#: carries the schema.
PROF_COUNTERS = (
    "mdtpu_prof_samples_total",
)

#: Profiler watermark gauges: current/peak RSS as sampled by the
#: profiler's watermark tick (0 = profiler never ran here).
PROF_GAUGES = (
    "mdtpu_prof_rss_bytes",
    "mdtpu_prof_rss_peak_bytes",
)

#: Profiler histograms: per-dispatch kernel latency, labeled by
#: program geometry (``geometry=`` — batch size × scan group length)
#: and ``engine=`` (``generic`` dequant+align program vs ``fused``
#: quantized-native planar program; obs/prof.py note_dispatch).
#: Zero-injected with an EMPTY series set: a histogram has no
#: meaningful zero point, but the name/type must hold in every
#: snapshot for the pinned schema.
PROF_HISTOGRAMS = (
    "mdtpu_dispatch_ms",
)

#: Fused-kernel counters (ops/fused_planar.py, io/base.py::planar_repack):
#: blocks dispatched through a fused quantized-native program, host
#: planar repacks paid at the staging boundary (io/base.planar_repack
#: — the fused path's one host copy, where no native pass writes the
#: planes itself), and trace-time fallbacks to the
#: generic schedule (shape-ineligible planar tiles, mesh executors).
#: Recorded live at the dispatch/staging sites; zero-injected so a
#: process that never ran the fused engine still carries the schema.
FUSED_COUNTERS = (
    "mdtpu_fused_blocks_total",
    "mdtpu_fused_planar_repacks_total",
    "mdtpu_fused_fallbacks_total",
)

#: Alerting series (obs/alerts.py — docs/OBSERVABILITY.md
#: "Alerting & profiling"): per-rule firing level (1 while any series of the
#: rule fires) and the firing/resolved transition counter (labeled
#: ``rule=``/``to=``).  Recorded live at each transition; zero-injected so a
#: healthy process still carries the schema.
ALERT_COUNTERS = (
    "mdtpu_alert_transitions_total",
)
ALERT_GAUGES = (
    "mdtpu_alerts_firing",
)

#: Ensemble scale-out series (docs/ENSEMBLE.md): trajectory-set
#: parents accepted, member children fanned out / settled (labeled
#: ``state=``), cross-trajectory merges applied at the controller, the
#: parallel ingest pre-stage's member ingests (io/store/parallel.py
#: counts these), and the cross-member chunk dedup ratio the last
#: merged ensemble disclosed.  Zero-injected so the pinned schema
#: holds in processes that never ran an ensemble.
ENSEMBLE_COUNTERS = (
    "mdtpu_ensemble_jobs_total",
    "mdtpu_ensemble_members_total",
    "mdtpu_ensemble_members_completed_total",
    "mdtpu_ensemble_merges_total",
    "mdtpu_ensemble_ingest_members_total",
    "mdtpu_ensemble_ingest_failures_total",
)
ENSEMBLE_GAUGES = (
    "mdtpu_ensemble_dedup_ratio",
)

#: Streaming-tier series (docs/STREAMING.md): frames reduced by live
#: passes, partial snapshots emitted, tail-manifest epochs consumed,
#: chunks sealed by live ingest, streaming parks (labeled ``reason=``:
#: ``stall`` — feed went dry; ``shed`` — overload controller parked
#: instead of killing), and the age of the newest snapshot (the
#: ``stream_staleness`` seed alert watches this gauge).  Zero-injected
#: so the pinned schema holds in processes that never streamed.
STREAM_COUNTERS = (
    "mdtpu_stream_frames_total",
    "mdtpu_stream_snapshots_total",
    "mdtpu_stream_epochs_total",
    "mdtpu_stream_chunks_sealed_total",
    "mdtpu_stream_parks_total",
)
STREAM_GAUGES = (
    "mdtpu_stream_snapshot_age_seconds",
)

#: Per-tenant usage-metering counters (obs/usage.py UsageLedger —
#: docs/OBSERVABILITY.md "Usage metering, exemplars & canary").  Every
#: series is labeled ``tenant=``/``class=`` (store meters add
#: ``source=`` — local/remote/cache; the jobs meter adds
#: ``outcome=``); the ledger mirrors its charges into the global
#: registry so the fleet heartbeat piggyback federates them for free.
#: Zero-injected so a process that never metered still carries the
#: schema.
USAGE_COUNTERS = (
    "mdtpu_usage_frames_total",
    "mdtpu_usage_staged_bytes_total",
    "mdtpu_usage_cache_byte_seconds_total",
    "mdtpu_usage_dispatch_seconds_total",
    "mdtpu_usage_store_chunks_total",
    "mdtpu_usage_store_bytes_total",
    "mdtpu_usage_jobs_total",
)

#: Synthetic-canary black-box SLIs (service/canary.py — the reserved
#: background-class pseudo-tenant probing the full serving path on the
#: supervisor tick).  Failures are labeled ``stage=`` (submit / store /
#: stage / kernel / oracle / timeout); the consecutive-failures gauge
#: feeds the ``canary_failing`` seed alert.  Zero-injected so a
#: process that never probed still carries the schema.
CANARY_COUNTERS = (
    "mdtpu_canary_probes_total",
    "mdtpu_canary_failures_total",
)
CANARY_GAUGES = (
    "mdtpu_canary_consecutive_failures",
)
CANARY_HISTOGRAMS = (
    "mdtpu_canary_latency_seconds",
)

#: Staging counters, the port's own (the JAX package has no such
#: table): blocks staged, labeled ``path=`` by the staging path that
#: ran (``native`` — the C++ gather/quantize; ``native_planar`` — the
#: C++ gather, quantize and planar write of a ``MemoryReader``'s planar
#: int16 block (or of a fresh ``XTCReader``'s first, decoded block),
#: over host threads; ``xtc_planar`` — ``XTCReader``'s decode, gather,
#: quantize and planar write of a planar int16 block in one C++ pass
#: over host threads; ``numpy`` — a NumPy
#: quantize or gather, the native library's fallback included;
#: ``store_direct`` — the block store's raw chunk slices; ``generic`` —
#: the reader's frame-by-frame ``read_block``), the host bytes the
#: executors hand to the copy to the device, and of ``XTCReader``'s
#: staging the compressed bytes its native decodes read and the blocks
#: it decoded twice (an adaptive scale that overflowed).  Recorded live
#: at the readers' staging sites and ``executors._run_batches``'
#: ``_place``; a run's deltas ride its report as
#: ``observability["staging"]``.
STAGING_COUNTERS = (
    "mdtpu_stage_blocks_total",
    "mdtpu_staged_bytes_total",
    "mdtpu_xtc_decoded_bytes_total",
    "mdtpu_xtc_redecodes_total",
)

#: Staging gauge, the port's own: the host threads the last native
#: planar staging pass split its frames over (``io/memory.py``,
#: ``io/xtc.py``, ``io.native.stage_threads``: the process's cores over the ranks on
#: its host, less one).
STAGING_GAUGES = (
    "mdtpu_stage_threads",
)


def _merge_host_snapshot(snap: dict, hid: str, host_snap: dict) -> None:
    """Fold one host's shipped snapshot into the fleet document (the
    ``unified_snapshot(fleet=)`` merge rules, docs/OBSERVABILITY.md):

    - **counters / histograms are summed** per label across hosts (the
      fixed buckets exist exactly so histograms merge) — the
      controller's own series contribute too, but the controller
      records none of the host-side job/phase series, so a fleet job
      counter IS the sum of the per-host registries;
    - **gauges are labeled** ``host="<id>"`` per host — a gauge is a
      point-in-time level, so summing would lie — while the
      controller-local gauge keeps its unlabeled key, distinct.

    A series whose type disagrees with the local one (schema drift
    across mixed versions) is skipped, never folded wrong."""
    for name, series in host_snap.items():
        if not isinstance(series, dict) or "values" not in series:
            continue
        typ = series.get("type")
        dst = snap.setdefault(name, {"type": typ, "values": {}})
        if dst["type"] != typ:
            continue
        vals = dst["values"]
        if typ == "counter":
            for k, v in series["values"].items():
                vals[k] = vals.get(k, 0) + v
        elif typ == "gauge":
            for k, v in series["values"].items():
                vals[(k + "," if k else "") + f'host="{hid}"'] = v
        elif typ == "histogram":
            for k, h in series["values"].items():
                cur = vals.get(k)
                if cur is None:
                    vals[k] = {"count": h["count"], "sum": h["sum"],
                               "buckets": dict(h["buckets"])}
                    if "exemplars" in h:
                        vals[k]["exemplars"] = dict(h["exemplars"])
                    continue
                cur["count"] += h["count"]
                cur["sum"] = round(cur["sum"] + h["sum"], 6)
                for le, c in h["buckets"].items():
                    cur["buckets"][le] = cur["buckets"].get(le, 0) + c
                if "exemplars" in h:
                    # per-bucket "last trace seen" — the host's is newer
                    cur.setdefault("exemplars", {}).update(h["exemplars"])


def unified_snapshot(timers=None, cache=None, telemetry=None,
                     registry: MetricsRegistry | None = None,
                     fleet: dict | None = None) -> dict:
    """One JSON document over the registry's live series PLUS the
    private trackers handed in:

    - ``timers`` (a :class:`~mdanalysis_mpi_tpu_torch.utils.timers.
      PhaseTimers`) → ``mdtpu_phase_seconds_total`` /
      ``mdtpu_phase_calls_total`` per phase label;
    - ``cache`` (a :class:`~mdanalysis_mpi_tpu_torch.io.base.BlockCache`) →
      hit/miss counters and byte gauges;
    - ``telemetry`` (a :class:`~mdanalysis_mpi_tpu_torch.service.telemetry.
      ServiceTelemetry`) → the job lifecycle / coalesce / admission
      counters and queue-depth gauges;
    - ``fleet`` (``{host_id: shipped snapshot}``, the fleet
      controller's per-host metric payloads) → merged on top of the
      LOCAL document per :func:`_merge_host_snapshot`: host counters
      and histograms summed, host gauges labeled ``host=``,
      controller-local series kept distinct.

    This is the ``metrics`` block bench legs embed and the schema
    ``tests/test_bench_contract.py`` pins.
    """
    snap = (registry or METRICS).snapshot()
    for name in COMPILE_METRICS + BREAKER_COUNTERS + \
            SUPERVISION_COUNTERS + RELIABILITY_COUNTERS + \
            INTEGRITY_COUNTERS + SCRUB_COUNTERS + STORE_COUNTERS + \
            STORE_REMOTE_COUNTERS + STORE_CACHE_COUNTERS + \
            FLEET_COUNTERS + FLEET_OBS_COUNTERS + QOS_COUNTERS + \
            PROF_COUNTERS + FUSED_COUNTERS + ALERT_COUNTERS + \
            ENSEMBLE_COUNTERS + STREAM_COUNTERS + USAGE_COUNTERS + \
            CANARY_COUNTERS + STAGING_COUNTERS:
        snap.setdefault(name, {"type": "counter", "values": {"": 0}})
    for name in PROF_HISTOGRAMS + CANARY_HISTOGRAMS:
        # empty series set: a histogram carries no zero point, but
        # the pinned schema needs the name/type in every snapshot
        snap.setdefault(name, {"type": "histogram", "values": {}})
    for name in BREAKER_GAUGES + LINT_GAUGES + INTEGRITY_GAUGES \
            + STORE_CACHE_GAUGES + FLEET_GAUGES + FLEET_OBS_GAUGES \
            + QOS_GAUGES + PROF_GAUGES + ALERT_GAUGES \
            + ENSEMBLE_GAUGES + STREAM_GAUGES + CANARY_GAUGES \
            + STAGING_GAUGES:
        # 0 == closed (reliability/breaker.py STATE_VALUES): a process
        # that never tripped a breaker reports the healthy state;
        # likewise 0 lint rules/findings means "never linted here"
        snap.setdefault(name, {"type": "gauge", "values": {"": 0}})
    if timers is not None:
        rep = timers.report()
        snap["mdtpu_phase_seconds_total"] = {
            "type": "counter",
            "values": {label_key({"phase": k}): v["seconds"]
                       for k, v in rep.items()}}
        snap["mdtpu_phase_calls_total"] = {
            "type": "counter",
            "values": {label_key({"phase": k}): v["calls"]
                       for k, v in rep.items()}}
    if cache is not None:
        snap["mdtpu_cache_hits_total"] = {
            "type": "counter", "values": {"": cache.hits}}
        snap["mdtpu_cache_misses_total"] = {
            "type": "counter", "values": {"": cache.misses}}
        snap["mdtpu_cache_bytes"] = {
            "type": "gauge", "values": {"": cache._bytes}}
        snap["mdtpu_cache_max_bytes"] = {
            "type": "gauge", "values": {"": cache.max_bytes}}
    if telemetry is not None:
        t = telemetry.snapshot()
        for key in _TELEMETRY_COUNTERS:
            snap[f"mdtpu_{key}_total"] = {
                "type": "counter", "values": {"": t[key]}}
        for key in _TELEMETRY_GAUGES:
            snap[f"mdtpu_{key}"] = {
                "type": "gauge", "values": {"": t[key]}}
    if fleet:
        # hosts merge LAST, over the finished local document: the
        # controller-local adapters above stay the controller's own
        for hid in sorted(fleet):
            _merge_host_snapshot(snap, hid, fleet[hid])
    return snap


def to_prometheus(snapshot: dict | None = None,
                  exemplars: bool = False) -> str:
    """Render a snapshot (default: the global registry's) as
    Prometheus text exposition.  ``exemplars=True`` opts into
    OpenMetrics exemplar syntax on histogram bucket lines
    (``... # {trace_id="..."} <value>``) — opt-in because classic
    Prometheus scrapers reject the ``#`` continuation."""
    if snapshot is None:
        snapshot = METRICS.snapshot()
    lines: list[str] = []
    for name in sorted(snapshot):
        m = snapshot[name]
        lines.append(f"# TYPE {name} {m['type']}")
        for lk, v in sorted(m["values"].items()):
            if m["type"] == "histogram":
                exm = v.get("exemplars") if exemplars else None
                for le, c in v["buckets"].items():
                    lbl = (lk + "," if lk else "") + f'le="{le}"'
                    line = f"{name}_bucket{{{lbl}}} {c}"
                    ex = exm.get(le) if exm else None
                    if ex:
                        line += (f' # {{trace_id="{ex["trace_id"]}"}}'
                                 f' {ex["value"]}')
                    lines.append(line)
                suffix = f"{{{lk}}}" if lk else ""
                lines.append(f"{name}_sum{suffix} {v['sum']}")
                lines.append(f"{name}_count{suffix} {v['count']}")
            else:
                suffix = f"{{{lk}}}" if lk else ""
                lines.append(f"{name}{suffix} {v}")
    return "\n".join(lines) + "\n"
