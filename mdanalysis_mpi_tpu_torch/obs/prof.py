"""Continuous profiler: sampling stacks, dispatch latency, watermarks.

The passive obs tier answers *what happened* (spans, counters); this
module answers *where the time and memory are going right now*, cheaply
enough to leave on in a serving process (docs/OBSERVABILITY.md
"Alerting & profiling"):

- **Sampling stack profiler** — a daemon thread walks
  ``sys._current_frames()`` every ``interval_s`` (default 10 ms) and
  accumulates flamegraph-collapsed stacks (``a;b;c count`` —
  ``export_collapsed`` writes the exact format ``flamegraph.pl`` and
  speedscope ingest).  Pure observation: no sys.settrace, no
  per-call overhead on the profiled threads — the cost is the
  sampler thread's own walk (design target: under 3% of a run).
- **Per-dispatch device-latency histograms** — the executors call
  :func:`note_dispatch` around every kernel enqueue with the program
  geometry (batch size × scan group length), feeding both a bounded
  per-geometry sample window (``ms_per_dispatch`` p50/p99 in
  :func:`dispatch_stats`) and the live
  ``mdtpu_dispatch_ms{geometry=}`` histogram.  This is the §9e
  ``dispatch_count``/``ms_per_dispatch`` evidence captured
  continuously at HEAD instead of reconstructed from bench logs
  after the fact.  (A CUDA launch is an async enqueue: on the CPU the
  number is the real kernel wall; on the card it is the host's
  enqueue time and the device's drain lands in the next wait — the
  same caveat as the phase timers.)
- **Watermark sampler** — every tick the sampler reads RSS
  (``/proc/self/statm``, ``resource`` fallback) plus any registered
  sources (the scheduler registers its estimated staged bytes and
  the shared cache's occupancy), tracks peaks, mirrors the values as
  ``mdtpu_prof_rss_bytes`` / ``mdtpu_prof_rss_peak_bytes`` gauges and
  — when tracing is on — as Chrome counter events
  (``prof_watermarks``), so Perfetto draws the memory line under the
  span rows.

**Near-free when disabled** — the contract the hot paths rely on:
:func:`enabled` is one attribute read, :func:`note_dispatch` returns
immediately, and nothing samples.  Enabling never changes numerical
results (the parity gate in ``tests/test_torch_prof.py`` pins
bit-compatibility).

Stdlib only, like the rest of ``obs/``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import Counter, deque

#: Sampler period (seconds).  10 ms ≈ 100 Hz: enough resolution to
#: attribute a >100 ms phase, cheap enough for the <3% overhead target.
DEFAULT_INTERVAL_S = float(os.environ.get("MDTPU_PROF_INTERVAL", "0.01"))

#: Collapsed-stack depth cap: deeper frames are rolled into the leaf.
MAX_STACK_DEPTH = 64

#: Bounded per-geometry dispatch sample window (same rationale as
#: ``ServiceTelemetry.MAX_SAMPLES``: p50/p99 over the recent window is
#: what an operator wants, and a serving process runs indefinitely).
MAX_DISPATCH_SAMPLES = 4096

#: Fixed "le" bounds for the ``mdtpu_dispatch_ms`` histogram
#: (milliseconds) — fixed for the same reason as
#: :data:`~mdanalysis_mpi_tpu_torch.obs.metrics.TIME_BUCKETS`: merged and
#: long-lived snapshots stay comparable.
DISPATCH_MS_BUCKETS = (0.05, 0.2, 1.0, 5.0, 20.0, 100.0, 500.0,
                       2000.0, 10000.0)


class _ProfState:
    __slots__ = ("enabled", "interval_s", "thread", "stop",
                 "stacks", "n_samples", "rss_bytes", "rss_peak_bytes",
                 "sources", "marks", "dispatch", "n_dispatches")

    def __init__(self):
        self.enabled = False
        self.interval_s = DEFAULT_INTERVAL_S
        self.thread: threading.Thread | None = None
        self.stop: threading.Event | None = None
        self.stacks: Counter = Counter()
        self.n_samples = 0
        self.rss_bytes = 0
        self.rss_peak_bytes = 0
        # registered watermark sources: name -> callable() -> number
        self.sources: dict = {}
        # name -> {"value": latest, "peak": max seen}
        self.marks: dict[str, dict] = {}
        # geometry -> bounded deque of per-dispatch milliseconds
        self.dispatch: dict[str, deque] = {}
        self.n_dispatches = 0


_STATE = _ProfState()
_LOCK = threading.Lock()

_PAGE_SIZE = 4096
try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, OSError, ValueError):
    pass


def read_rss_bytes() -> int:
    """Current resident set size in bytes (``/proc/self/statm``;
    ``resource`` peak fallback off Linux; 0 when neither works)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        # ru_maxrss is the PEAK in KiB on Linux — a degraded stand-in
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


def enabled() -> bool:
    """Hot-path guard: is the profiler sampling right now?"""
    return _STATE.enabled


def maybe_enable_from_env() -> None:
    """Honor ``MDTPU_PROF=1`` (one attribute read once enabled)."""
    if _STATE.enabled:
        return
    if os.environ.get("MDTPU_PROF"):
        enable()


def enable(interval_s: float | None = None) -> None:
    """Start the sampler thread (idempotent).  Counters survive
    enable/disable cycles until :func:`reset`; the interval does NOT —
    an argument-less enable always samples at the documented default,
    whatever a previous caller asked for."""
    with _LOCK:
        if _STATE.enabled:
            return
        _STATE.interval_s = (DEFAULT_INTERVAL_S if interval_s is None
                             else float(interval_s))
        _STATE.enabled = True
        _STATE.stop = threading.Event()
        t = threading.Thread(target=_sampler, daemon=True,
                             name="mdtpu-prof")
        _STATE.thread = t
        t.start()


def disable() -> None:
    """Stop sampling.  Collected stacks/watermarks/dispatch samples
    stay readable until :func:`reset`."""
    with _LOCK:
        if not _STATE.enabled:
            return
        _STATE.enabled = False
        stop, thread = _STATE.stop, _STATE.thread
        _STATE.stop = None
        _STATE.thread = None
    if stop is not None:
        stop.set()
    if thread is not None:
        thread.join(timeout=2.0)


def reset() -> None:
    """Drop every collected sample (tests; rotating a long profile)."""
    with _LOCK:
        _STATE.stacks.clear()
        _STATE.n_samples = 0
        _STATE.rss_bytes = 0
        _STATE.rss_peak_bytes = 0
        _STATE.marks.clear()
        _STATE.dispatch.clear()
        _STATE.n_dispatches = 0


def register_watermark(name: str, fn) -> None:
    """Register a watermark source the sampler polls every tick
    (e.g. the scheduler's estimated staged bytes, a cache's resident
    bytes).  Last registration wins per name; sources must be cheap
    and must not raise (a raising source is dropped, disclosed via
    ``mdtpu_obs_write_errors_total{sink="prof"}``)."""
    with _LOCK:
        _STATE.sources[name] = fn


def unregister_watermark(name: str, fn=None) -> None:
    """Remove a source.  With ``fn``, remove only if ``name`` still
    maps to THAT callable — so a shut-down owner cannot yank a name a
    later registrant (another scheduler) took over."""
    with _LOCK:
        if fn is None or _STATE.sources.get(name) is fn:
            _STATE.sources.pop(name, None)


def _collapse(frame) -> str:
    """One thread's stack as a flamegraph-collapsed line: root-first
    ``module:func`` joined by ``;``."""
    parts: list[str] = []
    depth = 0
    while frame is not None and depth < MAX_STACK_DEPTH:
        code = frame.f_code
        mod = os.path.splitext(os.path.basename(code.co_filename))[0]
        parts.append(f"{mod}:{code.co_name}")
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return ";".join(parts)


def _sampler() -> None:
    from mdanalysis_mpi_tpu_torch.obs import spans as _spans
    from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS

    stop = _STATE.stop
    own = threading.get_ident()
    while stop is not None and not stop.wait(_STATE.interval_s):
        # ---- stacks ----
        try:
            frames = sys._current_frames()
        except Exception:       # interpreter teardown
            return
        counts: list[str] = []
        for tid, frame in frames.items():
            if tid == own:
                continue
            counts.append(_collapse(frame))
        # ---- watermarks ----
        rss = read_rss_bytes()
        with _LOCK:
            for stack in counts:
                _STATE.stacks[stack] += 1
            _STATE.n_samples += 1
            _STATE.rss_bytes = rss
            _STATE.rss_peak_bytes = max(_STATE.rss_peak_bytes, rss)
            sources = list(_STATE.sources.items())
        mark_vals = {}
        for name, fn in sources:
            try:
                v = float(fn())
            except Exception:
                # a broken source must not kill the sampler; disclose
                # and drop it so it cannot spam the counter every tick
                METRICS.inc("mdtpu_obs_write_errors_total", sink="prof")
                unregister_watermark(name, fn)
                continue
            mark_vals[name] = v
        with _LOCK:
            for name, v in mark_vals.items():
                m = _STATE.marks.setdefault(name,
                                            {"value": 0.0, "peak": 0.0})
                m["value"] = v
                m["peak"] = max(m["peak"], v)
        METRICS.inc("mdtpu_prof_samples_total")
        METRICS.set_gauge("mdtpu_prof_rss_bytes", rss)
        METRICS.set_gauge("mdtpu_prof_rss_peak_bytes",
                          _STATE.rss_peak_bytes)
        if _spans.enabled():
            # Chrome counter event: Perfetto draws these as a stacked
            # area row under the span rows (ph "C")
            _spans.counter_event(
                "prof_watermarks", rss_mb=round(rss / 2**20, 2),
                **{k: round(v, 2) for k, v in mark_vals.items()})


def note_dispatch(ms: float, geometry: str,
                  engine: str = "generic") -> None:
    """Record one kernel dispatch of ``ms`` milliseconds under its
    program ``geometry`` (e.g. ``bs256_scan4``) and ``engine``
    (``generic`` for the stock dequant+align program, ``fused`` when a
    quantized-native fused program — the ``csrc/fused_rmsf.cu`` kernel
    on the card or its plain version on the CPU — owned the
    dispatch).  Generic dispatches key the sample
    window by bare geometry (stable dashboard keys); fused ones key by
    ``geometry/engine`` so the two programs' latency distributions
    never mix.  No-op when the profiler is disabled — the executors'
    hot path relies on that."""
    if not _STATE.enabled:
        return
    from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS

    key = geometry if engine == "generic" else f"{geometry}/{engine}"
    with _LOCK:
        dq = _STATE.dispatch.get(key)
        if dq is None:
            dq = deque(maxlen=MAX_DISPATCH_SAMPLES)
            _STATE.dispatch[key] = dq
        dq.append(float(ms))
        _STATE.n_dispatches += 1
    METRICS.observe("mdtpu_dispatch_ms", float(ms),
                    buckets=DISPATCH_MS_BUCKETS, geometry=geometry,
                    engine=engine)


def _percentile(samples: list, q: float) -> float | None:
    """Nearest-rank percentile, numpy-free (obs stays stdlib-only)."""
    if not samples:
        return None
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return round(s[idx], 4)


def dispatch_stats() -> dict:
    """``{geometry: {count, p50_ms, p99_ms, max_ms}}`` over the
    bounded per-geometry sample windows."""
    with _LOCK:
        samples = {g: list(dq) for g, dq in _STATE.dispatch.items()}
    return {
        g: {"count": len(s),
            "p50_ms": _percentile(s, 50),
            "p99_ms": _percentile(s, 99),
            "max_ms": round(max(s), 4) if s else None}
        for g, s in sorted(samples.items())}


def collapsed(limit: int | None = None) -> dict:
    """Flamegraph-collapsed stacks → sample counts, hottest first."""
    with _LOCK:
        items = _STATE.stacks.most_common(limit)
    return dict(items)


def export_collapsed(path: str) -> str | None:
    """Write the collapsed stacks in ``flamegraph.pl`` input format
    (``stack count`` per line).  Returns the path, or None on a
    disclosed write failure (never raises into the caller)."""
    lines = [f"{stack} {count}" for stack, count
             in collapsed().items()]
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        os.replace(tmp, path)
    except OSError:
        from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS

        METRICS.inc("mdtpu_obs_write_errors_total", sink="prof")
        return None
    return path


def watermark_block() -> dict:
    """The JSON block the flight recorder embeds in every dump: the
    sampler's RSS/watermark peaks when it ran, a one-shot RSS read
    when it did not (an incident black box should always carry the
    memory picture, profiler or no profiler)."""
    with _LOCK:
        n = _STATE.n_samples
        block = {
            "enabled": _STATE.enabled,
            "n_samples": n,
            "rss_bytes": _STATE.rss_bytes,
            "rss_peak_bytes": _STATE.rss_peak_bytes,
            "watermarks": {k: dict(v)
                           for k, v in sorted(_STATE.marks.items())},
        }
    if not n:
        rss = read_rss_bytes()
        block["rss_bytes"] = rss
        block["rss_peak_bytes"] = max(block["rss_peak_bytes"], rss)
    return block


def report(top: int = 20) -> dict:
    """One JSON-friendly profiler summary: sampling state, hottest
    collapsed stacks, per-geometry dispatch latency, watermarks —
    what the run report and the bench prof leg embed."""
    with _LOCK:
        interval = _STATE.interval_s
        n_dispatches = _STATE.n_dispatches
    out = {
        "interval_s": interval,
        "n_dispatches": n_dispatches,
        "stacks": collapsed(top),
        "dispatch_ms": dispatch_stats(),
    }
    out.update(watermark_block())
    return out


def run_summary() -> dict:
    """The compact block ``results.observability`` carries when the
    profiler is on (process-level: the sampler does not segment by
    run — the per-run phase window already does that)."""
    block = watermark_block()
    return {
        "n_samples": block["n_samples"],
        "rss_peak_bytes": block["rss_peak_bytes"],
        "watermarks": block["watermarks"],
        "dispatch_ms": dispatch_stats(),
    }
