"""Synthetic canary: active end-to-end probing of the serving path.

Everything below the obs tier is *passive* — it can only infer health
from tenant traffic, so a fleet serving zero requests looks identical
to a fleet that would fail every request.  The canary closes that gap
with a reserved **background-class pseudo-tenant**
(:data:`CANARY_TENANT`) the scheduler — and each fleet host's local
scheduler — runs on the supervisor tick: a tiny fixed-shape job that
exercises the FULL real path (store read → stage → dispatch → result
digest vs a pinned oracle), never a mocked shortcut, emitting
black-box SLIs:

- ``mdtpu_canary_probes_total`` / ``mdtpu_canary_failures_total``
  (labeled ``stage=`` — submit / store / stage / put / kernel /
  oracle / timeout / run, classified from the failure's message: the
  fault injector stamps its site name into every injected error);
- ``mdtpu_canary_latency_seconds`` — full submit→digest latency, with
  the probe's trace id as the bucket exemplar;
- ``mdtpu_canary_consecutive_failures`` — the gauge the
  ``canary_failing`` seed alert (obs/alerts.py) watches, giving
  fire/resolve hysteresis both ways on the rules engine's
  ``for_ticks``.

Probe state machine (docs/OBSERVABILITY.md): ``idle`` —interval
elapsed→ ``outstanding`` (one probe in flight, never more) —handle
done→ settle (ok / failed by stage) → ``idle``; an outstanding probe
past ``timeout_s`` settles as ``stage="timeout"`` and a late
completion of an abandoned handle is ignored.  Isolation contract
(regression-pinned): canary jobs never coalesce with real tenants'
jobs (``coalesce=False`` + a fresh Universe per probe), are exempt
from tenant quota / rate limit / budget admission, and are FIRST in
the shed ladder — the canary must never cost a real tenant anything.

Setup (lazy, on the first probe): a tiny deterministic protein
universe is ingested once into a throwaway block store; the oracle is
the serial direct-run result over that same store, pinned with a
sha256 digest.  The probe runs on the ``"torch"`` backend by default,
on ``cuda`` unless ``device=`` names another device: on the card it
goes through the real dispatch path and the ``kernel`` fault site.
"""

from __future__ import annotations

import hashlib
import shutil
import tempfile
import threading
import time

from mdanalysis_mpi_tpu_torch import obs

#: The reserved pseudo-tenant every canary job runs as.  The leading
#: underscore keeps it out of any real tenant namespace; admission and
#: the shed ladder special-case it by name.
CANARY_TENANT = "_canary"

#: Canary jobs ride the lowest QoS class — probe traffic must lose
#: every scheduling race against real tenants.
CANARY_QOS = "background"

#: Failure stages, in classification order (first message match wins).
#: ``reliability/faults.py`` stamps the site name into every injected
#: error message, so an injected ``kernel``-site fault classifies as
#: ``kernel`` without any plumbing.
_STAGES = ("kernel", "stage", "store", "chunk", "put")
_STAGE_ALIASES = {"chunk": "store"}


def classify_failure(exc: BaseException) -> str:
    """Map a probe failure to its serving stage by message scan
    (``run`` when nothing matches)."""
    msg = f"{type(exc).__name__}: {exc}".lower()
    for needle in _STAGES:
        if needle in msg:
            return _STAGE_ALIASES.get(needle, needle)
    return "run"


class CanaryProbe:
    """One canary per scheduler: build once, attach via
    ``Scheduler(canary=...)`` (or ``canary_interval_s=``), ticked by
    the supervisor; :meth:`probe_once` runs one synchronous probe for
    tests and the bench."""

    def __init__(self, scheduler, interval_s: float = 30.0,
                 timeout_s: float = 60.0, n_residues: int = 8,
                 n_frames: int = 8, batch_size: int = 4,
                 backend: str = "torch", device=None,
                 clock=time.monotonic):
        self.scheduler = scheduler
        #: probe backend — "torch" exercises the real dispatch path
        #: (and the `kernel` fault site); "serial" keeps a probe on
        #: the host
        self.backend = str(backend)
        #: the probe's device (None: the backend's default, ``cuda``)
        self.device = device
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.n_residues = int(n_residues)
        self.n_frames = int(n_frames)
        self.batch_size = int(batch_size)
        self._clock = clock
        self._lock = threading.Lock()
        self._store_dir: str | None = None
        self._topology = None
        self._oracle = None
        self._oracle_digest: str | None = None
        self._outstanding = None          # (handle, t_submit, trace_id)
        self._last_launch = float("-inf")
        self._seq = 0
        self.probes = 0
        self.failures = 0
        self.consecutive_failures = 0
        self.last: dict | None = None

    # ---- fixture + oracle (lazy, once) ----

    def _setup(self):
        """Ingest the canary fixture into a throwaway store and pin
        the serial oracle over that SAME store (quantization included,
        so the comparison is store-exact, not fixture-approximate)."""
        import numpy as np

        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.store.ingest import ingest
        from mdanalysis_mpi_tpu_torch.io.store.reader import StoreReader
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=self.n_residues,
                                  n_frames=self.n_frames,
                                  noise=0.2, seed=20)
        out = tempfile.mkdtemp(prefix="mdtpu-canary-")
        ingest(u.trajectory, out=out)
        self._topology = u.topology
        oracle_u = Universe(self._topology, StoreReader(out))
        ana = self._analysis(oracle_u)
        ana.run(backend="serial")
        self._oracle = np.asarray(ana.results.rmsf, dtype=np.float64)
        self._oracle_digest = self._digest(self._oracle)
        self._store_dir = out

    def _analysis(self, universe):
        from mdanalysis_mpi_tpu_torch.analysis import RMSF
        return RMSF(universe.select_atoms("name CA"))

    @staticmethod
    def _digest(arr) -> str:
        import numpy as np
        return hashlib.sha256(
            np.round(np.asarray(arr, dtype=np.float64), 5)
            .tobytes()).hexdigest()[:16]

    def _build_job(self):
        """A fresh Universe + StoreReader per probe: the coalesce key
        includes ``id(trajectory)``, so a canary pass can never share
        a physical pass with ANY other job — belt (``coalesce=False``)
        and suspenders (fresh reader)."""
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.store.reader import StoreReader
        from mdanalysis_mpi_tpu_torch.service.jobs import AnalysisJob

        if self._store_dir is None:
            self._setup()
        u = Universe(self._topology, StoreReader(self._store_dir))
        self._seq += 1
        kwargs = ({} if self.device is None or self.backend == "serial"
                  else {"device": self.device})
        return AnalysisJob(
            self._analysis(u), backend=self.backend,
            batch_size=self.batch_size, executor_kwargs=kwargs,
            qos=CANARY_QOS,
            tenant=CANARY_TENANT, coalesce=False,
            trace_id=f"canary-{self._seq}")

    # ---- probe lifecycle ----

    def tick(self, now: float | None = None) -> None:
        """Non-blocking supervisor hook: settle a finished or timed
        out outstanding probe, launch a new one when the interval
        elapsed.  At most one probe is ever in flight."""
        now = self._clock() if now is None else now
        with self._lock:
            out = self._outstanding
            if out is not None:
                handle, t0, tid = out
                if handle.done():
                    self._outstanding = None
                else:
                    if now - t0 <= self.timeout_s:
                        return            # still cooking
                    # abandoned: a late completion settles nowhere
                    self._outstanding = None
                    self._note_locked(ok=False, stage="timeout",
                                      latency_s=now - t0, trace_id=tid)
                    return
            else:
                handle = None
            if handle is None and now - self._last_launch \
                    < self.interval_s:
                return
        if handle is not None:
            self._settle(handle, t0, tid)
            return
        self._launch(now)

    def probe_once(self, wait_s: float | None = None) -> dict:
        """One synchronous probe (tests / the bench): launch, wait,
        settle; returns the outcome record."""
        now = self._clock()
        launched = self._launch(now)
        if launched is None:
            return self.last
        handle, t0, tid = launched
        handle.wait(self.timeout_s if wait_s is None else wait_s)
        with self._lock:
            if self._outstanding is not None \
                    and self._outstanding[0] is handle:
                self._outstanding = None
            else:
                # a concurrent supervisor tick already settled it
                return self.last
        if not handle.done():
            with self._lock:
                self._note_locked(ok=False, stage="timeout",
                                  latency_s=self._clock() - t0,
                                  trace_id=tid)
            return self.last
        self._settle(handle, t0, tid)
        return self.last

    def _launch(self, now: float):
        """Build + submit one probe job; a failure to even submit IS a
        probe outcome (stage ``submit`` / ``store``)."""
        with self._lock:
            self._last_launch = now
        try:
            job = self._build_job()
            handle = self.scheduler.submit(job)
        except Exception as exc:
            stage = classify_failure(exc)
            with self._lock:
                self._note_locked(
                    ok=False,
                    stage=stage if stage != "run" else "submit",
                    latency_s=0.0, trace_id=f"canary-{self._seq}")
            return None
        with self._lock:
            self._outstanding = (handle, now, job.trace_id)
        return self._outstanding

    def _settle(self, handle, t0: float, trace_id: str) -> None:
        """Classify a finished probe: terminal state, then the result
        digest vs the pinned oracle."""
        import numpy as np

        latency = max(0.0, self._clock() - t0)
        ok, stage, digest = False, None, None
        if handle.error is not None:
            stage = classify_failure(handle.error)
        elif handle.state != "done":
            stage = "run"
        else:
            res = np.asarray(handle.result().results.rmsf,
                             dtype=np.float64)
            digest = self._digest(res)
            if res.shape == self._oracle.shape \
                    and np.allclose(res, self._oracle, atol=1e-3):
                ok = True
            else:
                stage = "oracle"
        with self._lock:
            self._note_locked(ok=ok, stage=stage, latency_s=latency,
                              trace_id=trace_id, digest=digest)

    def _note_locked(self, ok: bool, stage: str | None,
                     latency_s: float, trace_id: str,
                     digest: str | None = None) -> None:
        # `_locked` suffix: the caller holds self._lock (MDT001)
        self.probes += 1
        if ok:
            self.consecutive_failures = 0
        else:
            self.failures += 1
            self.consecutive_failures += 1
            obs.METRICS.inc("mdtpu_canary_failures_total", stage=stage)
        self.last = {
            "ok": ok, "stage": stage,
            "latency_s": round(latency_s, 6), "trace_id": trace_id,
            "digest": digest, "oracle_digest": self._oracle_digest,
            "consecutive_failures": self.consecutive_failures,
        }
        obs.METRICS.inc("mdtpu_canary_probes_total")
        obs.METRICS.set_gauge("mdtpu_canary_consecutive_failures",
                              self.consecutive_failures)
        # the probe's trace id rides the latency bucket as its
        # exemplar — a slow canary links straight to its trace
        with obs.trace_context(trace_id=trace_id):
            obs.METRICS.observe("mdtpu_canary_latency_seconds",
                                latency_s)
        obs.span_event("canary_probe", ok=ok, stage=stage,
                       latency_ms=round(latency_s * 1e3, 3),
                       trace_id=trace_id)

    # ---- reporting / teardown ----

    def status(self) -> dict:
        with self._lock:
            return {
                "tenant": CANARY_TENANT,
                "interval_s": self.interval_s,
                "probes": self.probes,
                "failures": self.failures,
                "consecutive_failures": self.consecutive_failures,
                "outstanding": self._outstanding is not None,
                "last": dict(self.last) if self.last else None,
            }

    def close(self) -> None:
        """Drop the throwaway store (idempotent)."""
        d, self._store_dir = self._store_dir, None
        if d:
            shutil.rmtree(d, ignore_errors=True)
        self._topology = None
