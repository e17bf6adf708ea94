"""Backend circuit breakers: stop dispatching into a failing backend.

The :class:`~mdanalysis_mpi_tpu_torch.reliability.policy.FallbackChain`
degrades ONE run when its backend fails — but every subsequent job
still pays the full retry/backoff/degrade cost against the same dead
backend, because nothing remembers the failure across runs.  A serving
scheduler dispatching thousands of jobs against a lost device would
burn its whole latency budget rediscovering the outage per job.  The
breaker is the cross-job memory:

- **closed** (healthy): traffic flows; every degradable kernel/dispatch
  fault counts toward ``threshold`` consecutive failures, any success
  resets the count.
- **open** (tripped): after ``threshold`` consecutive faults.  New
  claims are routed DOWN the same Mesh → Jax → Serial order the
  FallbackChain uses (the scheduler consults :meth:`BreakerBoard.get`
  before executing a unit) — no dispatch is attempted against the
  tripped backend, so the failure is paid once, not per job.
- **half-open**: after ``cooldown_s``, the next claim may
  :meth:`~CircuitBreaker.probe` the backend with a warmup-shaped no-op
  dispatch (cheap, shape-stable, no tenant data at risk).  Probe
  success closes the breaker and restores traffic; failure re-opens it
  for another cooldown.

Every transition is mirrored into observability: the
``mdtpu_breaker_state`` gauge (0 closed / 1 half-open / 2 open, labeled
by backend), the ``mdtpu_breaker_transitions_total`` counter, and a
``breaker_transition`` trace instant event — so a Perfetto timeline
shows exactly when a backend was taken out of rotation
(docs/RELIABILITY.md, "Serving supervision").

Breakers are keyed ``(backend, mesh)`` — one mesh's device loss must
not blacklist the same backend on a healthy mesh.  The scheduler owns
one :class:`BreakerBoard` per instance (tests stay isolated); a
deployment sharing executors across schedulers can hand the same board
to each.
"""

from __future__ import annotations

import threading
import time

#: State names (JSON/metric-friendly strings, no enum dependency) and
#: the pinned gauge encoding.
CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"
STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """One backend's trip/cooldown/probe state machine.

    ``threshold``
        Consecutive degradable faults that trip closed → open.
    ``cooldown_s``
        Seconds the breaker stays open before offering half-open
        probes.
    ``clock``
        Injected monotonic clock (tests pin transitions without
        sleeping).
    """

    def __init__(self, key, threshold: int = 3, cooldown_s: float = 5.0,
                 clock=time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.key = key
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_t = 0.0
        self.trips = 0          # closed→open transitions (telemetry)
        self.probes = 0         # half-open probes attempted

    # ---- transitions (all under self._lock) ----

    def _transition_locked(self, to: str) -> None:
        frm = self._state
        if frm == to:
            return
        self._state = to
        if to == OPEN:
            self._opened_t = self._clock()
        self._announce(frm, to)

    def _announce(self, frm: str, to: str) -> None:
        from mdanalysis_mpi_tpu_torch.obs import METRICS, span_event
        from mdanalysis_mpi_tpu_torch.utils.log import get_logger

        backend = self.key[0] if isinstance(self.key, tuple) else self.key
        METRICS.set_gauge("mdtpu_breaker_state", STATE_VALUES[to],
                          backend=str(backend))
        METRICS.inc("mdtpu_breaker_transitions_total",
                    backend=str(backend), to=to)
        span_event("breaker_transition", backend=str(backend),
                   from_state=frm, to_state=to)
        get_logger("mdtpu.reliability").warning(
            "circuit breaker %r: %s -> %s", self.key, frm, to)

    # ---- recording ----

    def record_failure(self) -> None:
        """One degradable kernel/dispatch fault against this backend.
        A half-open breaker re-opens immediately (the probe — or the
        job that rode it — failed); a closed one trips at
        ``threshold`` consecutive faults."""
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN:
                self._transition_locked(OPEN)
            elif (self._state == CLOSED
                    and self._consecutive >= self.threshold):
                self.trips += 1
                self._transition_locked(OPEN)

    def record_success(self) -> None:
        """A real dispatch (or probe) succeeded: reset to closed."""
        with self._lock:
            self._consecutive = 0
            self._transition_locked(CLOSED)

    # ---- reading / probing ----

    @property
    def state(self) -> str:
        """Current state; an open breaker past its cooldown reads (and
        becomes) half-open."""
        with self._lock:
            if (self._state == OPEN
                    and self._clock() - self._opened_t >= self.cooldown_s):
                self._transition_locked(HALF_OPEN)
            return self._state

    def allow(self) -> bool:
        """May a claim dispatch against this backend right now?
        Closed and half-open say yes (half-open callers should
        :meth:`probe` first); open says no."""
        return self.state != OPEN

    def probe(self, fn) -> bool:
        """Run the warmup-shaped no-op ``fn`` while half-open: success
        closes the breaker (True), failure — any exception — re-opens
        it (False).  On a closed breaker the probe is skipped (True);
        on an open one it is refused (False)."""
        st = self.state
        if st == CLOSED:
            return True
        if st == OPEN:
            return False
        with self._lock:
            self.probes += 1
        try:
            fn()
        except BaseException as exc:
            self.record_failure()
            if not isinstance(exc, Exception):
                # BaseException-based control flow (worker fencing:
                # WorkerFenced, InjectedWorkerDeath, KeyboardInterrupt)
                # must keep unwinding the thread — the probe records
                # the failed attempt but never swallows the fence
                # (`mdtpu lint` MDT003; regression in
                # tests/test_supervision.py)
                raise
            return False
        self.record_success()
        return True


class BreakerBoard:
    """Lazy registry of breakers keyed ``(backend, mesh)``.

    ``mesh`` defaults to None (the single-process mesh); multi-host
    controllers pass their mesh/coordinator id so one pod's outage
    never trips another's breaker.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 clock=time.monotonic):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: dict = {}

    def get(self, backend: str, mesh=None) -> CircuitBreaker:
        key = (backend, mesh)
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(key, threshold=self.threshold,
                                    cooldown_s=self.cooldown_s,
                                    clock=self._clock)
                self._breakers[key] = br
            return br

    def states(self) -> dict:
        """{(backend, mesh): state} snapshot (CLI/JSON reporting)."""
        with self._lock:
            breakers = list(self._breakers.items())
        return {key: br.state for key, br in breakers}
