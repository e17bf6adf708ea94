"""The port's twin of ``tests/test_canary.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``).

Synthetic canary probing (service/canary.py,
docs/OBSERVABILITY.md "Usage metering, exemplars & the synthetic
canary").

The canary's two contracts, each regression-pinned:

- **Black-box truth**: a probe exercises the FULL serving path (store
  read → stage → dispatch → digest vs a pinned oracle), so an injected
  kernel-site fault classifies as ``stage="kernel"``, the
  ``canary_failing`` seed alert fires with ``for_ticks`` hysteresis,
  and a recovered path resolves it.
- **Isolation**: the ``_canary`` pseudo-tenant never coalesces with
  real jobs, is exempt from every per-tenant admission check (quota,
  rate, budget), and is shed FIRST within its class — probing must
  never cost a real tenant anything.
"""

import threading
import time

import pytest


from mdanalysis_mpi_tpu_torch import obs  # noqa: E402
from mdanalysis_mpi_tpu_torch.analysis import RMSF  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs import usage  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs.alerts import AlertEngine  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from mdanalysis_mpi_tpu_torch.reliability import faults  # noqa: E402
from mdanalysis_mpi_tpu_torch.reliability.faults import (  # noqa: E402
    DeviceLossError, FaultSpec,
)
from mdanalysis_mpi_tpu_torch.service import (  # noqa: E402
    AdmissionRejectedError, JobState, QosPolicy, Scheduler,
)
from mdanalysis_mpi_tpu_torch.service.canary import (  # noqa: E402
    CANARY_QOS, CANARY_TENANT, CanaryProbe, classify_failure,
)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

pytestmark = pytest.mark.service


def _u(n_frames=12, seed=7):
    return make_protein_universe(n_residues=12, n_frames=n_frames,
                                 noise=0.25, seed=seed)


def test_classify_failure_by_stage_message():
    assert classify_failure(
        DeviceLossError("injected fault at site 'kernel'")) == "kernel"
    assert classify_failure(ValueError("chunk 3 failed crc")) == "store"
    assert classify_failure(OSError("stage buffer exhausted")) == "stage"
    assert classify_failure(RuntimeError("novel explosion")) == "run"


def test_probe_once_serial_full_real_path_ok():
    """One synchronous probe over the full path — throwaway store
    ingest, fresh Universe, scheduler submit, digest vs the pinned
    oracle — emitting the probe/latency metrics with the probe's
    trace id as the bucket exemplar."""
    before = obs.METRICS.snapshot().get(
        "mdtpu_canary_probes_total", {}).get("values", {}).get("", 0)
    sched = Scheduler(n_workers=1)
    probe = CanaryProbe(sched, interval_s=0.0, backend="serial")
    try:
        out = probe.probe_once()
        assert out["ok"] is True and out["stage"] is None
        assert out["latency_s"] > 0
        assert out["trace_id"] == "canary-1"
        assert out["consecutive_failures"] == 0
        st = probe.status()
        assert st["tenant"] == CANARY_TENANT
        assert st["probes"] == 1 and st["failures"] == 0
        assert st["outstanding"] is False
        snap = obs.METRICS.snapshot()
        assert snap["mdtpu_canary_probes_total"]["values"][""] \
            == before + 1
        assert snap["mdtpu_canary_consecutive_failures"][
            "values"][""] == 0
        lat = snap["mdtpu_canary_latency_seconds"]["values"][""]
        assert lat["count"] >= 1
        # the probe's trace id rides its latency bucket as exemplar
        assert any(e["trace_id"].startswith("canary-")
                   for e in lat["exemplars"].values())
    finally:
        sched.shutdown()
        probe.close()
    assert probe._store_dir is None          # throwaway store dropped


def test_scheduler_attaches_and_ticks_canary_on_supervisor(monkeypatch):
    """``Scheduler(canary_interval_s=...)`` builds the probe and the
    supervisor tick drives it — the production wiring, end to end on
    the torch dispatch path (here with the default device pinned to
    the CPU: the probe's own default is the card)."""
    from mdanalysis_mpi_tpu_torch import device as _device

    monkeypatch.setattr(_device, "DEFAULT_DEVICE", "cpu")
    sched = Scheduler(n_workers=1, canary_interval_s=0.05,
                      supervision_interval_s=0.02)
    try:
        assert sched.canary is not None
        assert sched.canary.backend == "torch"
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and sched.canary.probes < 1:
            time.sleep(0.05)
        assert sched.canary.probes >= 1, "supervisor never probed"
        st = sched.status()["canary"]
        assert st["probes"] >= 1
        assert st["last"] is None or st["last"]["ok"] is True
    finally:
        sched.shutdown()
    assert sched.canary._store_dir is None   # shutdown closed it


# ---------------------------------------------------------------------------
# isolation contract — pinned one property per test
# ---------------------------------------------------------------------------

def test_canary_jobs_never_coalesce():
    probe = CanaryProbe(None, backend="serial")
    try:
        j1 = probe._build_job()
        j2 = probe._build_job()
        # belt: coalesce is off on every probe job
        assert j1.coalesce is False and j2.coalesce is False
        assert j1.tenant == CANARY_TENANT and j1.qos == CANARY_QOS
        # suspenders: a FRESH Universe per probe, so the coalesce key
        # (which includes id(trajectory)) could never match another
        # job even if the flag regressed
        assert j1.analysis._ag.universe is not j2.analysis._ag.universe
        assert j1.trace_id != j2.trace_id
    finally:
        probe.close()


def test_canary_exempt_from_quota_rate_and_budget(monkeypatch):
    led = usage.UsageLedger(MetricsRegistry())
    led.enable()
    monkeypatch.setattr(usage, "LEDGER", led)
    # both tenants are far over the dispatch budget
    led.charge("greedy", "batch", dispatch_s=99.0)
    led.charge(CANARY_TENANT, CANARY_QOS, dispatch_s=99.0)
    u = _u()
    sched = Scheduler(
        autostart=False,
        qos=QosPolicy(tenant_quota=1, tenant_rate_per_s=0.5,
                      tenant_budget_dispatch_s=1.0))
    # a real tenant over budget: rejected typed (reason "budget")
    with pytest.raises(AdmissionRejectedError) as exc:
        sched.submit(RMSF(u.select_atoms("name CA")),
                     backend="serial", tenant="greedy",
                     coalesce=False)
    assert exc.value.reason == "budget"
    # the canary sails past budget AND quota (1) AND rate (0.5/s):
    # three back-to-back probe submissions, all admitted
    handles = [
        sched.submit(RMSF(u.select_atoms("name CA")),
                     backend="serial", start=i, tenant=CANARY_TENANT,
                     qos=CANARY_QOS, coalesce=False)
        for i in range(3)
    ]
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert all(h.error is None for h in handles)


class _GatedRMSF(RMSF):
    """Holds the lone worker at _prepare so the queue is genuinely
    overloaded when the shed ladder runs (same idiom as
    tests/test_qos.py)."""

    gate: threading.Event = None

    def _prepare(self):
        type(self).gate.wait(30.0)
        super()._prepare()


def test_canary_sheds_first_within_its_class():
    """Overload drops the canary BEFORE any real background tenant —
    the pseudo-tenant must never cost a real tenant a shed slot."""
    u = _u()
    _GatedRMSF.gate = threading.Event()
    sched = Scheduler(n_workers=1, autostart=False,
                      supervision_interval_s=0.02,
                      qos=QosPolicy(shed_queue_depth=2))
    gate = sched.submit(_GatedRMSF(u.select_atoms("name CA")),
                        backend="serial", qos="interactive",
                        priority=100, coalesce=False, tenant="gate")
    bg0 = sched.submit(RMSF(u.select_atoms("name CA")),
                       backend="serial", start=0, qos="background",
                       tenant="bg0", coalesce=False)
    canary = sched.submit(RMSF(u.select_atoms("name CA")),
                          backend="serial", start=1, qos=CANARY_QOS,
                          tenant=CANARY_TENANT, coalesce=False)
    bg1 = sched.submit(RMSF(u.select_atoms("name CA")),
                       backend="serial", start=2, qos="background",
                       tenant="bg1", coalesce=False)
    sched.start()
    try:
        # 3 queued behind a leased worker > depth 2 → exactly one
        # shed, and the ladder must pick the canary despite bg0
        # being older and bg1 newer
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and \
                sched.telemetry.jobs_shed < 1:
            time.sleep(0.02)
    finally:
        _GatedRMSF.gate.set()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert canary.state == JobState.SHED
    assert bg0.state == JobState.DONE
    assert bg1.state == JobState.DONE
    assert gate.error is None
    assert sched.telemetry.jobs_shed == 1


# ---------------------------------------------------------------------------
# the canary_failing alert: fire + resolve hysteresis, both ways
# ---------------------------------------------------------------------------

def test_kernel_fault_fires_canary_alert_then_resolves():
    """An injected kernel-site fault breaks the torch dispatch path the
    canary exercises: two consecutive probe failures classify as
    ``stage="kernel"`` and raise the consecutive-failures gauge to
    its threshold; the ``canary_failing`` seed rule fires only after
    ``for_ticks`` (no single-blip page) and resolves with the same
    hysteresis once probes succeed again."""
    eng = AlertEngine()
    sched = Scheduler(n_workers=1, breakers=False)
    probe = CanaryProbe(sched, interval_s=0.0, timeout_s=120.0,
                        device="cpu")
    try:
        with faults.inject(FaultSpec("kernel", "raise", times=None)):
            out1 = probe.probe_once()
            assert out1["ok"] is False and out1["stage"] == "kernel"
            out2 = probe.probe_once()
            assert out2["stage"] == "kernel"
            assert probe.consecutive_failures == 2
        snap_bad = obs.METRICS.snapshot()
        assert snap_bad["mdtpu_canary_consecutive_failures"][
            "values"][""] == 2
        failures = snap_bad["mdtpu_canary_failures_total"]["values"]
        assert failures.get('stage="kernel"', 0) >= 2
        # tick 1: breach seen, for_ticks=2 holds fire (hysteresis)
        tr1 = [t for t in eng.evaluate(snap_bad, now=1.0)
               if t["rule"] == "canary_failing"]
        assert tr1 == []
        # tick 2: sustained breach → fires
        tr2 = [t for t in eng.evaluate(snap_bad, now=2.0)
               if t["rule"] == "canary_failing"]
        assert [t["state"] for t in tr2] == ["firing"]
        assert "canary_failing" in [a["rule"] for a in eng.firing()]
        # the fault is gone: the SAME probe object recovers on the
        # SAME path, zeroing the gauge
        out3 = probe.probe_once()
        assert out3["ok"] is True
        assert probe.consecutive_failures == 0
        snap_ok = obs.METRICS.snapshot()
        resolved = []
        for t in range(3, 8):
            resolved += [tr for tr in eng.evaluate(snap_ok,
                                                   now=float(t))
                         if tr["rule"] == "canary_failing"]
        assert [t["state"] for t in resolved] == ["resolved"]
        assert "canary_failing" not in [a["rule"]
                                        for a in eng.firing()]
    finally:
        sched.shutdown()
        probe.close()
