"""The port's twin of the scheduler cases of ``tests/test_streaming.py``
(docs/STREAMING.md): a live tenant served through the
:class:`~mdanalysis_mpi_tpu_torch.service.scheduler.Scheduler` parks
on a feed stall (never a fault or quarantine strike) and resumes, shed
rules park live tenants rather than kill them, the ``stream_envelope``
admission gate, the streaming job defaults, and the
``stream_staleness`` seed alert firing on a stall and resolving on
resume.  The stall is made by a writer that waits for the park before
it appends the rest of the feed, so it never depends on the host's
speed.
"""

import threading
import time

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch import Universe, testing
from mdanalysis_mpi_tpu_torch.analysis import RMSF
from mdanalysis_mpi_tpu_torch.io.store import LiveIngest, StoreReader
from mdanalysis_mpi_tpu_torch.service.jobs import (
    AdmissionRejectedError,
    AnalysisJob,
)
from mdanalysis_mpi_tpu_torch.service.qos import QosPolicy
from mdanalysis_mpi_tpu_torch.service.scheduler import Scheduler

N_FRAMES, CHUNK = 24, 8


def _fixture(n_frames=N_FRAMES):
    u = testing.make_protein_universe(
        n_residues=6, n_frames=n_frames, noise=0.3, seed=7)
    frames, _ = u.trajectory.read_block(0, n_frames)
    return u, frames


def _parks_total():
    from mdanalysis_mpi_tpu_torch import obs
    series = obs.METRICS.snapshot().get("mdtpu_stream_parks_total", {})
    return {k: v for k, v in series.get("values", {}).items()}


# ---------------------------------------------------------------------------
# scheduler serving: park on stall (never a fault), resume, shed->park
# ---------------------------------------------------------------------------

def test_scheduler_parks_stalled_tenant_and_resumes(tmp_path):
    u, frames = _fixture()
    store = str(tmp_path / "store")
    live = LiveIngest(out=store, n_atoms=u.atoms.n_atoms,
                      chunk_frames=CHUNK)

    parks0 = sum(_parks_total().values())

    def writer():
        for f in frames[:16]:
            live.append(f)
        # one mid-feed stall: the rest of the feed lands only once the
        # tenant has parked on it (waited for, with its own limit)
        deadline = time.monotonic() + 60.0
        while (sum(_parks_total().values()) == parks0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        for f in frames[16:]:
            live.append(f)
        live.seal()

    sr = StoreReader(store, follow=True)
    streamer = RMSF(Universe(u.topology, sr).select_atoms("name CA"))
    t = threading.Thread(target=writer)
    with Scheduler(n_workers=1, supervise=True,
                   qos=QosPolicy(stream_park_delay_s=0.1)) as sched:
        t.start()
        h = sched.submit(
            streamer, backend="serial",
            streaming={"window": CHUNK, "stall_timeout_s": 0.25,
                       "poll_interval_s": 0.01})
        # streaming jobs default their class and never coalesce
        assert h.job.qos == "streaming"
        assert h.job.coalesce is False
        res = h.result(timeout=120)
        sched.drain(timeout=60)
    t.join()
    # the stall PARKED the tenant (metric moved, reason="stall") and
    # charged NO fault -- a dry feed is not a poison strike
    parks = _parks_total()
    assert sum(parks.values()) - parks0 >= 1
    assert any("stall" in k for k in parks)
    assert h._faults == 0
    assert str(h.state) == "done"
    # ...and after resume the tenant still converged exactly
    seq = [s["frames"] for s in res.results.stream_snapshots]
    assert seq == sorted(seq) and seq[-1] == N_FRAMES
    oracle = RMSF(Universe(u.topology, StoreReader(store))
                  .select_atoms("name CA")).run(backend="serial")
    np.testing.assert_allclose(np.asarray(res.results.rmsf),
                               np.asarray(oracle.results.rmsf),
                               atol=1e-5)


class _SlowRMSF(RMSF):
    def _single_frame(self, *args, **kwargs):
        time.sleep(0.05)
        super()._single_frame(*args, **kwargs)


def test_shed_parks_streaming_tenants_instead_of_killing(tmp_path):
    """Overload shedding: a background tenant in the ladder is KILLED
    (terminal shed), a streaming tenant is PARKED — it keeps its
    handle, waits out the park delay off the queue-depth books, and
    completes once the overload clears."""
    u, frames = _fixture()
    store = str(tmp_path / "store")
    live = LiveIngest(out=store, n_atoms=u.atoms.n_atoms,
                      chunk_frames=CHUNK)
    for f in frames:
        live.append(f)
    live.seal()

    sr = StoreReader(store, follow=True)
    streamer = RMSF(Universe(u.topology, sr).select_atoms("name CA"))
    sel = u.select_atoms("name CA")
    with Scheduler(n_workers=1, supervise=True,
                   qos=QosPolicy(shed_queue_depth=1,
                                 shed_classes=("background",
                                               "streaming"),
                                 stream_park_delay_s=0.05)) as sched:
        # distinct stops -> distinct coalesce keys: each claim takes
        # ONE of these, so the queue stays deep enough that the shed
        # ladder reaches the streaming tenant after the background one
        slow = [sched.submit(_SlowRMSF(sel), backend="serial",
                             coalesce=False, tenant=f"b{i}",
                             stop=N_FRAMES - i)
                for i in range(4)]
        # overload needs every worker BUSY (a lease held): give the
        # lone worker a beat to claim before the sheddable burst
        deadline = time.monotonic() + 5.0
        while not sched._sup.leases and time.monotonic() < deadline:
            time.sleep(0.01)
        bg = sched.submit(RMSF(sel), backend="serial",
                          qos="background", coalesce=False)
        h = sched.submit(
            streamer, backend="serial",
            streaming={"window": CHUNK, "stall_timeout_s": 5.0,
                       "poll_interval_s": 0.01})
        res = h.result(timeout=120)
        sched.drain(timeout=120)
    # background: terminally shed; streaming: parked then completed
    assert str(bg.state) == "shed"
    assert str(h.state) == "done"
    assert any("shed" in k for k in _parks_total())
    assert res.results.stream_snapshots
    for s in slow:
        assert str(s.state) == "done"


def test_stream_envelope_admission_gate(tmp_path):
    u, frames = _fixture()
    store = str(tmp_path / "store")
    live = LiveIngest(out=store, n_atoms=u.atoms.n_atoms,
                      chunk_frames=CHUNK)
    for f in frames[:CHUNK]:
        live.append(f)
    live.seal()
    sr = StoreReader(store, follow=True)
    ana = RMSF(Universe(u.topology, sr).select_atoms("name CA"))
    with Scheduler(n_workers=1, autostart=False,
                   qos=QosPolicy(streaming_staged_bytes=64)) as sched:
        with pytest.raises(AdmissionRejectedError,
                           match="stream_envelope"):
            sched.submit(ana, backend="serial",
                         streaming={"window": CHUNK})


def test_streaming_job_defaults_and_explicit_qos():
    u, _ = _fixture(n_frames=4)
    job = AnalysisJob(RMSF(u.select_atoms("name CA")),
                      streaming={"window": 4}, backend="serial")
    assert job.qos == "streaming"
    assert job.coalesce is False
    # an explicit class survives the streaming default
    job2 = AnalysisJob(RMSF(u.select_atoms("name CA")),
                       streaming={"window": 4}, qos="interactive", backend="serial")
    assert job2.qos == "interactive"
    # non-streaming default is unchanged
    assert AnalysisJob(RMSF(u.select_atoms("name CA")), backend="serial").qos == "batch"


# ---------------------------------------------------------------------------
# the stream_staleness seed alert
# ---------------------------------------------------------------------------

def test_stream_staleness_alert_fires_and_resolves():
    from mdanalysis_mpi_tpu_torch.obs.alerts import AlertEngine

    now = [1000.0]
    eng = AlertEngine(clock=lambda: now[0])

    def snap(age):
        return {"mdtpu_stream_snapshot_age_seconds":
                {"type": "gauge", "values": {"": age}}}

    # injected stall: snapshot age past threshold for for_ticks=2
    assert not [t for t in eng.evaluate(snap(45.0))
                if t["rule"] == "stream_staleness"]
    now[0] += 10
    fired = [t for t in eng.evaluate(snap(55.0))
             if t["rule"] == "stream_staleness"]
    assert fired and fired[0]["state"] == "firing"
    # resume: fresh snapshots drive the age back down -> resolved
    # after the mirrored clear hysteresis
    now[0] += 10
    eng.evaluate(snap(0.5))
    now[0] += 10
    resolved = [t for t in eng.evaluate(snap(0.5))
                if t["rule"] == "stream_staleness"]
    assert resolved and resolved[0]["state"] == "resolved"


def test_stream_staleness_never_fires_idle():
    """The zero-injected "" series (no streaming tenants yet) reads 0
    — the rule's strict > threshold must stay quiet forever."""
    from mdanalysis_mpi_tpu_torch.obs.alerts import AlertEngine
    from mdanalysis_mpi_tpu_torch.obs.metrics import unified_snapshot

    now = [0.0]
    eng = AlertEngine(clock=lambda: now[0])
    for _ in range(5):
        now[0] += 10
        trans = eng.evaluate(unified_snapshot())
        assert not [t for t in trans
                    if t["rule"] == "stream_staleness"]
