"""The port's twin of ``tests/test_fleet.py`` (policy units and the
clean-wave process tests; the chaos cases are in
``tests/test_torch_fleet_chaos.py``), plus the port's own rules.

Translated to the port: every controller is built with
``device="cpu"`` and spawns real ``fleet-host`` processes of the port
(``python -m mdanalysis_mpi_tpu_torch fleet-host --device cpu``), whose
jobs run on their analysis' default backend (``torch``) on the CPU,
where the JAX suite's hosts run ``serial``.  Children get
``OMP_NUM_THREADS=1`` so they stay steady beside other test workers.
Every wait polls a condition, never a fixed sleep.

The port's own cases: the trace ship queue of ``obs/spans.py``; no
fallback off the card (a host or controller with the default device
raises where there is no GPU, and a CPU fleet's respawned and
autoscaled hosts inherit ``device="cpu"``); ``status`` of a fleet
workdir; the service exports.

Oracles are the JAX package's serial runs on the same seeded fixture
(the same code in both packages' ``testing``, so the same frames).
"""

import os
import sys
import time

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.service import fleet as _fleet
from mdanalysis_mpi_tpu_torch.service import journal as _journal
from mdanalysis_mpi_tpu_torch.service.fleet import DONE, FleetController
from mdanalysis_mpi_tpu_torch.service.journal import (
    JobJournal, replay_fleet,
)
from mdanalysis_mpi_tpu_torch.service.placement import (
    PlacementTable, rendezvous_score,
)

pytestmark = pytest.mark.reliability

FIXTURE = {"kind": "protein", "n_residues": 10, "n_frames": 12,
           "noise": 0.25, "seed": 5}
#: the children's environment: one intra-op thread each
ENV = {"OMP_NUM_THREADS": "1"}


def _ctrl(workdir, **kw):
    return FleetController(workdir, device="cpu", **kw)


def _wait(pred, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _spawn(ctrl, n, env=None):
    for _ in range(n):
        ctrl.spawn_host(hb_interval_s=0.1, env={**ENV, **(env or {})})
    assert ctrl.wait_hosts(n, timeout=60.0), "hosts never joined"


# ---------------------------------------------------------------------------
# policy units: placement + shard windows + journal fencing
# ---------------------------------------------------------------------------

class TestPlacement:
    def test_sticky_and_deterministic(self):
        a, b = PlacementTable(), PlacementTable()
        for h in ("h0", "h1", "h2"):
            a.add_host(h)
            b.add_host(h)
        for t in ("alice", "bob", "carol"):
            assert a.assign(t) == b.assign(t)
            assert a.assign(t) == a.assign(t)

    def test_host_loss_minimal_disruption(self):
        pt = PlacementTable()
        for h in ("h0", "h1", "h2"):
            pt.add_host(h)
        tenants = [f"t{i}" for i in range(16)]
        before = {t: pt.assign(t) for t in tenants}
        victim = before[tenants[0]]
        orphans = set(pt.remove_host(victim))
        assert orphans == {t for t, h in before.items() if h == victim}
        after = {t: pt.assign(t) for t in tenants}
        for t in tenants:
            if before[t] == victim:
                assert after[t] != victim
            else:
                assert after[t] == before[t]

    def test_degrades_to_one_then_zero(self):
        pt = PlacementTable()
        pt.add_host("h0")
        pt.add_host("h1")
        pt.remove_host("h0")
        assert all(pt.assign(f"t{i}") == "h1" for i in range(5))
        pt.remove_host("h1")
        assert pt.assign("t0") is None

    def test_breaker_gates_eligibility(self):
        from mdanalysis_mpi_tpu_torch.reliability.breaker import (
            BreakerBoard,
        )

        clock = [0.0]
        board = BreakerBoard(threshold=1, cooldown_s=10.0,
                             clock=lambda: clock[0])
        pt = PlacementTable(breakers=board)
        pt.add_host("flappy")
        pt.add_host("steady")
        board.get("flappy", mesh="fleet").record_failure()
        assert pt.eligible() == ["steady"]
        assert pt.assign("t") == "steady"
        clock[0] = 20.0
        assert "flappy" in pt.eligible()

    def test_rendezvous_score_is_process_stable(self):
        # the same constant the JAX suite pins: a fleet of either
        # package places a tenant on the same home
        assert rendezvous_score("alice", "h0") == 17446379465638477961


class TestShardWindows:
    def test_partition_of_index_sequence(self):
        from mdanalysis_mpi_tpu_torch.parallel.partition import (
            shard_windows,
        )

        wins = shard_windows(None, 2, 17, 3, 2)
        assert wins == [(2, 11, 3), (11, 17, 3)]
        frames = [f for w in wins for f in range(*w)]
        assert frames == list(range(2, 17, 3))
        assert shard_windows(4, None, None, None, 6)[-1] is None
        with pytest.raises(ValueError):
            shard_windows(None, 0, None, 1, 2)

    def test_non_unit_step_chunk_alignment(self):
        from mdanalysis_mpi_tpu_torch.parallel.partition import (
            shard_windows,
        )

        wins = shard_windows(None, 2, 37, 3, 3, chunk_frames=8)
        frames = [f for w in wins if w for f in range(*w)]
        assert frames == list(range(2, 37, 3))
        sets = [{f // 8 for f in range(*w)} for w in wins if w]
        for i in range(len(sets)):
            for j in range(i + 1, len(sets)):
                assert sets[i].isdisjoint(sets[j])
        wins = shard_windows(None, 0, 64, 20, 2, chunk_frames=8)
        assert [f for w in wins if w for f in range(*w)] \
            == [0, 20, 40, 60]
        with pytest.raises(ValueError):
            shard_windows(None, 0, 10, 0, 2)


class TestReplayFleetFencing:
    def test_stale_epoch_records_rejected(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        j1 = JobJournal(path, epoch=1)
        j1.record("epoch", None, durable=True)
        j1.record("submit", "a", tenant="t", spec={"analysis": "rmsf"})
        j1.record("assign", "a", host="h0")
        j2 = JobJournal(path, epoch=2)
        j2.record("epoch", None, durable=True)
        j2.record("finish", "a", state="done", durable=True)
        j1.record("requeue", "a", from_host="h0", reason="zombie")
        j1.record("finish", "a", state="failed", durable=True)
        j1.close()
        j2.close()
        meta = replay_fleet(path)
        assert meta["epoch"] == 2
        assert meta["stale_records"] == 2
        assert meta["jobs"]["a"]["state"] == "done"
        assert meta["finishes"] == {"a": 1}
        assert meta["jobs"]["a"]["spec"] == {"analysis": "rmsf"}
        assert _journal.replay(path)["a"]["state"] in ("done", "failed")

    def test_epochless_journal_is_epoch_zero(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        with JobJournal(path) as j:
            j.record("submit", "a", tenant="t")
            j.record("finish", "a", state="done", durable=True)
        meta = replay_fleet(path)
        assert meta["epoch"] == 0
        assert meta["stale_records"] == 0
        assert meta["jobs"]["a"]["state"] == "done"


# ---------------------------------------------------------------------------
# the trace ship queue (obs/spans.py)
# ---------------------------------------------------------------------------

class TestShipBuffer:
    @pytest.fixture(autouse=True)
    def _clean(self):
        from mdanalysis_mpi_tpu_torch.obs import spans

        spans.disable(discard=True)
        spans.reset()
        spans._STATE.ship = None
        yield spans
        spans.disable(discard=True)
        spans.reset()
        spans._STATE.ship = None

    def test_drain_without_buffer_is_empty(self, _clean):
        spans = _clean
        spans.enable(None)
        spans.span_event("x")
        assert spans.drain_ship() == ([], 0)

    def test_ship_copies_events_and_thread_meta_once(self, _clean):
        spans = _clean
        spans.enable(None)
        spans.enable_ship_buffer()
        spans.enable_ship_buffer()            # idempotent
        spans.span_event("a")
        spans.span_event("b")
        events, dropped = spans.drain_ship()
        assert dropped == 0
        metas = [e for e in events if e.get("ph") == "M"]
        assert len(metas) == 1 and metas[0]["name"] == "thread_name"
        assert [e["name"] for e in events if e.get("ph") != "M"] \
            == ["a", "b"]
        assert spans.drain_ship() == ([], 0)
        # a reconnect re-ships every known thread label
        spans.reship_thread_meta()
        again, _ = spans.drain_ship()
        assert [e["name"] for e in again] == ["thread_name"]

    def test_bound_drops_oldest_and_requeue_keeps_order(self, _clean):
        spans = _clean
        spans.enable(None)
        spans.enable_ship_buffer()
        spans._STATE.ship_max = 4
        for i in range(6):
            spans.span_event(f"e{i}")
        events, dropped = spans.drain_ship(limit=2)
        # 1 meta + 6 events through a 4-deep queue: 3 dropped, oldest
        assert dropped == 3
        assert [e["name"] for e in events] == ["e2", "e3"]
        spans.requeue_ship(events)
        rest, dropped = spans.drain_ship()
        assert dropped == 0
        assert [e["name"] for e in rest] == ["e2", "e3", "e4", "e5"]
        t0, wall0 = spans.clock_info()
        assert t0 > 0 and abs(wall0 - time.time()) < 3600


# ---------------------------------------------------------------------------
# no fallback off the card
# ---------------------------------------------------------------------------

def test_default_device_raises_without_a_gpu(tmp_path, monkeypatch):
    """A host or controller left on the default device raises where no
    CUDA device exists: neither ever serves on the CPU unasked."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _fleet._HostWorker(str(tmp_path), "h0", None, 0, 1, 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetController(str(tmp_path / "c"), status=False)
    # the host's command line defaults to the card as well
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _fleet.host_main(["--workdir", str(tmp_path), "--host-id", "h"])


def test_host_worker_builds_jobs_on_its_device(tmp_path):
    """The host hands its device, never a backend name, to the job
    builder: a job without a backend takes its analysis' default
    (``torch``) on the host's device."""
    w = _fleet._HostWorker(str(tmp_path), "h0", None, 0, 1, 0.1,
                           device="cpu")
    try:
        assert w.device == "cpu" and w.backend is None
        handle, resident = w._submit_local(
            "t|rmsf#0", {"analysis": "rmsf", "fixture": FIXTURE,
                         "tenant": "t"})
        assert resident is False
        assert handle.job.backend == "torch"
        assert handle.job.executor_kwargs == {"device": "cpu"}
        assert handle.result(timeout=60) is not None
        serial = _fleet._HostWorker(str(tmp_path), "h1", "serial", 0, 1,
                                    0.1, device="cpu")
        try:
            h2, _ = serial._submit_local(
                "t|rmsf#1", {"analysis": "rmsf", "fixture": FIXTURE,
                             "tenant": "t"})
            assert h2.job.backend == "serial"
            h2.result(timeout=60)
        finally:
            serial.sched.shutdown(wait=True)
    finally:
        w.sched.shutdown(wait=True)
        # the worker stamps its host id on this process's spans
        from mdanalysis_mpi_tpu_torch import obs

        obs.set_process_args()


def test_respawned_and_autoscaled_hosts_inherit_the_device(tmp_path,
                                                           monkeypatch):
    """A CPU fleet's replacement hosts — the respawn after a loss and
    the autoscaler's — are spawned with ``--device cpu``."""
    cmds = []

    class _Proc:
        def __init__(self, cmd, env=None):
            cmds.append(cmd)

        def poll(self):
            return None

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(_fleet.subprocess, "Popen", _Proc)
    ctrl = _ctrl(tmp_path, status=False, respawn_hosts=True,
                 autoscale=True, autoscale_spawn={"hb_interval_s": 0.1},
                 tick_s=60.0)
    try:
        ctrl.spawn_host()
        ctrl.spawn_host(device="cuda:1")        # an explicit override
        # a respawn: _lose_host on a member host spawns a replacement
        ctrl._hosts["host0"] = _fleet._Host("host0", _DeadSock(), 1e18,
                                            ctrl.epoch)
        ctrl._lose_host("host0", "test")
        # an autoscale: backlog with no capacity
        with ctrl._lock:
            ctrl._pending.extend(["a", "b"])
            ctrl._procs.clear()
        ctrl._autoscale_tick(1e6)
    finally:
        with ctrl._lock:
            ctrl._pending.clear()
            ctrl._procs.clear()
        ctrl.shutdown()
    devices = [c[c.index("--device") + 1] for c in cmds]
    assert devices == ["cpu", "cuda:1", "cpu", "cpu"], cmds
    assert all("--backend" not in c for c in cmds)
    assert all(c[1:4] == ["-m", "mdanalysis_mpi_tpu_torch", "fleet-host"]
               for c in cmds)


class _DeadSock:
    def sendall(self, data):
        raise OSError("closed")

    def close(self):
        pass


# ---------------------------------------------------------------------------
# process-level, clean waves
# ---------------------------------------------------------------------------

def _oracle_rmsf(fixture=FIXTURE, select="protein and name CA"):
    from mdanalysis_mpi_tpu.analysis import RMSF
    from mdanalysis_mpi_tpu.testing import make_protein_universe

    kwargs = {k: v for k, v in fixture.items() if k != "kind"}
    u = make_protein_universe(**kwargs)
    return RMSF(u.select_atoms(select)).run(backend="serial").results.rmsf


def test_tenant_stickiness_then_degraded_single_host(tmp_path):
    with _ctrl(tmp_path, host_ttl_s=2.0) as ctrl:
        _spawn(ctrl, 2)
        tenants = [f"t{i}" for i in range(4)]

        def wave():
            jobs = {t: ctrl.submit({"analysis": "rmsf",
                                    "fixture": FIXTURE, "tenant": t})
                    for t in tenants}
            assert ctrl.drain(timeout=120.0)
            return jobs

        w1 = wave()
        homes = {t: w1[t].host for t in tenants}
        assert len(set(homes.values())) == 2
        hits0 = ctrl.telemetry.snapshot()["home_hits"]
        w2 = wave()
        for t in tenants:
            assert w2[t].host == homes[t]
            assert w2[t].resident is True
        assert ctrl.telemetry.snapshot()["home_hits"] \
            == hits0 + len(tenants)
        victim = sorted(set(homes.values()))[0]
        assert ctrl.kill_host(victim)
        _wait(lambda: ctrl.stats()["hosts_alive"] == 1, timeout=15.0,
              msg="host loss detection")
        w3 = wave()
        survivor = next(h for h in set(homes.values()) if h != victim)
        assert all(j.state == DONE and j.host == survivor
                   for j in w3.values())
        assert ctrl.stats()["hosts_lost"] == 1
    oracle = _oracle_rmsf()
    for w in (w1, w2, w3):
        for j in w.values():
            np.testing.assert_allclose(j.result_arrays()["rmsf"], oracle,
                                       atol=1e-6)


def test_shard_guards_empty_window_and_non_series(tmp_path):
    with _ctrl(tmp_path, host_ttl_s=2.0) as ctrl:
        empty = ctrl.submit({"analysis": "rmsd", "fixture": FIXTURE,
                             "start": 5, "stop": 5, "shards": 2})
        assert empty.done() and empty.state == "failed"
        assert "empty" in empty.error
        _spawn(ctrl, 1)
        bad = ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                           "tenant": "t0", "shards": 2})
        assert ctrl.drain(timeout=120.0)
        assert bad.state == "failed"
        assert "per-frame series" in bad.error


def test_store_sharded_submit_with_stride(tmp_path):
    """A store-backed sharded job with a stride: the shard windows
    align to the store's chunks over the visited frames, and the merge
    equals the JAX package's unsharded serial run on the same store
    (the store written by the JAX package's ingest, read by the port's
    hosts)."""
    from mdanalysis_mpi_tpu import Universe
    from mdanalysis_mpi_tpu.analysis import RMSD
    from mdanalysis_mpi_tpu.io.store.ingest import ingest
    from mdanalysis_mpi_tpu.io.xtc import write_xtc
    from mdanalysis_mpi_tpu.testing import make_protein_universe

    u0 = make_protein_universe(n_residues=6, seed=3)
    rng = np.random.default_rng(9)
    frames = rng.normal(scale=3.0, size=(24, len(u0.atoms), 3)) \
        .astype(np.float32)
    xtc = os.path.join(str(tmp_path), "t.xtc")
    write_xtc(xtc, frames,
              dimensions=np.array([40.0, 40, 40, 90, 90, 90]),
              times=np.arange(24, dtype=np.float32))
    store = os.path.join(str(tmp_path), "t.store")
    ingest(xtc, store, chunk_frames=6, quant="f32")
    fixture = {"kind": "protein", "n_residues": 6, "seed": 3}
    with _ctrl(tmp_path / "ctl", host_ttl_s=2.0) as ctrl:
        _spawn(ctrl, 2)
        job = ctrl.submit({"analysis": "rmsd", "fixture": fixture,
                           "trajectory": store, "tenant": "s",
                           "shards": 3, "start": 1, "step": 2})
        assert ctrl.drain(timeout=120.0), "drain timed out"
        assert job.state == DONE, job.error
        wins = [(c.spec["start"], c.spec["stop"], c.spec["step"])
                for c in sorted(job.children,
                                key=lambda c: c.shard_index)]
    assert [f for w in wins for f in range(*w) if f < 24] \
        == list(range(1, 24, 2))
    u = Universe(u0.topology, xtc)
    solo = RMSD(u, select="protein and name CA").run(
        backend="serial", start=1, step=2)
    np.testing.assert_allclose(job.result_arrays()["rmsd"],
                               solo.results.rmsd, atol=1e-5)


def test_ensemble_counts_as_one_logical_job(tmp_path):
    from mdanalysis_mpi_tpu_torch.service.jobs import (
        AdmissionRejectedError,
    )
    from mdanalysis_mpi_tpu_torch.service.qos import QosPolicy

    with _ctrl(tmp_path, host_ttl_s=2.0,
               qos=QosPolicy(tenant_quota=1)) as ctrl:
        ens = ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                           "tenant": "a", "qos": "batch",
                           "ensemble": 3})
        assert len(ens.children) == 3
        assert all(c.spec.get("qos") == "batch" for c in ens.children)
        with pytest.raises(AdmissionRejectedError) as ei:
            ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                         "tenant": "a"})
        assert ei.value.reason == "tenant_quota"
        other = ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                             "tenant": "b"})
        assert other.state != "failed"
        assert ctrl.telemetry.snapshot()["admission_rejects"] == 1


def test_federation_counters_gauges_and_scrape(tmp_path):
    import io
    import json as _json
    import urllib.request
    from contextlib import redirect_stdout

    from mdanalysis_mpi_tpu_torch.service.statusd import status_main

    workdir = str(tmp_path / "fed")
    with _ctrl(workdir, host_ttl_s=2.0, trace=True) as ctrl:
        ctrl.spawn_host(hb_interval_s=0.1, env=ENV)
        assert ctrl.wait_hosts(1, timeout=60)
        jobs = [ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                             "tenant": f"t{i % 2}"})
                for i in range(4)]
        assert ctrl.drain(timeout=120)
        assert all(j.state == _fleet.DONE for j in jobs)

        def summed():
            snap = ctrl.fleet_snapshot()
            return sum(snap["mdtpu_jobs_completed_total"]
                       ["values"].values()), snap
        _wait(lambda: summed()[0] >= len(jobs), timeout=10,
              msg="host metrics to federate")
        total, snap = summed()
        assert total == len(jobs)
        per_host = ctrl.host_metrics()
        assert sum(
            hm["mdtpu_jobs_completed_total"]["values"][""]
            for hm in per_host.values()) == len(jobs)
        assert any(k.endswith('host="host0"')
                   for k in snap["mdtpu_queue_depth"]["values"])
        assert snap["mdtpu_hosts_alive"]["values"][""] == 1
        assert snap["mdtpu_fleet_hosts_reporting"]["values"][""] == 1

        info = _fleet._read_addr_file(workdir)
        assert info["status_port"]
        base = f"http://{info['host']}:{info['status_port']}"
        text = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=5).read().decode()
        for line in text.splitlines():
            assert line.startswith("#") or " " in line
        assert "# TYPE mdtpu_jobs_completed_total counter" in text
        assert "mdtpu_jobs_completed_total 4" in text
        status = _json.loads(urllib.request.urlopen(
            f"{base}/status", timeout=5).read())
        assert status["role"] == "fleet-controller"
        assert status["epoch"] == 1
        assert status["hosts_alive"] == 1
        assert status["hosts"]["host0"]["alive"] is True
        assert urllib.request.urlopen(f"{base}/healthz",
                                      timeout=5).status == 200

        # the one-shot CLI resolves the workdir -> status_port, through
        # the port's own command line too
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = status_main([workdir, "--json"])
        assert rc == 0
        doc = _json.loads(buf.getvalue())
        assert doc["role"] == "fleet-controller"
        assert doc["jobs_done"] == 4
        import subprocess

        out = subprocess.run(
            [sys.executable, "-m", "mdanalysis_mpi_tpu_torch", "usage",
             workdir, "--json"], capture_output=True, text=True,
            timeout=60, env={**os.environ, **ENV})
        assert out.returncode == 0, out.stderr
        assert _json.loads(out.stdout)["tenants"]
    meta = replay_fleet(os.path.join(workdir, _fleet.JOURNAL_NAME))
    assert sum(meta["finishes"].values()) == len(jobs) == total


def test_fleet_trace_merges_hosts_onto_shared_timeline(tmp_path):
    import json as _json

    workdir = str(tmp_path / "trace")
    with _ctrl(workdir, host_ttl_s=2.0, trace=True) as ctrl:
        _spawn(ctrl, 2)
        jobs = [ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                             "tenant": f"t{i}"}) for i in range(4)]
        assert ctrl.drain(timeout=120)
        assert all(j.state == _fleet.DONE for j in jobs)

        def shipped():
            # serve spans ship on heartbeat ticks, after the completions
            # that drained the fleet: wait for both hosts' rows and
            # every job's span
            evs = ctrl.host_trace_events()
            hosts = sum(1 for e in evs.values()
                        if any(ev.get("name") == "serve_job" for ev in e))
            ids = {tid for e in evs.values() for ev in e
                   if ev.get("name") == "serve_job"
                   for tid in ((ev.get("args") or {}).get("trace_ids")
                               or ())}
            return hosts >= 2 and {j.fp for j in jobs} <= ids

        _wait(shipped, timeout=20, msg="both hosts' spans to arrive")
        path = ctrl.export_fleet_trace(str(tmp_path / "fleet.json"))
    with open(path) as f:
        doc = _json.load(f)
    evs = doc["traceEvents"]
    pids = {ev["pid"] for ev in evs if ev.get("ph") != "M"}
    assert len(pids) == 2
    labels = {ev["args"]["name"] for ev in evs
              if ev.get("ph") == "M" and ev["name"] == "process_name"}
    assert "fleet-controller" in labels
    assert {"fleet-host host0", "fleet-host host1"} <= labels
    runs = [ev for ev in evs if ev.get("name") == "serve_job"]
    assert runs and all(
        ev["args"]["fleet_host"] in ("host0", "host1") for ev in runs)
    fps = {j.fp for j in jobs}
    seen = {tid for ev in runs
            for tid in (ev["args"].get("trace_ids") or ())}
    assert fps <= seen
    assert all(ev["ts"] >= 0 for ev in evs if "ts" in ev)
    assert doc["otherData"]["tool"] == "mdanalysis_mpi_tpu_torch"


def test_service_exports_the_fleet():
    from mdanalysis_mpi_tpu_torch import service

    assert service.FleetController is FleetController
    assert service.FleetJob is _fleet.FleetJob
    assert service.replay_fleet is replay_fleet
    assert {"FleetController", "FleetJob", "replay_fleet"} \
        <= set(service.__all__)
