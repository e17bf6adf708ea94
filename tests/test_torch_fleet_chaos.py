"""The port's twin of the chaos cases of ``tests/test_fleet.py``
(docs/RELIABILITY.md §6): real port host processes on the CPU
(``device="cpu"``, ``OMP_NUM_THREADS=1``) under a real controller —

- host ``kill -9`` mid-wave → migration onto the survivor with
  journal-level exactly-once, usage reconciled against the journal,
  and per-tenant parity with the JAX package's serial oracle
  (including a trajectory-sharded job's frame-axis merge);
- host kill plus controller wedge → standby adoption, the zombie's
  late command fenced by the host and its late appends by replay;
- a partitioned host's late completion fenced by its token;
- an ensemble with the store-first ingest pre-stage, one host
  ``kill -9``'d while the members run: merge parity and dedup.

Every wait polls a condition; the only sleep is the failover case's
0.2 s that puts the wedge inside the wave, as in the JAX suite.
"""

import os
import time

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.service import fleet as _fleet
from mdanalysis_mpi_tpu_torch.service.fleet import DONE, FleetController
from mdanalysis_mpi_tpu_torch.service.journal import replay_fleet

pytestmark = pytest.mark.reliability

FIXTURE = {"kind": "protein", "n_residues": 10, "n_frames": 12,
           "noise": 0.25, "seed": 5}
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


def _journal_exactly_once(workdir, fps):
    meta = replay_fleet(os.path.join(str(workdir), _fleet.JOURNAL_NAME))
    for fp in fps:
        assert meta["finishes"].get(fp) == 1, \
            (fp, meta["finishes"].get(fp))
    return meta


def _oracle_rmsf(fixture=FIXTURE, select="protein and name CA"):
    from mdanalysis_mpi_tpu.analysis import RMSF
    from mdanalysis_mpi_tpu.testing import make_protein_universe

    kwargs = {k: v for k, v in fixture.items() if k != "kind"}
    u = make_protein_universe(**kwargs)
    return RMSF(u.select_atoms(select)).run(backend="serial").results.rmsf


def test_host_kill9_migration_exactly_once_parity(tmp_path):
    from mdanalysis_mpi_tpu_torch.obs import unified_snapshot

    usage_base = unified_snapshot()
    with _ctrl(tmp_path, host_ttl_s=2.0) as ctrl:
        _spawn(ctrl, 2, env={"MDTPU_FLEET_RUN_DELAY": "0.3"})
        jobs = [ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                             "tenant": f"t{i % 3}"})
                for i in range(6)]
        sharded = ctrl.submit({"analysis": "rmsd", "fixture": FIXTURE,
                               "tenant": "t0", "shards": 2})
        victim = ctrl.placement.home_of("t0")
        assert victim is not None
        assert ctrl.kill_host(victim)
        assert ctrl.drain(timeout=120.0), "drain timed out"
        stats = ctrl.stats()
        assert stats["hosts_lost"] == 1
        assert stats["jobs_migrated"] >= 1
        assert stats["hosts_alive"] == 1
        assert all(j.state == DONE for j in jobs)
        assert sharded.state == DONE
        child_fps = [c.fp for c in sharded.children]
        rec = ctrl.usage_reconcile(baseline=usage_base)
        assert rec["ok"] is True, rec["diff"]
        assert sum(rec["journal"].values()) == len(jobs) + len(child_fps)
        assert rec["usage"] == rec["journal"]
        for i in range(3):
            assert rec["usage"].get(f"t{i}/done", 0) >= 1
    _journal_exactly_once(tmp_path, [j.fp for j in jobs] + child_fps)
    oracle = _oracle_rmsf()
    for j in jobs:
        np.testing.assert_allclose(j.result_arrays()["rmsf"], oracle,
                                   atol=1e-6)
    from mdanalysis_mpi_tpu.analysis import RMSD
    from mdanalysis_mpi_tpu.testing import make_protein_universe

    u = make_protein_universe(
        **{k: v for k, v in FIXTURE.items() if k != "kind"})
    solo = RMSD(u, select="protein and name CA").run(backend="serial")
    np.testing.assert_allclose(sharded.result_arrays()["rmsd"],
                               solo.results.rmsd, atol=1e-6)


def test_acceptance_host_kill_plus_controller_failover(tmp_path):
    zombie = _ctrl(tmp_path, host_ttl_s=2.0)
    standby = None
    try:
        _spawn(zombie, 2, env={"MDTPU_FLEET_RUN_DELAY": "0.4"})
        fps = [zombie.submit({"analysis": "rmsf", "fixture": FIXTURE,
                              "tenant": f"t{i % 4}"}).fp
               for i in range(8)]
        victim = zombie.placement.home_of("t0")
        survivor = next(h for h in zombie.placement.hosts()
                        if h != victim)
        assert zombie.kill_host(victim)
        time.sleep(0.2)          # the wave is genuinely mid-flight
        zombie.wedge()
        standby = FleetController.adopt(tmp_path, host_ttl_s=2.0,
                                        device="cpu")
        assert standby.epoch == zombie.epoch + 1
        assert standby.device == "cpu"
        assert standby.wait_hosts(1, timeout=30.0)
        assert standby.drain(timeout=120.0), "standby drain timed out"
        jobs = standby.jobs()
        done = [jobs[fp] for fp in fps if fp in jobs
                and jobs[fp].state == DONE]
        meta = _journal_exactly_once(tmp_path, fps)
        assert all(meta["jobs"][fp]["state"] == "done" for fp in fps)
        assert zombie.zombie_send(survivor)
        _wait(lambda: standby.telemetry.snapshot()
              ["epoch_fenced_rejects"] >= 1, timeout=15.0,
              msg="host fence notice")
        zombie.journal.record("requeue", fps[0], from_host="nowhere",
                              reason="zombie_wakeup")
        zombie.journal.record("finish", fps[0], state="failed",
                              durable=True)
        meta = replay_fleet(
            os.path.join(str(tmp_path), _fleet.JOURNAL_NAME))
        assert meta["stale_records"] >= 2
        assert meta["epoch"] == standby.epoch
        assert meta["jobs"][fps[0]]["state"] == "done"
        assert meta["finishes"][fps[0]] == 1
        oracle = _oracle_rmsf()
        assert done, "standby finished no jobs — failover did nothing"
        for job in done:
            np.testing.assert_allclose(job.result_arrays()["rmsf"],
                                       oracle, atol=1e-6)
    finally:
        if standby is not None:
            standby.shutdown()
        zombie.shutdown()


def test_partitioned_host_late_completion_fenced(tmp_path):
    env = {"MDTPU_FLEET_RUN_DELAY": "0.2",
           "MDTPU_FLEET_HB_PAUSE": "p|:3.0"}
    with _ctrl(tmp_path, host_ttl_s=1.0) as ctrl:
        _spawn(ctrl, 2, env=env)
        jobs = [ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                             "tenant": t})
                for t in ("p", "q", "p", "q")]
        assert ctrl.drain(timeout=120.0), "drain timed out"
        assert all(j.state == DONE for j in jobs)
        stats = ctrl.stats()
        assert stats["hosts_lost"] >= 1
        assert stats["jobs_migrated"] >= 1
        _wait(lambda: ctrl.telemetry.snapshot()
              ["epoch_fenced_rejects"] >= 1, timeout=15.0,
              msg="stale completion reject")
        assert ctrl.telemetry.snapshot()["hosts_rejoined"] >= 1
        fps = [j.fp for j in jobs]
    _journal_exactly_once(tmp_path, fps)
    oracle = _oracle_rmsf()
    for j in jobs:
        np.testing.assert_allclose(j.result_arrays()["rmsf"], oracle,
                                   atol=1e-6)


def test_ensemble_kill9_merge_parity_and_dedup(tmp_path):
    """The ensemble chaos leg: six members (the last a replica of the
    first) with the store-first ingest pre-stage over two port hosts,
    one ``kill -9``'d while the members run.  The merge is held to the
    JAX package's serial loop over the original files, pooled with the
    JAX package's reducers."""
    from mdanalysis_mpi_tpu import Universe
    from mdanalysis_mpi_tpu.analysis import RMSF
    from mdanalysis_mpi_tpu.io.xtc import write_xtc
    from mdanalysis_mpi_tpu.service.ensemble import (
        merge_moments, pairwise_rmsd,
    )
    from mdanalysis_mpi_tpu.testing import make_protein_universe

    from mdanalysis_mpi_tpu_torch.io.store.parallel import ingest_many

    fixture = {"kind": "protein", "n_residues": 6, "seed": 3}
    u0 = make_protein_universe(n_residues=6, seed=3)
    rng = np.random.default_rng(7)
    n_members, n_frames = 6, 12
    xtcs, frames_by_member = [], []
    for i in range(n_members):
        if i == n_members - 1:
            frames = frames_by_member[0]
        else:
            frames = rng.normal(scale=3.0,
                                size=(n_frames, len(u0.atoms), 3)) \
                .astype(np.float32)
        frames_by_member.append(frames)
        path = os.path.join(str(tmp_path), f"member{i}.xtc")
        write_xtc(path, frames,
                  dimensions=np.array([40.0, 40, 40, 90, 90, 90]),
                  times=np.arange(n_frames, dtype=np.float32))
        xtcs.append(path)
    out_root = os.path.join(str(tmp_path), "stores")
    seeded = ingest_many([xtcs[0]], out_root, jobs=1,
                         chunk_frames=4, quant="f32")
    assert seeded["ok"] and seeded["members"][0]["n_chunks"] == 3
    with _ctrl(tmp_path / "ctl", host_ttl_s=2.0) as ctrl:
        _spawn(ctrl, 2, env={"MDTPU_FLEET_RUN_DELAY": "0.4"})
        job = ctrl.submit({
            "analysis": "rmsf", "select": "all", "fixture": fixture,
            "tenant": "ens",
            "ensemble": [{"trajectory": x} for x in xtcs],
            "ingest": {"out_root": out_root, "chunk_frames": 4,
                       "quant": "f32"}})
        assert len(job.children) == n_members
        assert len(job.ingest_children) == n_members
        _wait(lambda: all(ij.state == DONE
                          for ij in job.ingest_children),
              timeout=60.0, msg="ingest pre-stage")
        victim = sorted(ctrl.placement.hosts())[0]
        assert ctrl.kill_host(victim)
        assert ctrl.drain(timeout=120.0), "drain timed out"
        assert job.state == DONE, job.error
        assert ctrl.stats()["hosts_lost"] == 1
        snap = ctrl.telemetry.snapshot()
        assert snap["ensembles_submitted"] == 1
        assert snap["ensemble_members"] == n_members
        assert snap["ensemble_members_completed"] == n_members
        assert snap["ensemble_members_failed"] == 0
        assert snap["ensemble_merges"] == 1
        child_fps = [c.fp for c in job.children] \
            + [c.fp for c in job.ingest_children]
        replica_ingest = job.ingest_children[-1].results
    _journal_exactly_once(tmp_path / "ctl", child_fps)
    res = job.results
    assert res["ensemble_members"] == n_members
    assert res["n_frames"] == float(n_members * n_frames)
    carries = []
    for path in xtcs:
        r = RMSF(Universe(u0.topology, path).atoms).run(
            backend="serial").results
        carries.append({"mean": np.asarray(r.mean),
                        "m2": np.asarray(r.m2),
                        "n_frames": float(r.n_frames)})
    oracle = merge_moments(carries)
    np.testing.assert_allclose(res["rmsf"], oracle["rmsf"], atol=1e-5)
    np.testing.assert_allclose(
        res["pairwise_rmsd"],
        pairwise_rmsd([c["mean"] for c in carries]), atol=1e-5)
    pw = np.asarray(res["pairwise_rmsd"])
    assert pw[0, -1] < 1e-6
    assert pw[0, 1] > 0.1
    np.testing.assert_allclose(res["member0_rmsf"],
                               res[f"member{n_members - 1}_rmsf"],
                               atol=1e-6)
    assert res["ensemble_ingest_members"] == n_members
    assert res["ensemble_ingest_dedup_chunks"] >= 3
    assert replica_ingest["dedup_chunks"] == 3
    assert replica_ingest["dedup_bytes"] > 0
    assert 0.0 < res["ensemble_dedup_ratio"] < 1.0
