"""The fleet slice of the port against the JAX package.

- The smoke record (the twin of ``tests/test_fleet.py``'s
  ``test_fleet_smoke_record``): ``fleet_smoke(device="cpu")`` — a
  two-host wave with one ``kill -9``, the QoS/elasticity phase, the
  ensemble phase and the streaming phase — holds every one of the JAX
  suite's assertions.
- The slice as a whole: a two-host port fleet on the CPU serves four
  jobs on one seeded fixture, each held to the JAX package on the same
  frames — ``rmsf`` within 1e-6 Å of its serial run; ``aligned-rmsf``
  by the fused engine at int16 (the kernel's plain version on the CPU)
  within 1e-3 Å of its serial run on the int16 wire coordinates; a
  sharded ``rmsd`` within 1e-6 Å of its unsharded serial run; and
  InterRDF by ``engine='pallas'`` (the pair-histogram kernel's plain
  version) with counts EQUAL to the JAX package's ``engine='pallas'``
  run in Pallas interpret mode and g(r) within 1e-6 relative.
- The journal across packages: a fleet journal written by the JAX
  package's controller (serial hosts of the JAX package) replays to the
  same result through the port's ``replay_fleet``, and a port fleet's
  journal through the JAX package's.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mdanalysis_mpi_tpu_torch.service import fleet as _fleet  # noqa: E402
from mdanalysis_mpi_tpu_torch.service.fleet import (  # noqa: E402
    DONE, FleetController,
)
from mdanalysis_mpi_tpu_torch.service.journal import (  # noqa: E402
    replay_fleet,
)

pytestmark = pytest.mark.reliability

FIXTURE = {"kind": "protein", "n_residues": 10, "n_frames": 12,
           "noise": 0.25, "seed": 5}
ENV = {"OMP_NUM_THREADS": "1"}
SEL = "protein and name CA"


def _spawn(ctrl, n):
    for _ in range(n):
        ctrl.spawn_host(hb_interval_s=0.1, env=ENV)
    assert ctrl.wait_hosts(n, timeout=60.0), "hosts never joined"


def test_fleet_smoke_record(tmp_path, monkeypatch):
    # the smoke spawns its own hosts: they inherit this environment
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    record = _fleet.fleet_smoke(workdir=str(tmp_path / "smoke"),
                                device="cpu")
    assert record["ok"], record
    assert record["exactly_once"]
    assert record["stats"]["hosts_lost"] == 1
    assert record["federation_match"]
    assert record["fleet_jobs_completed"] == 8
    assert record["scrape_jobs_completed"] == 8
    assert record["jobs_migrated"] >= 1
    assert record["trace_stitched_fp"] is not None
    assert record["trace_pids"] >= 2
    assert record["flight_dump"] is True
    assert record["qos_ok"], record
    assert record["qos_scaled_up"] >= 1
    assert record["qos_scaled_down"] >= 1
    assert record["qos_journal_scale_up"] >= 1
    assert record["qos_journal_scale_down"] >= 1
    assert record["qos_shed"] >= 1
    assert record["qos_journal_shed_records"] == record["qos_shed"]
    assert record["qos_shed_above_background"] == 0
    assert record["qos_exactly_once"]
    assert record["ensemble_ok"], record
    assert record["ensemble_dedup_chunks"] == 2
    assert record["ensemble_replica_rmsd"] < 1e-6
    assert record["ensemble_distinct_rmsd"] > 0.1
    assert record["ensemble_exactly_once"]
    # the port's streaming tenant ran on the torch backend
    assert record["streaming_ok"], record


def _water_files(tmp_path, n_waters=64, box=12.4, n_frames=4):
    """A seeded water box as a PSF and a DCD (float32, the box on every
    frame) that both packages open."""
    from mdanalysis_mpi_tpu_torch.io.dcd import write_dcd
    from mdanalysis_mpi_tpu_torch.io.psf import write_psf
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    u = make_water_universe(n_waters=n_waters, box=box,
                            n_frames=n_frames, seed=1)
    psf = os.path.join(str(tmp_path), "w.psf")
    dcd = os.path.join(str(tmp_path), "w.dcd")
    write_psf(psf, u.topology)
    dims = np.tile(np.array([box] * 3 + [90.0] * 3), (n_frames, 1))
    write_dcd(dcd, u.trajectory.read_block(0, n_frames)[0],
              dimensions=dims)
    return psf, dcd


def test_slice_against_the_jax_package(tmp_path):
    from mdanalysis_mpi_tpu import Universe as JUniverse
    from mdanalysis_mpi_tpu import analysis as jana
    from mdanalysis_mpi_tpu.parallel.executors import quantize_block
    from mdanalysis_mpi_tpu.testing import make_protein_universe

    psf, dcd = _water_files(tmp_path)
    rdf = {"analysis": "rdf", "topology": psf, "trajectory": dcd,
           "select": "name OW", "nbins": 24, "r_max": 6.0,
           "engine": "pallas", "batch_size": 2, "tenant": "d"}
    with FleetController(tmp_path / "ctl", host_ttl_s=5.0,
                         device="cpu") as ctrl:
        _spawn(ctrl, 2)
        jobs = {
            "rmsf": ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                                 "tenant": "a"}),
            "aligned": ctrl.submit({"analysis": "aligned-rmsf",
                                    "fixture": FIXTURE, "select": SEL,
                                    "engine": "fused",
                                    "transfer_dtype": "int16",
                                    "batch_size": 12, "tenant": "b"}),
            "rmsd": ctrl.submit({"analysis": "rmsd", "fixture": FIXTURE,
                                 "select": SEL, "shards": 2,
                                 "tenant": "c"}),
            "rdf": ctrl.submit(rdf),
        }
        assert ctrl.drain(timeout=120.0), "drain timed out"
        assert {k: j.state for k, j in jobs.items()} == dict.fromkeys(
            jobs, DONE), {k: j.error for k, j in jobs.items()}
        assert len({c.host for c in jobs["rmsd"].children}) >= 1
    got = {k: j.result_arrays() for k, j in jobs.items()}
    u = make_protein_universe(
        **{k: v for k, v in FIXTURE.items() if k != "kind"})
    # rmsf: the JAX package's serial run
    want = jana.RMSF(u.select_atoms(SEL)).run(backend="serial")
    np.testing.assert_allclose(got["rmsf"]["rmsf"], want.results.rmsf,
                               atol=1e-6)
    # aligned-rmsf, fused int16: the serial run on the wire coordinates
    # (one block of all 12 frames, one symmetric int16 scale)
    idx = u.select_atoms(SEL).indices
    block, _ = u.trajectory.read_block(0, 12)
    q, inv = quantize_block(np.ascontiguousarray(block[:, idx]), "int16")
    wire = q.astype(np.float32) * inv
    uw = make_protein_universe(
        **{k: v for k, v in FIXTURE.items() if k != "kind"})
    frames = uw.trajectory.read_block(0, 12)[0].copy()
    frames[:, idx] = wire
    from mdanalysis_mpi_tpu.io.memory import MemoryReader

    u_wire = JUniverse(uw.topology, MemoryReader(frames))
    want = jana.AlignedRMSF(u_wire, select=SEL).run(backend="serial")
    err = np.abs(got["aligned"]["rmsf"] - want.results.rmsf).max()
    assert err <= 1e-3, err
    # sharded rmsd: the unsharded serial run
    want = jana.RMSD(u, select=SEL).run(backend="serial")
    np.testing.assert_allclose(got["rmsd"]["rmsd"], want.results.rmsd,
                               atol=1e-6)
    # InterRDF: the JAX package's Pallas kernel in interpret mode on
    # the same frames — counts equal
    ju = JUniverse(psf, dcd)
    jow = ju.select_atoms("name OW")
    want = jana.InterRDF(jow, jow, nbins=24, range=(0.0, 6.0),
                         engine="pallas").run(backend="jax", batch_size=2)
    np.testing.assert_array_equal(got["rdf"]["count"],
                                  np.asarray(want.results.count))
    assert got["rdf"]["count"].sum() > 0
    np.testing.assert_allclose(got["rdf"]["rdf"], want.results.rdf,
                               rtol=1e-6)
    np.testing.assert_array_equal(got["rdf"]["bins"], want.results.bins)


def _drive(ctrl, spawn):
    """One small wave: three tenants and a sharded job → fingerprints."""
    spawn()
    assert ctrl.wait_hosts(1, timeout=60.0)
    jobs = [ctrl.submit({"analysis": "rmsf", "fixture": FIXTURE,
                         "tenant": f"t{i}"}) for i in range(3)]
    jobs.append(ctrl.submit({"analysis": "rmsd", "fixture": FIXTURE,
                             "tenant": "s", "shards": 2}))
    assert ctrl.drain(timeout=120.0), "drain timed out"
    assert all(j.state == DONE for j in jobs)
    return [j.fp for j in jobs]


def test_journal_replays_alike_across_packages(tmp_path):
    from mdanalysis_mpi_tpu.service import fleet as jfleet
    from mdanalysis_mpi_tpu.service.journal import (
        replay_fleet as jreplay_fleet,
    )

    jdir = str(tmp_path / "jax")
    with jfleet.FleetController(jdir, host_ttl_s=5.0,
                                status=False) as ctrl:
        _drive(ctrl, lambda: ctrl.spawn_host(hb_interval_s=0.1,
                                             env=ENV))
    pdir = str(tmp_path / "port")
    with FleetController(pdir, host_ttl_s=5.0, status=False,
                         device="cpu") as ctrl:
        _drive(ctrl, lambda: ctrl.spawn_host(hb_interval_s=0.1,
                                             env=ENV))
    for wd in (jdir, pdir):
        path = os.path.join(wd, _fleet.JOURNAL_NAME)
        assert os.path.basename(path) == jfleet.JOURNAL_NAME
        mine, theirs = replay_fleet(path), jreplay_fleet(path)
        assert mine == theirs
        assert mine["epoch"] == 1 and mine["stale_records"] == 0
        # 3 solo jobs + 2 shard children, each finished once
        assert sorted(mine["finishes"].values()) == [1] * 5
        assert all(rec["state"] == "done"
                   for rec in mine["jobs"].values())
    # the standby of either package adopts the other's journal alike
    adopted = FleetController.adopt(jdir, status=False, device="cpu")
    try:
        assert adopted.epoch == 2
        assert not [j for j in adopted.jobs().values()
                    if j.state != DONE]
    finally:
        adopted.shutdown()
    assert jreplay_fleet(os.path.join(jdir, _fleet.JOURNAL_NAME))[
        "epoch"] == 2
