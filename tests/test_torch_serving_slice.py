"""The executor and analysis pieces of the serving slice, on the CPU:
``MeshExecutor.warmup`` and ``.stage`` (the mesh's counterparts of
``TorchExecutor``'s, which ``Scheduler.warmup`` and its prefetch call),
and run capture in ``AnalysisBase.run`` (``results.observability``, the
phase window released when a run raises), held against the JAX
package's report where both run.
"""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.analysis import (AlignedRMSF, InterRDF, RMSD,
                                               RMSF)
from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisFromFunction
from mdanalysis_mpi_tpu_torch.parallel.executors import (
    DeviceBlockCache, MeshExecutor, TorchExecutor, stage_analysis,
    warmup_analysis)
from mdanalysis_mpi_tpu_torch.service import AnalysisJob, Scheduler
from mdanalysis_mpi_tpu_torch.testing import (make_protein_universe,
                                              make_water_universe)
from mdanalysis_mpi_tpu_torch.utils import compile_cache, timers

pytestmark = pytest.mark.service

SHARDS = ["cpu"] * 2


def _u():
    return make_protein_universe(n_residues=40, n_frames=40, seed=1)


@pytest.mark.parametrize("td", ["int16", "float32", "delta"])
def test_mesh_warmup_and_stage_prepare_what_execute_runs(td):
    """A fused AlignedRMSF: the warmup runs programs (> 0) on every
    shard, the stage puts every block in the cache (> 0), and the run
    after them stages nothing more and equals, bit for bit, the repeat
    of a run that staged its own blocks (the same cached schedule)."""
    u = _u()
    cache = DeviceBlockCache()
    ex = MeshExecutor(batch_size=4, devices=SHARDS, block_cache=cache,
                      transfer_dtype=td)
    w0 = compile_cache.counters()["warmed"]
    n_warm = warmup_analysis(AlignedRMSF(u, engine="fused"), ex)
    assert n_warm > 0
    assert compile_cache.counters()["warmed"] - w0 == n_warm
    n_staged = stage_analysis(AlignedRMSF(u, engine="fused"), ex)
    assert n_staged == 40 // 8            # every block, staged once
    keys, misses = set(cache._store), cache.misses
    warm = AlignedRMSF(u, engine="fused").run(backend=ex)
    assert set(cache._store) == keys and cache.misses == misses
    # a fresh Universe: int16 staging keeps scale hints on its reader
    u2 = _u()
    own = MeshExecutor(batch_size=4, devices=SHARDS,
                       block_cache=DeviceBlockCache(), transfer_dtype=td)
    AlignedRMSF(u2, engine="fused").run(backend=own)
    again = AlignedRMSF(u2, engine="fused").run(backend=own)
    np.testing.assert_array_equal(warm.results.rmsf, again.results.rmsf)


def test_mesh_stage_keys_are_torch_executor_keys_on_the_mesh():
    """The mesh stages under the key ``TorchExecutor`` uses for the
    same global batch, with its device list in the device field; per
    block (``scan_k=1``) and per scan group alike."""
    u = _u()
    for scan_k in (1, "auto"):
        mc, tc = DeviceBlockCache(), DeviceBlockCache()
        mesh = MeshExecutor(batch_size=4, devices=SHARDS, block_cache=mc,
                            transfer_dtype="int16", scan_k=scan_k)
        one = TorchExecutor(batch_size=8, device="cpu", block_cache=tc,
                            transfer_dtype="int16", scan_k=scan_k)
        assert stage_analysis(AlignedRMSF(u, engine="fused"), mesh) > 0
        assert stage_analysis(AlignedRMSF(u, engine="fused"), one) > 0
        dev = (tuple(SHARDS), None)
        swapped = {k[:6] + ("cpu",) + k[7:] for k in mc._store
                   if k[6] == dev}
        assert len(swapped) == len(mc._store)
        assert swapped == set(tc._store)


def test_mesh_warmup_and_stage_skip_what_jax_skips():
    """0 for a serial-only analysis, the ring path, and (stage) no
    cache; the count otherwise."""
    u = _u()
    ex = MeshExecutor(batch_size=4, devices=SHARDS,
                      block_cache=DeviceBlockCache())
    fn = AnalysisFromFunction(lambda ag: ag.positions.sum(),
                              u.trajectory, u.atoms)
    assert warmup_analysis(fn, ex) == 0
    assert stage_analysis(fn, ex) == 0
    uw = make_water_universe(n_waters=32, n_frames=4, box=9.9)
    ow = uw.select_atoms("name OW")
    ring = InterRDF(ow, ow, nbins=8, range=(0.0, 4.0), engine="ring")
    assert warmup_analysis(ring, ex) == 0
    assert stage_analysis(ring, ex) == 0
    bare = MeshExecutor(batch_size=4, devices=SHARDS)
    assert stage_analysis(RMSF(u.select_atoms("name CA")), bare) == 0
    assert warmup_analysis(RMSF(u.select_atoms("name CA")), bare) > 0


def test_scheduler_warmup_and_prefetch_count_the_mesh():
    """``Scheduler.warmup`` and ``prefetch_pending`` reach the mesh
    (they returned 0 for it before the mesh had a warmup), and the
    served mesh job's pass 1 hits the prefetched blocks."""
    u = _u()
    cache = DeviceBlockCache()
    sched = Scheduler(n_workers=1, autostart=False, cache=cache)
    job = AnalysisJob(AlignedRMSF(u, engine="fused"), backend="mesh",
                      batch_size=4,
                      executor_kwargs={"devices": SHARDS,
                                       "transfer_dtype": "int16"})
    assert sched.warmup([job])["executables"] > 0
    h = sched.submit(job)
    assert sched.prefetch_pending() > 0 and h.prefetched
    hits = cache.hits
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert cache.hits > hits
    assert sched.telemetry.snapshot()["prefetch_skipped"] == 0
    # the same schedule outside the scheduler: stage, then run
    u2 = _u()
    ex = MeshExecutor(batch_size=4, devices=SHARDS,
                      block_cache=DeviceBlockCache(),
                      transfer_dtype="int16")
    stage_analysis(AlignedRMSF(u2, engine="fused"), ex)
    ref = AlignedRMSF(u2, engine="fused").run(backend=ex)
    np.testing.assert_array_equal(h.result().results.rmsf,
                                  ref.results.rmsf)


def test_job_backend_defaults_to_the_analysis_default():
    """A job with no backend takes the analysis' ``_default_backend``,
    as ``run()`` does: torch for the batch analyses (on the card unless
    the job names a device), serial for the serial-only ones."""
    u = _u()
    assert AnalysisJob(RMSD(u.select_atoms("name CA"))).backend == "torch"
    fn = AnalysisFromFunction(lambda ag: ag.positions.sum(),
                              u.trajectory, u.atoms)
    assert AnalysisJob(fn).backend == "serial"
    assert AnalysisJob(RMSD(u.select_atoms("name CA")),
                       backend="mesh").backend == "mesh"
    # list-valued executor keywords (the mesh's devices) still key
    job = AnalysisJob(RMSD(u.select_atoms("name CA")), backend="mesh",
                      executor_kwargs={"devices": SHARDS})
    assert hash(job.coalesce_key())


# ---------------------------------------------------------------------------
# run capture in AnalysisBase.run
# ---------------------------------------------------------------------------


def test_run_attaches_a_report_with_the_jax_keys():
    pytest.importorskip("jax")
    from mdanalysis_mpi_tpu.analysis import RMSD as JRMSD
    from mdanalysis_mpi_tpu.testing import make_protein_universe as jmake

    u = _u()
    ju = jmake(n_residues=40, n_frames=40, seed=1)
    t = RMSD(u.select_atoms("name CA")).run(device="cpu", batch_size=8)
    j = JRMSD(ju.select_atoms("name CA")).run(backend="jax",
                                              batch_size=8)
    tr, jr = t.results.observability, j.results.observability
    # the JAX package's keys, and the port's staging summary (a staged
    # run's blocks by staging path and bytes copied to the device)
    assert set(tr) == set(jr) | {"staging"}
    assert tr["staging"]["blocks"] and tr["staging"]["bytes"] > 0
    assert (tr["analysis"], tr["n_frames"]) == (jr["analysis"],
                                                jr["n_frames"])
    assert tr["backend"] == "torch" and jr["backend"] == "jax"
    assert set(tr["phases"]) >= {"prepare", "execute", "conclude",
                                 "dispatch"}
    assert tr["dispatch_count"] == jr["dispatch_count"] == 5
    # the multi-pass run reports both passes under one report
    from mdanalysis_mpi_tpu.analysis import AlignedRMSF as JAlignedRMSF

    a = AlignedRMSF(u).run(device="cpu", batch_size=8)
    ja = JAlignedRMSF(ju).run(backend="jax", batch_size=8)
    ar, jar = a.results.observability, ja.results.observability
    assert set(ar) == set(jar) | {"staging"}
    assert ar["analysis"] == "AlignedRMSF"
    assert ar["n_frames"] == jar["n_frames"] == 40
    assert ar["dispatch_count"] == jar["dispatch_count"]


def test_raising_run_releases_its_phase_window():
    u = _u()

    class Boom(RMSF):
        def _prepare(self):
            raise RuntimeError("boom")

    with obs.trace_context(trace_ids=["job-boom"]):
        before = len(timers._WINDOWS)
        with pytest.raises(RuntimeError, match="boom"):
            Boom(u.select_atoms("name CA")).run(device="cpu")
        assert len(timers._WINDOWS) == before
        ok = RMSF(u.select_atoms("name CA")).run(device="cpu")
        assert len(timers._WINDOWS) == before
    assert ok.results.observability["phase_attribution"] == "job"


def test_profiler_summary_rides_the_report(monkeypatch):
    from mdanalysis_mpi_tpu_torch.obs import prof

    u = _u()
    monkeypatch.setenv("MDTPU_PROF", "1")
    try:
        r = RMSF(u.select_atoms("name CA")).run(device="cpu",
                                                batch_size=8)
        rep = r.results.observability
        assert "profiler" in rep
        assert any(k.startswith("bs8_scan1")
                   for k in prof.dispatch_stats())
    finally:
        monkeypatch.delenv("MDTPU_PROF")
        prof.disable()
        prof.reset()
    r = RMSF(u.select_atoms("name CA")).run(device="cpu", batch_size=8)
    assert "profiler" not in r.results.observability


# ---------------------------------------------------------------------------
# the batch entry point, as a user runs it
# ---------------------------------------------------------------------------


def test_batch_subcommand_npz_equal_in_process_runs(tmp_path):
    """``python -m mdanalysis_mpi_tpu_torch batch`` on a PSF/DCD: the
    fused AlignedRMSF, RMSD and RadiusOfGyration jobs write ``.npz``
    results within 1e-5 Å of the same runs in process (the CPU twin of
    the card's batch leg)."""
    import json
    import os
    import subprocess
    import sys

    from mdanalysis_mpi_tpu_torch import Universe
    from mdanalysis_mpi_tpu_torch.analysis import RadiusOfGyration
    from mdanalysis_mpi_tpu_torch.io.dcd import write_dcd
    from mdanalysis_mpi_tpu_torch.io.psf import write_psf

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    u = make_protein_universe(n_residues=30, n_frames=24, noise=0.3,
                              seed=4)
    psf, dcd = str(tmp_path / "p.psf"), str(tmp_path / "p.dcd")
    write_psf(psf, u.topology)
    write_dcd(dcd, u.trajectory.read_block(0, 24)[0])
    outs = {k: str(tmp_path / f"{k}.npz") for k in ("a", "d", "g")}
    spec = {"topology": psf, "trajectory": dcd,
            "defaults": {"select": "name CA", "device": "cpu",
                         "batch_size": 8},
            "jobs": [{"analysis": "aligned-rmsf", "engine": "fused",
                      "transfer_dtype": "int16", "output": outs["a"],
                      "tenant": "a"},
                     {"analysis": "rmsd", "output": outs["d"],
                      "tenant": "d"},
                     {"analysis": "rgyr", "output": outs["g"],
                      "tenant": "g"}]}
    jobs = tmp_path / "jobs.json"
    jobs.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=repo)
    p = subprocess.run([sys.executable, "-m", "mdanalysis_mpi_tpu_torch",
                        "batch", str(jobs)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    doc = json.loads(p.stdout.strip().splitlines()[-1])
    assert [r["state"] for r in doc["jobs"]] == ["done"] * 3
    assert doc["serving"]["admission_shed_serial"] == 0
    uu = Universe(psf, dcd)
    want = {
        "a": AlignedRMSF(uu, select="name CA", engine="fused").run(
            device="cpu", batch_size=8,
            transfer_dtype="int16").results.rmsf,
        "d": RMSD(uu, select="name CA").run(
            device="cpu", batch_size=8).results.rmsd,
        "g": RadiusOfGyration(uu.select_atoms("name CA")).run(
            device="cpu", batch_size=8).results.rgyr,
    }
    for k, key in (("a", "rmsf"), ("d", "rmsd"), ("g", "rgyr")):
        got = np.load(outs[k])[key]
        np.testing.assert_allclose(got, np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=key)
