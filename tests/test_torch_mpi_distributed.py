"""Twin of ``tests/test_mpi_distributed.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

MPI host executor, multi-host helpers, checkpoint/resume.

The reference's ``TestMPIExecutor`` and the single-process helpers of
``TestDistributedHelpers`` are twinned in ``tests/test_torch_mpi.py``;
``test_global_batch_single_process`` has no port image (the
``global_*`` family builds a ``jax.Array`` over a JAX mesh; each rank
keeps its own shard, ROADMAP §A).  What stays is the checkpoint suite."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import RMSD, RMSF
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
from mdanalysis_mpi_tpu_torch.utils.checkpoint import run_checkpointed

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    port_runs_on_the_cpu)


class TestCheckpoint:
    def test_complete_run_matches_plain(self, tmp_path):
        u = make_protein_universe(n_residues=8, n_frames=20, seed=4)
        path = str(tmp_path / "ckpt.npz")
        a = run_checkpointed(RMSF(u.select_atoms("name CA")), path,
                             chunk_frames=6, backend="torch", batch_size=4)
        ref = RMSF(u.select_atoms("name CA")).run(backend="serial")
        np.testing.assert_allclose(a.results.rmsf, ref.results.rmsf,
                                   rtol=1e-4)
        import os
        assert not os.path.exists(path)   # removed on success

    def test_resume_after_crash(self, tmp_path, monkeypatch):
        import mdanalysis_mpi_tpu_torch.utils.checkpoint as ckpt

        u = make_protein_universe(n_residues=8, n_frames=20, seed=5)
        path = str(tmp_path / "ckpt.npz")

        real_save = ckpt._save
        calls = []

        def crashing_save(p, done, partials, fp):
            real_save(p, done, partials, fp)
            calls.append(done)
            if len(calls) == 2:
                raise RuntimeError("simulated crash after checkpoint 2")

        monkeypatch.setattr(ckpt, "_save", crashing_save)
        with pytest.raises(RuntimeError, match="simulated crash"):
            run_checkpointed(RMSF(u.select_atoms("name CA")), path,
                             chunk_frames=5, backend="torch", batch_size=5)
        monkeypatch.setattr(ckpt, "_save", real_save)

        import os
        assert os.path.exists(path)       # durable partial progress
        a = run_checkpointed(RMSF(u.select_atoms("name CA")), path,
                             chunk_frames=5, backend="torch", batch_size=5)
        ref = RMSF(u.select_atoms("name CA")).run(backend="serial")
        np.testing.assert_allclose(a.results.rmsf, ref.results.rmsf,
                                   rtol=1e-4)

    def test_checkpoint_round3_reductions(self, tmp_path):
        """PCA and density partials (matrix psum / int32 grid counts)
        checkpoint and resume like the moment reductions."""
        from mdanalysis_mpi_tpu_torch.analysis import PCA, DensityAnalysis
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        u = make_protein_universe(n_residues=6, n_frames=18, seed=6)
        a = run_checkpointed(PCA(u, select="name CA", n_components=3),
                             str(tmp_path / "p.npz"), chunk_frames=5,
                             backend="torch", batch_size=5)
        ref = PCA(u, select="name CA", n_components=3).run(backend="serial")
        np.testing.assert_allclose(
            np.asarray(a.results.variance), ref.results.variance,
            rtol=5e-2, atol=1e-3 * float(ref.results.variance[0]))

        w = make_water_universe(n_waters=20, n_frames=12, box=12.0, seed=7)
        ow = w.select_atoms("name OW")
        d = run_checkpointed(DensityAnalysis(ow, delta=2.0),
                             str(tmp_path / "d.npz"), chunk_frames=4,
                             backend="torch", batch_size=4)
        dref = DensityAnalysis(ow, delta=2.0).run(backend="serial")
        np.testing.assert_allclose(d.results.grid, dref.results.grid,
                                   atol=1e-6)

    def test_rejects_serial_and_timeseries(self, tmp_path):
        u = make_protein_universe(n_residues=4, n_frames=4, seed=6)
        with pytest.raises(ValueError, match="serial"):
            run_checkpointed(RMSF(u.select_atoms("name CA")),
                             str(tmp_path / "c.npz"), backend="serial")
        with pytest.raises(ValueError, match="mergeable"):
            run_checkpointed(RMSD(u.select_atoms("name CA")),
                             str(tmp_path / "c.npz"))

    def test_wrong_checkpoint_shape_detected(self, tmp_path):
        import mdanalysis_mpi_tpu_torch.utils.checkpoint as ckpt

        u = make_protein_universe(n_residues=8, n_frames=8, seed=7)
        probe = RMSF(u.select_atoms("name CA"))
        frames = list(probe._frames(None, None, None))
        probe._prepare()
        fp = ckpt._fingerprint(probe, frames)
        path = str(tmp_path / "ckpt.npz")
        ckpt._save(path, 4, (np.float64(4.0),), fp)   # wrong leaf count
        with pytest.raises(ValueError, match="leaves"):
            run_checkpointed(RMSF(u.select_atoms("name CA")), path,
                             chunk_frames=4, backend="torch", batch_size=4)

    def test_rejects_accumulating_executors(self, tmp_path):
        """Whitelist, not blacklist (ADVICE r1, medium): backend='mpi'
        and executor INSTANCES that accumulate inside the analysis would
        double-count partials on fold — they must be refused."""
        from mdanalysis_mpi_tpu_torch.parallel.executors import SerialExecutor
        from mdanalysis_mpi_tpu_torch.parallel.mpi import MPIExecutor, ThreadComm

        u = make_protein_universe(n_residues=4, n_frames=4, seed=6)
        with pytest.raises(ValueError, match="per-call partials"):
            run_checkpointed(RMSF(u.select_atoms("name CA")),
                             str(tmp_path / "c.npz"),
                             backend=SerialExecutor())
        with pytest.raises(ValueError, match="per-call partials"):
            run_checkpointed(RMSF(u.select_atoms("name CA")),
                             str(tmp_path / "c.npz"),
                             backend=MPIExecutor(comm=ThreadComm.make(1)[0]))

    def test_fingerprint_mismatch_refuses_resume(self, tmp_path):
        """A checkpoint from a different selection (same partials shape)
        must refuse to resume, not merge wrong partials (ADVICE r1)."""
        u = make_protein_universe(n_residues=8, n_frames=12, seed=9)
        path = str(tmp_path / "ckpt.npz")
        # write a genuine half-way checkpoint for the CA selection
        class _Boom(Exception):
            pass
        import mdanalysis_mpi_tpu_torch.utils.checkpoint as ckpt
        real_save = ckpt._save
        calls = []
        def save_once(pth, done, total, fp):
            real_save(pth, done, total, fp)
            calls.append(done)
            raise _Boom
        ckpt._save = save_once
        try:
            with pytest.raises(_Boom):
                run_checkpointed(RMSF(u.select_atoms("name CA")), path,
                                 chunk_frames=6, backend="torch",
                                 batch_size=6)
        finally:
            ckpt._save = real_save
        assert calls == [6]
        # resuming with a DIFFERENT selection of the same size: refuse
        with pytest.raises(ValueError, match="different"):
            run_checkpointed(RMSF(u.select_atoms("name CB")), path,
                             chunk_frames=6, backend="torch", batch_size=6)
