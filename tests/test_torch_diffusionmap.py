"""The port's DistanceMatrix / DiffusionMap (``analysis/diffusionmap.py``):
the JAX package's tests/test_diffusionmap.py case by case on
``backend="torch", device="cpu"`` and a two-shard CPU mesh (their
tolerance: 5e-3 Å against the serial oracle), the device pair RMSD
(row blocks of products + the QCP top eigenvalue) against the serial
Kabsch loop, and the same seeded protein through the JAX package's
``backend="jax"`` and the port."""

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu_torch.analysis.diffusionmap import (
    DiffusionMap, DistanceMatrix, pair_block_rows, pairwise_rmsd_device)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)
BK = {"jax": TORCH, "mesh": MESH}


class TestDistanceMatrix:
    def test_rigid_motion_gives_zero_matrix(self):
        u = make_protein_universe(n_residues=5, n_frames=8, noise=0.0,
                                  rigid_motion=True)
        m = DistanceMatrix(u, select="name CA").run(
            backend="serial").results.dist_matrix
        assert m.shape == (8, 8)
        np.testing.assert_allclose(m, 0.0, atol=1e-6)

    def test_rigid_motion_on_the_device(self):
        u = make_protein_universe(n_residues=5, n_frames=8, noise=0.0,
                                  rigid_motion=True)
        m = DistanceMatrix(u, select="name CA").run(
            **TORCH, batch_size=3).results.dist_matrix
        # float64 QCP on float32 frames: the cancellation floor of
        # e0 − 2λ, far inside the 5e-3 Å gate
        np.testing.assert_allclose(m, 0.0, atol=1e-3)

    @pytest.mark.parametrize("backend", ["jax", "mesh"])
    def test_backend_parity(self, backend):
        u = make_protein_universe(n_residues=5, n_frames=12, noise=0.4)
        s = DistanceMatrix(u, select="name CA").run(
            backend="serial").results.dist_matrix
        j = DistanceMatrix(u, select="name CA").run(
            **BK[backend], batch_size=4).results.dist_matrix
        np.testing.assert_allclose(j, s, atol=5e-3)
        # symmetry + zero diagonal by construction
        np.testing.assert_allclose(j, j.T)
        np.testing.assert_allclose(np.diag(j), 0.0)

    def test_entries_match_oneshot_rmsd(self):
        from mdanalysis_mpi_tpu_torch.analysis.rms import rmsd

        u = make_protein_universe(n_residues=4, n_frames=5, noise=0.5)
        ca = u.select_atoms("name CA")
        m = DistanceMatrix(u, select="name CA").run(
            backend="serial").results.dist_matrix
        a = u.trajectory[1].positions[ca.indices].copy()
        b = u.trajectory[3].positions[ca.indices]
        want = rmsd(b, a, weights=ca.masses, superposition=True)
        np.testing.assert_allclose(m[1, 3], want, atol=1e-9)

    def test_guards(self):
        u = make_protein_universe(n_residues=4, n_frames=4)
        with pytest.raises(ValueError, match="at least 2"):
            DistanceMatrix(u).run(stop=1, backend="serial")
        with pytest.raises(ValueError, match="weights"):
            DistanceMatrix(u, weights="charge")

    def test_frame_cap(self):
        u = make_protein_universe(n_residues=2, n_frames=4)
        dm = DistanceMatrix(u, select="name CA")
        with pytest.raises(ValueError, match="window the run"):
            dm.run(frames=np.zeros(4097, np.int64), backend="serial")


class TestDevicePairRMSD:
    @pytest.mark.parametrize("weights", [None, "mass"])
    def test_device_route_equals_serial_float64(self, weights):
        """The device route stages the same float32 frames the serial
        loop reads and solves in float64: it agrees to ~1e-12 Å, far
        tighter than the 5e-3 Å gate."""
        u = make_protein_universe(n_residues=7, n_frames=15, noise=0.5,
                                  seed=3)
        s = DistanceMatrix(u, select="name CA", weights=weights).run(
            backend="serial").results.dist_matrix
        d = DistanceMatrix(u, select="name CA", weights=weights).run(
            **TORCH, batch_size=4).results.dist_matrix
        np.testing.assert_allclose(d, s, atol=1e-9)

    def test_row_blocks_do_not_change_the_matrix(self, monkeypatch):
        from mdanalysis_mpi_tpu_torch.analysis import diffusionmap

        rng = np.random.default_rng(5)
        pos = torch.as_tensor(rng.normal(scale=3.0, size=(11, 9, 3)),
                              dtype=torch.float32)
        w = rng.uniform(1.0, 16.0, 9)
        whole = pairwise_rmsd_device(pos, w)
        # 11 frames × 9 entries × 8 bytes a row: blocks of 2 rows
        monkeypatch.setattr(diffusionmap, "_BLOCK_BYTES", 2 * 11 * 72)
        assert pair_block_rows(11) == 2
        blocked = pairwise_rmsd_device(pos, w)
        # the same float64 algebra; only the product's blocking (and
        # so its last-bit rounding) differs
        np.testing.assert_allclose(blocked.numpy(), whole.numpy(),
                                   rtol=0, atol=1e-12)

    def test_block_rows_bound(self):
        assert pair_block_rows(4096) * 4096 * 9 * 8 <= 1 << 30
        assert pair_block_rows(3) == 3
        assert pair_block_rows(10 ** 9) == 1

    def test_no_svd_call(self, monkeypatch):
        """The device route solves no 3×3 SVD (the JAX package's route
        does T² of them)."""
        def refuse(*a, **k):
            raise AssertionError("torch.linalg.svd called")

        monkeypatch.setattr(torch.linalg, "svd", refuse)
        u = make_protein_universe(n_residues=4, n_frames=6, noise=0.4)
        m = DistanceMatrix(u, select="name CA").run(
            **TORCH, batch_size=4).results.dist_matrix
        assert m.shape == (6, 6) and np.isfinite(m).all()


class TestDiffusionMap:
    def test_spectrum_and_embedding(self):
        u = make_protein_universe(n_residues=5, n_frames=16, noise=0.4)
        dmap = DiffusionMap(u, select="name CA", epsilon=2.0).run(
            **TORCH, batch_size=4)
        vals = dmap.results.eigenvalues
        # stochastic-matrix spectrum: lambda_0 == 1 >= lambda_1 >= ...
        np.testing.assert_allclose(vals[0], 1.0, atol=1e-8)
        assert (np.diff(vals) <= 1e-10).all()
        emb = dmap.transform(3, time=1.0)
        assert emb.shape == (16, 3)
        assert np.isfinite(emb).all()

    def test_accepts_prebuilt_matrix_and_type_guard(self):
        u = make_protein_universe(n_residues=4, n_frames=6, noise=0.3)
        dm = DistanceMatrix(u, select="name CA")
        dm.run(backend="serial")
        dmap = DiffusionMap(dm, epsilon=1.0).run()
        assert dmap.results.eigenvalues.shape == (6,)
        with pytest.raises(TypeError, match="Universe"):
            DiffusionMap(np.zeros((3, 3)))
        with pytest.raises(RuntimeError, match="run"):
            DiffusionMap(dm).transform(2)


class TestAgainstJaxPackage:
    """The same seeded protein through the JAX package's
    ``backend="jax"`` (T² float32 SVDs) and the port's device route:
    both within the JAX package's 5e-3 Å of serial, and of each other
    within 1e-4 Å (the JAX route's float32 SVD error; the port's is
    ~1e-14 Å)."""

    def test_dist_matrix_and_spectrum(self):
        from mdanalysis_mpi_tpu.analysis.diffusionmap import (
            DiffusionMap as JDiffusionMap)
        from mdanalysis_mpi_tpu.testing import (
            make_protein_universe as j_make)

        kw = dict(n_residues=6, n_frames=14, noise=0.4, seed=9)
        uj, ut = j_make(**kw), make_protein_universe(**kw)
        j = JDiffusionMap(uj, select="name CA", epsilon=2.0).run(
            backend="jax", batch_size=4)
        t = DiffusionMap(ut, select="name CA", epsilon=2.0).run(
            **TORCH, batch_size=4)
        mj = j._dm.results.dist_matrix
        mt = t._dm.results.dist_matrix
        np.testing.assert_allclose(mt, mj, atol=1e-4)
        s = DistanceMatrix(ut, select="name CA").run(
            backend="serial").results.dist_matrix
        np.testing.assert_allclose(mt, s, atol=5e-3)
        np.testing.assert_allclose(t.results.eigenvalues,
                                   j.results.eigenvalues, atol=1e-4)
