"""The port's path similarity analysis (``analysis/psa.py``): the JAX
package's tests/test_psa.py case by case with ``backend="torch",
device="cpu"`` for its ``'jax'`` (their tolerances: 1e-4 for the device
twins against the float64 oracle on random paths, 0.05 for PSAnalysis
against serial), the anti-diagonal Fréchet wavefront EQUAL to the host
recurrence on the same cross matrix (only ``max`` and ``min`` touch the
values), and the same paths through the JAX package's ``'jax'`` route
and the port."""

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu_torch.analysis import (PSAnalysis, discrete_frechet,
                                               hausdorff)
from mdanalysis_mpi_tpu_torch.analysis.psa import (_frechet_np, cross_rmsd,
                                                   frechet_wavefront,
                                                   hausdorff_from_cross)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

TORCH = dict(backend="torch", device="cpu")


def _path_1d(xs):
    """1-atom path along x: (T, 1, 3); frame RMSD = |Δx|."""
    p = np.zeros((len(xs), 1, 3))
    p[:, 0, 0] = xs
    return p


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def test_hausdorff_hand_computed():
    p = _path_1d([0.0, 1.0, 2.0])
    q = _path_1d([0.0, 1.0, 2.0, 5.0])
    # every p-point has a 0-distance match; q's 5.0 is 3.0 from p's 2.0
    assert hausdorff(p, q) == pytest.approx(3.0)
    assert hausdorff(p, p) == 0.0
    assert float(hausdorff_from_cross(cross_rmsd(_t(p), _t(q)))) == \
        pytest.approx(3.0)


def test_frechet_order_sensitivity():
    """A path that doubles back: Hausdorff ignores ordering (0), the
    Fréchet leash must stretch."""
    p = _path_1d([0.0, 1.0, 2.0, 3.0])
    q = _path_1d([0.0, 1.0, 2.0, 1.0, 2.0, 3.0])   # backtracks 2->1->2
    assert hausdorff(p, q) == pytest.approx(0.0)
    f = discrete_frechet(p, q)
    assert f == pytest.approx(1.0)   # leash stretches during the backtrack
    # Fréchet >= Hausdorff always
    assert f >= hausdorff(p, q)
    assert float(frechet_wavefront(cross_rmsd(_t(p), _t(q)))) == \
        pytest.approx(1.0)


def test_frechet_equals_hausdorff_for_monotone_paths():
    p = _path_1d([0.0, 1.0, 2.0])
    q = _path_1d([0.5, 1.5, 2.5])
    assert discrete_frechet(p, q) == pytest.approx(0.5)
    assert hausdorff(p, q) == pytest.approx(0.5)


def test_device_twins_match_oracle():
    rng = np.random.default_rng(7)
    p = rng.normal(size=(9, 12, 3))
    q = rng.normal(size=(13, 12, 3))
    m = cross_rmsd(_t(p), _t(q))
    assert float(hausdorff_from_cross(m)) == pytest.approx(
        hausdorff(p, q), abs=1e-4)
    assert float(frechet_wavefront(m)) == pytest.approx(
        discrete_frechet(p, q), abs=1e-4)


@pytest.mark.parametrize("shape", [(1, 1), (1, 6), (6, 1), (7, 3),
                                   (3, 7), (40, 33), (64, 64)])
def test_wavefront_equals_host_recurrence(shape):
    """Exactly the host recurrence's value on the same (float32) cross
    matrix: every anti-diagonal step is a ``min`` of three neighbours
    and a ``max`` with the cell, never an arithmetic rounding."""
    rng = np.random.default_rng(sum(shape))
    m = torch.as_tensor(rng.uniform(0.0, 5.0, (5,) + shape),
                        dtype=torch.float32)
    got = frechet_wavefront(m)
    assert got.shape == (5,)
    for k in range(5):
        assert float(got[k]) == _frechet_np(m[k].numpy())


def test_wavefront_equals_host_on_path_cross_matrix():
    rng = np.random.default_rng(11)
    p = _t(np.cumsum(rng.normal(scale=0.3, size=(50, 20, 3)), axis=0))
    q = _t(np.cumsum(rng.normal(scale=0.3, size=(37, 20, 3)), axis=0))
    m = cross_rmsd(p, q)
    assert float(frechet_wavefront(m)) == _frechet_np(m.numpy())


def test_batched_pairs_equal_pair_by_pair():
    rng = np.random.default_rng(12)
    p = _t(rng.normal(size=(4, 10, 6, 3)))
    q = _t(rng.normal(size=(4, 8, 6, 3)))
    m = cross_rmsd(p, q)
    batch = frechet_wavefront(m)
    haus = hausdorff_from_cross(m)
    for k in range(4):
        one = cross_rmsd(p[k], q[k])
        assert float(batch[k]) == float(frechet_wavefront(one))
        assert float(haus[k]) == float(hausdorff_from_cross(one))


def test_psanalysis_end_to_end():
    """Three trajectories of one system: identical paths at distance 0,
    a perturbed one strictly farther; torch and serial backends agree."""
    u1 = make_protein_universe(n_residues=10, n_frames=6, noise=0.2,
                               seed=31)
    u2 = make_protein_universe(n_residues=10, n_frames=6, noise=0.2,
                               seed=31)          # identical
    u3 = make_protein_universe(n_residues=10, n_frames=8, noise=0.5,
                               seed=32)          # different
    psa = PSAnalysis([u1, u2, u3], select="name CA")
    d_dev = psa.run(metric="hausdorff", **TORCH).results.D
    assert d_dev.shape == (3, 3)
    assert np.allclose(np.diag(d_dev), 0.0)
    # identical paths: inside the documented f32 cancellation floor
    assert d_dev[0, 1] < 0.05
    assert d_dev[0, 2] > 0.1
    d_ser = PSAnalysis([u1, u2, u3], select="name CA").run(
        metric="hausdorff", backend="serial").results.D
    assert d_ser[0, 1] == pytest.approx(0.0, abs=1e-5)   # f64 oracle
    np.testing.assert_allclose(d_dev, d_ser, atol=0.05)
    # Fréchet run on the same paths
    d_f = PSAnalysis([u1, u2, u3], select="name CA").run(
        metric="discrete_frechet", backend="serial").results.D
    assert (d_f >= d_ser - 1e-9).all()
    d_fd = PSAnalysis([u1, u2, u3], select="name CA").run(
        metric="discrete_frechet", **TORCH).results.D
    np.testing.assert_allclose(d_fd, d_f, atol=0.05)
    # 'mesh' is the same single-device route (as in the JAX package)
    d_mesh = PSAnalysis([u1, u2, u3], select="name CA").run(
        metric="hausdorff", backend="mesh", device="cpu").results.D
    np.testing.assert_array_equal(d_mesh, d_dev)


def test_psa_alignment_removes_rigid_motion():
    """align=True: the same internal motion under different rigid-body
    tumbling collapses to ~zero path distance."""
    from mdanalysis_mpi_tpu_torch.testing import random_rotation_matrices

    rng = np.random.default_rng(33)
    p = np.cumsum(rng.normal(scale=0.2, size=(5, 12, 3)), axis=0) \
        + rng.normal(scale=4.0, size=(1, 12, 3))
    rots = random_rotation_matrices(5, rng)
    trans = rng.normal(scale=6.0, size=(5, 1, 3))
    q = np.einsum("tnj,tij->tni", p, rots) + trans   # rigidly tumbled p
    d = PSAnalysis([p, q], align=True).run(
        metric="hausdorff", backend="serial").results.D
    assert d[0, 1] == pytest.approx(0.0, abs=1e-6)
    d_raw = PSAnalysis([p, q], align=False).run(
        metric="hausdorff", backend="serial").results.D
    assert d_raw[0, 1] > 1.0


def test_psa_validation():
    u = make_protein_universe(n_residues=10, n_frames=4)
    with pytest.raises(ValueError, match="at least two"):
        PSAnalysis([u])
    v = make_protein_universe(n_residues=12, n_frames=4)
    with pytest.raises(ValueError, match="widths"):
        PSAnalysis([u, v], select="name CA")
    with pytest.raises(ValueError, match="metric"):
        PSAnalysis([u, u]).run(metric="euclidean")
    with pytest.raises(TypeError, match="path"):
        PSAnalysis([u, "not-a-path"])
    with pytest.raises(ValueError, match="\\(T, S, 3\\)"):
        PSAnalysis([u, np.zeros((4, 3))])


def test_backend_names():
    u = make_protein_universe(n_residues=4, n_frames=3)
    with pytest.raises(ValueError, match="backend='torch'"):
        PSAnalysis([u, u]).run(backend="jax")
    with pytest.raises(ValueError, match="backend must be"):
        PSAnalysis([u, u]).run(backend="gpu")


class TestAgainstJaxPackage:
    """The same seeded paths through the JAX package's ``'jax'`` route
    (a float32 matmul + nested scans) and the port's (a float32 matmul +
    the wavefront): each within the JAX package's 0.05 of the serial
    oracle, and of each other within 1e-4 (the two float32 cross
    matrices differ only in rounding)."""

    @pytest.mark.parametrize("metric", ["hausdorff", "discrete_frechet"])
    def test_matrix(self, metric):
        from mdanalysis_mpi_tpu.analysis.psa import PSAnalysis as JPSA

        rng = np.random.default_rng(40)
        paths = [np.cumsum(rng.normal(scale=0.3, size=(t, 15, 3)), axis=0)
                 for t in (20, 20, 27)]
        dj = JPSA(paths, align=True).run(metric=metric,
                                         backend="jax").results.D
        dt = PSAnalysis(paths, align=True).run(metric=metric,
                                               **TORCH).results.D
        ds = PSAnalysis(paths, align=True).run(
            metric=metric, backend="serial").results.D
        np.testing.assert_allclose(dt, dj, atol=1e-4)
        np.testing.assert_allclose(dt, ds, atol=0.05)
        # the host copies are the same code
        dsj = JPSA(paths, align=True).run(metric=metric,
                                          backend="serial").results.D
        np.testing.assert_array_equal(ds, dsj)

    def test_jax_scan_and_wavefront_agree(self):
        from mdanalysis_mpi_tpu.analysis.psa import _pair_fn
        import jax.numpy as jnp

        rng = np.random.default_rng(41)
        p = rng.normal(size=(17, 10, 3))
        q = rng.normal(size=(23, 10, 3))
        j = float(_pair_fn("discrete_frechet")(jnp.asarray(p, jnp.float32),
                                               jnp.asarray(q, jnp.float32)))
        t = float(frechet_wavefront(cross_rmsd(_t(p), _t(q))))
        assert t == pytest.approx(j, abs=1e-5)
