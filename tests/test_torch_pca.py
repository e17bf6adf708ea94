"""The port's PCA (``analysis/pca.py``): the JAX package's
tests/test_pca.py case by case on ``backend="torch", device="cpu"`` and
a two-shard CPU mesh (their tolerances: the covariance within 1e-3 of
its largest entry, variances within 2e-2 relative and 1e-3 of the top
variance; 5e-2 aligned), and the same seeded frames through the JAX
package's ``backend="jax"`` and the port, with and without alignment:
variances within the same bounds, components equal up to sign on the
spectrally isolated leading modes (within 1e-2), and ``transform``'s
projections within 1e-2 of the top standard deviation."""

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu_torch.analysis import PCA
from mdanalysis_mpi_tpu_torch.core.topology import make_protein_topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

#: the port's batch backends on the CPU: ``'torch'`` on one device and
#: the mesh over two CPU shards (the JAX package's ``'jax'`` and
#: ``'mesh'``)
TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)
BK = {"jax": TORCH, "torch": TORCH, "mesh": MESH,
      "serial": dict(backend="serial")}


def _linear_universe(n_frames=40, n_atoms=12, seed=1):
    """Base structure breathing along one known direction + tiny noise:
    the first PC must recover that direction."""
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=4.0, size=(n_atoms, 3)).astype(np.float64)
    direction = rng.normal(size=(n_atoms, 3))
    direction /= np.linalg.norm(direction)
    amp = rng.normal(scale=3.0, size=n_frames)
    frames = (base[None] + amp[:, None, None] * direction[None]
              + rng.normal(scale=0.01, size=(n_frames, n_atoms, 3)))
    top = make_protein_topology(max(1, n_atoms // 4))
    top = top.subset(np.arange(n_atoms)) if top.n_atoms > n_atoms else top
    frames = frames[:, : top.n_atoms]
    return (Universe(top, MemoryReader(frames.astype(np.float32))),
            direction[: top.n_atoms].reshape(-1))


class TestPCA:
    def test_serial_vs_jax_parity(self):
        u = make_protein_universe(n_residues=5, n_frames=32)
        s = PCA(u, select="name CA").run(backend="serial")
        j = PCA(u, select="name CA").run(**TORCH, batch_size=8)
        np.testing.assert_allclose(
            np.asarray(j.results.cov), s.results.cov,
            atol=1e-3 * float(np.abs(s.results.cov).max()))
        np.testing.assert_allclose(
            np.asarray(j.results.variance), s.results.variance,
            rtol=2e-2, atol=1e-3 * float(s.results.variance[0]))
        np.testing.assert_allclose(
            np.asarray(j.results.mean), s.results.mean, atol=1e-3)

    def test_mesh_backend_parity(self):
        u = make_protein_universe(n_residues=4, n_frames=24)
        s = PCA(u, select="name CA").run(backend="serial")
        m = PCA(u, select="name CA").run(**MESH, batch_size=8)
        np.testing.assert_allclose(
            np.asarray(m.results.variance), s.results.variance,
            rtol=2e-2, atol=1e-3 * float(s.results.variance[0]))

    def test_recovers_known_direction(self):
        u, direction = _linear_universe()
        p = PCA(u).run(backend="serial")
        # dominant mode explains almost all variance
        frac = float(p.results.variance[0] / p.results.variance.sum())
        assert frac > 0.98, frac
        # and points along the planted direction (up to sign)
        overlap = abs(float(p.results.p_components[:, 0] @ direction))
        assert overlap > 0.99, overlap

    def test_align_removes_rigid_body_variance(self):
        """Rigid tumbling of a frozen structure: without alignment the
        apparent variance is large; with align=True it collapses."""
        u_t = make_protein_universe(n_residues=5, n_frames=24, noise=0.0,
                                    rigid_motion=True)
        raw = PCA(u_t, select="name CA").run(backend="serial")
        ali = PCA(u_t, select="name CA", align=True).run(backend="serial")
        assert float(ali.results.variance[0]) < 1e-6 * float(
            raw.results.variance[0])

    def test_align_parity_serial_vs_jax(self):
        u = make_protein_universe(n_residues=5, n_frames=32, noise=0.3)
        s = PCA(u, select="name CA", align=True).run(backend="serial")
        j = PCA(u, select="name CA", align=True).run(
            **TORCH, batch_size=8)
        np.testing.assert_allclose(
            np.asarray(j.results.variance), s.results.variance,
            rtol=5e-2, atol=1e-3 * float(s.results.variance[0]))

    def test_rerun_recomputes_aligned_reference(self):
        """A second run() over a different window must not reuse the
        first window's cached host reference (ADVICE r3: stale
        _ref_np survived _prepare)."""
        u = make_protein_universe(n_residues=5, n_frames=24, noise=0.3)
        p = PCA(u, select="name CA", align=True)
        p.run(stop=8, backend="serial")        # caches ref of frames [0,8)
        again = p.run(backend="serial")        # full window: new reference
        fresh = PCA(u, select="name CA", align=True).run(backend="serial")
        np.testing.assert_allclose(np.asarray(again.results.cov),
                                   np.asarray(fresh.results.cov),
                                   rtol=1e-12, atol=1e-12)

    def test_transform_variances_match_eigenvalues(self):
        u = make_protein_universe(n_residues=5, n_frames=64, noise=0.4)
        p = PCA(u, select="name CA", n_components=4).run(backend="serial")
        proj = p.transform(u.select_atoms("name CA"), batch_size=16,
                           device="cpu")
        assert proj.shape == (64, 4)
        # projection variance along PC i = eigenvalue i (ddof=1)
        got = proj.var(axis=0, ddof=1)
        np.testing.assert_allclose(got, p.results.variance[:4], rtol=5e-2)

    def test_transform_guards(self):
        u = make_protein_universe(n_residues=4, n_frames=8)
        p = PCA(u, select="name CA")
        with pytest.raises(RuntimeError, match="run"):
            p.transform(u.select_atoms("name CA"), device="cpu")
        p.run(backend="serial")
        with pytest.raises(ValueError, match="atoms"):
            p.transform(u.select_atoms("all"), device="cpu")

    def test_size_guard_and_min_frames(self):
        u = make_protein_universe(n_residues=4, n_frames=8)
        with pytest.raises(ValueError, match="at least 2"):
            PCA(u, select="name CA").run(stop=1, backend="serial")
        top = make_protein_topology(3000)
        big = Universe(
            top, MemoryReader(np.zeros((2, top.n_atoms, 3), np.float32)))
        with pytest.raises(ValueError, match="covariance"):
            PCA(big).run(backend="serial")

    def test_n_components_truncates(self):
        u = make_protein_universe(n_residues=5, n_frames=16)
        p = PCA(u, select="name CA", n_components=3).run(backend="serial")
        assert p.results.p_components.shape[1] == 3
        assert len(p.results.variance) == 3
        assert p.results.cumulated_variance[-1] <= 1.0 + 1e-9


def test_cosine_content():
    """Analytic: a pure cosine projection has content ~1; white noise
    ~0; validation errors are loud."""
    from mdanalysis_mpi_tpu_torch.analysis import cosine_content

    t = np.arange(500)
    p = np.stack([np.cos(np.pi * 1 * t / 500),
                  np.cos(np.pi * 2 * t / 500)], axis=1)
    assert cosine_content(p, 0) == pytest.approx(1.0, abs=1e-2)
    assert cosine_content(p, 1) == pytest.approx(1.0, abs=1e-2)
    # the WRONG mode index scores low (orthogonal cosines)
    swapped = p[:, ::-1]
    assert cosine_content(swapped, 0) < 0.05
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(2000, 1))
    assert cosine_content(noise, 0) < 0.1
    with pytest.raises(IndexError):
        cosine_content(p, 5)
    with pytest.raises(ValueError, match="n_components"):
        cosine_content(np.zeros(5), 0)
    assert cosine_content(np.zeros((4, 1)), 0) == 0.0


# ---------------- against the JAX package ----------------

jax = pytest.importorskip("jax")

from mdanalysis_mpi_tpu.analysis import PCA as JPCA  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

torch.set_num_threads(1)


def _leading_isolated(var, k):
    """Indices of the first ``k`` modes whose variance is separated from
    both neighbours by more than 5% (their eigenvectors are unique up
    to sign)."""
    gaps = np.abs(np.diff(var)) / var[0]
    out = []
    for i in range(min(k, len(var) - 1)):
        left = gaps[i - 1] if i else np.inf
        if min(left, gaps[i]) > 0.05:
            out.append(i)
    return out


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_port_matches_jax_package(align, backend):
    kw = dict(n_residues=6, n_frames=40, noise=0.4, seed=4)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    p = PCA(u, select="name CA", align=align, n_components=6).run(
        **BK[backend], batch_size=8)
    j = JPCA(ju, select="name CA", align=align, n_components=6).run(
        backend="jax", batch_size=8)
    jv = np.asarray(j.results.variance)
    rtol = 5e-2 if align else 2e-2
    np.testing.assert_allclose(p.results.variance, jv, rtol=rtol,
                               atol=1e-3 * float(jv[0]))
    np.testing.assert_allclose(p.results.mean, np.asarray(j.results.mean),
                               atol=1e-3)
    pc, jc = p.results.p_components, np.asarray(j.results.p_components)
    for i in _leading_isolated(jv, 3):
        sign = np.sign(pc[:, i] @ jc[:, i])
        np.testing.assert_allclose(pc[:, i] * sign, jc[:, i], atol=1e-2)


def test_transform_matches_jax_package():
    kw = dict(n_residues=5, n_frames=32, noise=0.4, seed=6)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    p = PCA(u, select="name CA", n_components=3).run(backend="serial")
    j = JPCA(ju, select="name CA", n_components=3).run(backend="serial")
    got = p.transform(u.select_atoms("name CA"), batch_size=8, device="cpu")
    want = j.transform(ju.select_atoms("name CA"), batch_size=8)
    assert got.dtype == np.float32 and got.shape == (32, 3)
    # serial float64 fits agree to round-off; the float32 projections
    # carry each package's sign of each component
    sign = np.sign((got * want).sum(axis=0))
    np.testing.assert_allclose(got * sign, want,
                               atol=1e-2 * float(want.std(axis=0).max()))


def test_device_results_stay_deferred_until_read():
    """``run()`` leaves the eigendecomposition to the first read: the
    results are Deferreds over the device partials."""
    from mdanalysis_mpi_tpu_torch.analysis.base import Deferred

    u = make_protein_universe(n_residues=4, n_frames=12, seed=2)
    p = PCA(u, select="name CA").run(**TORCH, batch_size=4)
    assert isinstance(p.results["variance"], Deferred)
    assert isinstance(p._last_total[2], torch.Tensor)
    s = PCA(u, select="name CA").run(backend="serial")
    np.testing.assert_allclose(p.results.variance, s.results.variance,
                               rtol=2e-2, atol=1e-3 * s.results.variance[0])


def test_default_backend_is_torch():
    """The port's PCA takes ``'torch'`` when no backend is named (on
    ``cuda``, which a machine without a GPU does not have)."""
    u = make_protein_universe(n_residues=4, n_frames=8, seed=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCA(u, select="name CA").run()
