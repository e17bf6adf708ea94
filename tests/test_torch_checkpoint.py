"""State carried across the packages: a checkpoint one package writes,
the other resumes (``utils/checkpoint.py``: the same npz layout, leaf
order, digest stamp and fingerprint), and the QCP Kabsch solve the port
runs on the device against the JAX package's SVD Kabsch.

The crash-then-resume cases follow the JAX suite's
``test_crash_then_resume_matches_uninterrupted`` (tests/test_reliability
.py): a resilient run crashes on a kernel dispatch after two durable
16-frame chunks, a new run in the OTHER package resumes from the file,
skips the durable chunks and matches the uninterrupted run within the
suite's 1e-3 Å.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu import analysis as jax_analysis
from mdanalysis_mpi_tpu import testing as jax_testing
from mdanalysis_mpi_tpu.ops import align as jalign
from mdanalysis_mpi_tpu.reliability import faults as jax_faults
from mdanalysis_mpi_tpu.reliability.policy import (
    ReliabilityPolicy as JaxPolicy)
from mdanalysis_mpi_tpu_torch import analysis as port_analysis
from mdanalysis_mpi_tpu_torch.analysis import PCA, RMSF, AlignedRMSF
from mdanalysis_mpi_tpu_torch.ops import align as talign
from mdanalysis_mpi_tpu_torch.reliability import faults
from mdanalysis_mpi_tpu_torch.reliability.policy import ReliabilityPolicy
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
from mdanalysis_mpi_tpu_torch.utils import checkpoint as ckpt

KW = dict(n_residues=8, n_frames=64, noise=0.25, seed=11)


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    faults.clear()
    jax_faults.clear()


def _ckpts(d):
    return glob.glob(os.path.join(str(d), "mdtpu-ckpt-*"))


def _crash_jax(tmp_path, make):
    """The JAX package's resilient run, crashed on its 6th dispatch."""
    pol = JaxPolicy(backoff_s=0.001, checkpoint_every=16,
                    checkpoint_dir=str(tmp_path))
    crash = jax_faults.FaultSpec("kernel", "raise", after=5, times=1,
                                 exc=jax_faults.InjectedCrash)
    with jax_faults.inject(crash):
        with pytest.raises(jax_faults.InjectedCrash):
            make(jax_testing.make_protein_universe(**KW)).run(
                resilient=pol, backend="jax", batch_size=8)


def _crash_port(tmp_path, make):
    """The port's resilient run, crashed on its 6th dispatch."""
    pol = ReliabilityPolicy(backoff_s=0.001, checkpoint_every=16,
                            checkpoint_dir=str(tmp_path))
    crash = faults.FaultSpec("kernel", "raise", after=5, times=1,
                             exc=faults.InjectedCrash)
    with faults.inject(crash):
        with pytest.raises(faults.InjectedCrash):
            make(make_protein_universe(**KW)).run(
                resilient=pol, backend="torch", device="cpu", batch_size=8)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    _crash_jax(tmp_path, lambda u: jax_analysis.RMSF(
        u.select_atoms("name CA")))
    (path,) = _ckpts(tmp_path)
    with np.load(path) as z:
        assert int(z["frames_done"]) == 32
    u = make_protein_universe(**KW)
    oracle = RMSF(u.select_atoms("name CA")).run(backend="serial")
    pol = ReliabilityPolicy(backoff_s=0.001, checkpoint_every=16,
                            checkpoint_dir=str(tmp_path))
    counter = faults.FaultSpec("kernel", "raise", times=0)
    with faults.inject(counter):
        r = RMSF(u.select_atoms("name CA")).run(
            resilient=pol, backend="torch", device="cpu", batch_size=8)
    assert counter.visits == 4            # frames 32..64 only
    np.testing.assert_allclose(r.results.rmsf, oracle.results.rmsf,
                               atol=1e-3)
    assert not _ckpts(tmp_path)


def test_port_checkpoint_resumes_in_the_jax_package(tmp_path):
    _crash_port(tmp_path, lambda u: RMSF(u.select_atoms("name CA")))
    (path,) = _ckpts(tmp_path)
    with np.load(path) as z:
        assert int(z["frames_done"]) == 32
        assert sorted(z.files) == ["__mdtpu_digest__", "dropped",
                                   "fingerprint", "frames_done", "leaf_0",
                                   "leaf_1", "leaf_2"]
    ju = jax_testing.make_protein_universe(**KW)
    oracle = jax_analysis.RMSF(ju.select_atoms("name CA")).run(
        backend="serial")
    pol = JaxPolicy(backoff_s=0.001, checkpoint_every=16,
                    checkpoint_dir=str(tmp_path))
    counter = jax_faults.FaultSpec("kernel", "raise", times=0)
    with jax_faults.inject(counter):
        r = jax_analysis.RMSF(ju.select_atoms("name CA")).run(
            resilient=pol, backend="jax", batch_size=8)
    assert counter.visits == 4
    np.testing.assert_allclose(np.asarray(r.results.rmsf),
                               oracle.results.rmsf, atol=1e-3)
    assert not _ckpts(tmp_path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_two_pass_checkpoint_crosses_packages(writer, tmp_path):
    """AlignedRMSF's two pass files: a crash in pass 2 leaves pass 1's
    completed summary and pass 2's partial file; the other package
    resumes both and matches the serial oracle."""
    td = str(tmp_path)
    kw = dict(chunk_frames=16, batch_size=8, checkpoint_dir=td, scan_k=2)
    calls = {"n": 0}
    jax_ckpt = __import__("mdanalysis_mpi_tpu.utils.checkpoint",
                          fromlist=["_save"])
    mod = jax_ckpt if writer == "jax" else ckpt
    real_save = mod._save

    def crashing_save(p, done, partials, fp, dropped=()):
        real_save(p, done, partials, fp, dropped)
        calls["n"] += 1
        if calls["n"] == 6:       # 4 pass-1 chunks, then pass 2's 2nd
            raise RuntimeError("simulated crash")

    mod._save = crashing_save
    try:
        with pytest.raises(RuntimeError):
            if writer == "jax":
                jax_ckpt.run_checkpointed(
                    jax_analysis.AlignedRMSF(
                        jax_testing.make_protein_universe(**KW),
                        select="name CA"), backend="jax", **kw)
            else:
                ckpt.run_checkpointed(
                    AlignedRMSF(make_protein_universe(**KW),
                                select="name CA"),
                    backend="torch", device="cpu", **kw)
    finally:
        mod._save = real_save
    assert len(os.listdir(td)) == 2
    u = make_protein_universe(**KW)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    if writer == "jax":
        a = AlignedRMSF(u, select="name CA")
        ckpt.run_checkpointed(a, backend="torch", device="cpu", **kw)
        got = a.results.rmsf
    else:
        a = jax_analysis.AlignedRMSF(jax_testing.make_protein_universe(**KW),
                                     select="name CA")
        jax_ckpt.run_checkpointed(a, backend="jax", **kw)
        got = np.asarray(a.results.rmsf)
    np.testing.assert_allclose(got, s.results.rmsf, atol=1e-3)
    assert not os.listdir(td)


def _pca(pkg, u):
    cls = jax_analysis.PCA if pkg == "jax" else PCA
    return cls(u, select="name CA", n_components=4)


def _collection(pkg, u):
    a = jax_analysis if pkg == "jax" else port_analysis
    return a.AnalysisCollection(
        a.RMSF(u.select_atoms("name CA")),
        a.AverageStructure(u, select="name CB", select_only=True))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                      else x)


@pytest.mark.parametrize("kind", ["pca", "collection"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reduction_checkpoint_crosses_packages(kind, writer, tmp_path):
    """``PCA(align=False)`` (partials T, Σx, Σxᵀx) and an all-reduction
    ``AnalysisCollection`` (its children's partials, nested): one
    package's checkpoint after two 16-frame chunks resumes in the other,
    which runs only the last two chunks (the fingerprint, hashing the
    class name and the collection's union selection, is the same) and
    matches the serial oracle (PCA: variances within test_pca.py's 2e-2
    relative and 1e-3 of the top; the collection's children within
    1e-3)."""
    make = _pca if kind == "pca" else _collection
    td = str(tmp_path)
    kw = dict(chunk_frames=16, batch_size=8, checkpoint_dir=td)
    jax_ckpt = __import__("mdanalysis_mpi_tpu.utils.checkpoint",
                          fromlist=["_save"])
    w_mod, r_mod = (jax_ckpt, ckpt) if writer == "jax" else (ckpt, jax_ckpt)
    real_save = w_mod._save
    calls = {"n": 0}

    def crashing_save(p, done, partials, fp, dropped=()):
        real_save(p, done, partials, fp, dropped)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")

    w_mod._save = crashing_save
    try:
        with pytest.raises(RuntimeError):
            if writer == "jax":
                jax_ckpt.run_checkpointed(
                    make("jax", jax_testing.make_protein_universe(**KW)),
                    backend="jax", **kw)
            else:
                ckpt.run_checkpointed(
                    make("port", make_protein_universe(**KW)),
                    backend="torch", device="cpu", **kw)
    finally:
        w_mod._save = real_save
    (path,) = _ckpts(tmp_path)
    with np.load(path) as z:
        assert int(z["frames_done"]) == 32
    resumed = []
    r_save = r_mod._save

    def recording_save(p, done, partials, fp, dropped=()):
        resumed.append(done)
        return r_save(p, done, partials, fp, dropped)

    r_mod._save = recording_save
    try:
        if writer == "jax":
            a = make("port", make_protein_universe(**KW))
            ckpt.run_checkpointed(a, backend="torch", device="cpu", **kw)
        else:
            a = make("jax", jax_testing.make_protein_universe(**KW))
            jax_ckpt.run_checkpointed(a, backend="jax", **kw)
    finally:
        r_mod._save = r_save
    assert resumed == [48, 64]
    assert not os.listdir(td)
    s = make("port", make_protein_universe(**KW)).run(backend="serial")
    if kind == "pca":
        want = s.results.variance
        np.testing.assert_allclose(_np(a.results.variance), want,
                                   rtol=2e-2, atol=1e-3 * float(want[0]))
    else:
        np.testing.assert_allclose(_np(a.analyses[0].results.rmsf),
                                   s.analyses[0].results.rmsf, atol=1e-3)
        np.testing.assert_allclose(_np(a.analyses[1].results.positions),
                                   _np(s.analyses[1].results.positions),
                                   atol=1e-3)


def test_checkpoint_leaves_round_trip(tmp_path):
    """``_save``/``_load`` keep the partials' structure and values: a
    None is no leaf, tuples nest depth first."""
    part = (torch.tensor(3.0), (torch.arange(6.0).reshape(2, 3), None),
            torch.ones(2))
    path = str(tmp_path / "c.npz")
    ckpt._save(path, 7, part, "fp", dropped=[4])
    done, got, dropped = ckpt._load(path, part, "fp")
    assert done == 7 and list(dropped) == [4]
    assert got[1][1] is None
    for a, b in ((got[0], part[0]), (got[1][0], part[1][0]),
                 (got[2], part[2])):
        np.testing.assert_array_equal(a, b.numpy())
    with pytest.raises(ValueError, match="different"):
        ckpt._load(path, part, "other")


# ---- the QCP Kabsch solve against the JAX package's SVD Kabsch ----

def _rot_svd_jax(H):
    return np.asarray(jalign.kabsch_from_correlation(jnp.asarray(H)))


@pytest.mark.parametrize("seed", range(6))
def test_qcp_kabsch_matches_jax_svd_on_random_correlations(seed):
    H = np.random.default_rng(seed).normal(size=(64, 3, 3)).astype(
        np.float32)
    R = talign.kabsch_from_correlation(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(R, _rot_svd_jax(H), atol=1e-5)
    np.testing.assert_allclose(
        talign.kabsch_from_correlation_svd(torch.from_numpy(H)).numpy(),
        _rot_svd_jax(H), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def _objective(R, H):
    """tr(Rᵀ H) = Σ (mobile @ R) · ref: what both solves maximise."""
    return np.einsum("bij,bij->b", R, H)


@pytest.mark.parametrize("kind", ["zero", "collinear", "coplanar"])
def test_qcp_kabsch_on_degenerate_correlations(kind):
    """Degenerate frames.  A zero correlation: both solves return the
    identity.  Coplanar atoms (rank-2 H): the optimal rotation is still
    unique, and the solves agree on it.  Collinear atoms (rank-1 H):
    every rotation about the line is optimal, so the solves may return
    different ones — they agree on the objective they maximise, and on
    the aligned coordinates of the atoms themselves."""
    rng = np.random.default_rng(7)
    n, B = 12, 16
    if kind == "zero":
        H = np.zeros((B, 3, 3), np.float32)
        R = talign.kabsch_from_correlation(torch.from_numpy(H)).numpy()
        np.testing.assert_array_equal(R, np.broadcast_to(np.eye(3), R.shape))
        np.testing.assert_array_equal(_rot_svd_jax(H), R)
        return
    if kind == "collinear":
        ref = np.outer(np.linspace(-5, 5, n), rng.normal(size=3))
    else:
        ref = rng.normal(size=(n, 2)) @ rng.normal(size=(2, 3)) * 3
    ref = (ref - ref.mean(0)).astype(np.float32)
    mobs = []
    for _ in range(B):
        U, _, Vt = np.linalg.svd(rng.normal(size=(3, 3)))
        if np.linalg.det(U @ Vt) < 0:
            U[:, -1] *= -1
        mobs.append(ref @ (U @ Vt).T + rng.normal(size=(n, 3)) * 1e-3
                    * (kind == "coplanar"))
    mob = np.asarray(mobs, np.float32)
    H = np.einsum("bni,nj->bij", mob, ref).astype(np.float32)
    R = talign.kabsch_from_correlation(torch.from_numpy(H)).numpy()
    Rj = _rot_svd_jax(H)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    scale = np.abs(H).max()
    np.testing.assert_allclose(_objective(R, H) / scale,
                               _objective(Rj, H) / scale, atol=1e-5)
    aligned = np.einsum("bni,bij->bnj", mob, R)
    aligned_j = np.einsum("bni,bij->bnj", mob, Rj)
    np.testing.assert_allclose(aligned, aligned_j, atol=1e-5)
    if kind == "coplanar":
        np.testing.assert_allclose(R, Rj, atol=1e-5)
