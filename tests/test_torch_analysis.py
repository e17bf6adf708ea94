"""Twin of ``tests/test_analysis.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Analysis-layer tests: the executable version of the reference's
"SAME AS" differential strategy (SURVEY.md §4) — serial NumPy oracle vs
JAX single-device vs 8-device mesh must agree on identical synthetic
trajectories, plus analytic oracles (rigid motion → RMSF 0)."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import (
    RMSD, RMSF, AlignedRMSF, AlignTraj, AverageStructure,
)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    mesh_kw, port_runs_on_the_cpu)


BACKENDS = ["serial", "torch", "mesh"]


@pytest.fixture(scope="module")
def uni():
    return make_protein_universe(n_residues=12, n_frames=30, noise=0.25, seed=3)


# ---------------- AverageStructure ----------------

def test_average_structure_backends_agree(uni):
    results = {}
    for b in BACKENDS:
        avg = AverageStructure(uni, select="protein and name CA").run(
            **mesh_kw(b), batch_size=8)
        results[b] = avg.results.positions
    np.testing.assert_allclose(results["torch"], results["serial"], atol=2e-4)
    np.testing.assert_allclose(results["mesh"], results["serial"], atol=2e-4)


def test_average_structure_universe_rebuild(uni):
    avg = AverageStructure(uni, select="protein and name CA").run(backend="torch")
    u2 = avg.results.universe
    assert u2.trajectory.n_frames == 1        # RMSF.py:113 analog
    assert u2.topology is uni.topology
    np.testing.assert_allclose(u2.atoms.positions, avg.results.positions,
                               atol=1e-3)


def test_average_structure_select_only_matches_wide(uni):
    wide = AverageStructure(uni, select="protein and name CA").run(backend="torch")
    lean = AverageStructure(uni, select="protein and name CA",
                            select_only=True).run(backend="torch")
    idx = uni.select_atoms("protein and name CA").indices
    np.testing.assert_allclose(lean.results.positions,
                               wide.results.positions[idx], atol=2e-4)


# ---------------- RMSF ----------------

def test_rmsf_rigid_motion_is_zero():
    """Analytic oracle: pure rigid motion + alignment → RMSF ≈ 0."""
    u = make_protein_universe(n_residues=10, n_frames=12, noise=0.0)
    r = AlignedRMSF(u, select="protein and name CA").run(backend="serial")
    np.testing.assert_allclose(r.results.rmsf, 0.0, atol=1e-6)
    r_jax = AlignedRMSF(u, select="protein and name CA").run(
        backend="torch", batch_size=5)
    np.testing.assert_allclose(r_jax.results.rmsf, 0.0, atol=1e-3)


def test_aligned_rmsf_backends_agree(uni):
    res = {b: AlignedRMSF(uni, select="protein and name CA").run(
        **mesh_kw(b), batch_size=7).results.rmsf for b in BACKENDS}
    np.testing.assert_allclose(res["torch"], res["serial"], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(res["mesh"], res["serial"], rtol=5e-3, atol=1e-4)


def test_aligned_rmsf_statistical_magnitude():
    """Noise sigma=0.3 → RMSF ≈ sqrt(3)*0.3 within sampling error."""
    u = make_protein_universe(n_residues=20, n_frames=200, noise=0.3, seed=7)
    r = AlignedRMSF(u, select="protein and name CA").run(
        backend="torch", batch_size=64)
    expected = np.sqrt(3) * 0.3
    assert abs(np.median(r.results.rmsf) - expected) < 0.1 * expected


def test_stock_rmsf_pipeline_oracle(uni):
    """The docstring oracle (RMSF.py:1-18): AverageStructure → AlignTraj
    → RMSF equals AlignedRMSF."""
    u = make_protein_universe(n_residues=8, n_frames=20, noise=0.2, seed=11)
    sel = "protein and name CA"
    one_shot = AlignedRMSF(u, select=sel).run(backend="serial")

    u2 = make_protein_universe(n_residues=8, n_frames=20, noise=0.2, seed=11)
    avg = AverageStructure(u2, select=sel).run(backend="serial")
    AlignTraj(u2, avg.results.universe, select=sel).run(backend="serial")
    stock = RMSF(u2.select_atoms(sel)).run(backend="serial")
    np.testing.assert_allclose(stock.results.rmsf, one_shot.results.rmsf,
                               rtol=1e-6, atol=1e-9)


def test_rmsf_frame_slicing(uni):
    sub = AlignedRMSF(uni, select="name CA").run(
        start=4, stop=24, step=2, backend="torch", batch_size=4)
    assert sub.n_frames == 10
    serial = AlignedRMSF(uni, select="name CA").run(
        start=4, stop=24, step=2, backend="serial")
    np.testing.assert_allclose(sub.results.rmsf, serial.results.rmsf,
                               rtol=5e-3, atol=1e-4)


def test_rmsf_short_trajectory_more_devices_than_frames():
    """Quirk Q2: the reference ZeroDivisionErrors when ranks > frames;
    the mesh backend must handle 3 frames over 8 devices."""
    u = make_protein_universe(n_residues=5, n_frames=3, noise=0.1)
    r = AlignedRMSF(u, select="name CA").run(**mesh_kw("mesh"), batch_size=2)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    np.testing.assert_allclose(r.results.rmsf, s.results.rmsf,
                               rtol=5e-3, atol=1e-5)


# ---------------- RMSD ----------------

def test_rmsd_backends_agree(uni):
    res = {b: RMSD(uni, select="protein and name CA").run(
        **mesh_kw(b), batch_size=8).results.rmsd for b in BACKENDS}
    assert res["serial"].shape == (30,)
    np.testing.assert_allclose(res["torch"], res["serial"], rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(res["mesh"], res["serial"], rtol=1e-3, atol=2e-4)


def test_rmsd_superposition_removes_rigid_motion():
    u = make_protein_universe(n_residues=10, n_frames=8, noise=0.0)
    fitted = RMSD(u, select="name CA", superposition=True).run(backend="torch")
    raw = RMSD(u, select="name CA", superposition=False).run(backend="torch")
    np.testing.assert_allclose(fitted.results.rmsd, 0.0, atol=1e-3)
    assert raw.results.rmsd[1:].min() > 1.0
    assert raw.results.rmsd[0] == pytest.approx(0.0, abs=1e-4)


def test_rmsd_mass_weighted(uni):
    mw = RMSD(uni, select="name CA C N", weights="mass").run(backend="torch")
    uw = RMSD(uni, select="name CA C N").run(backend="torch")
    assert mw.results.rmsd.shape == uw.results.rmsd.shape
    assert not np.allclose(mw.results.rmsd[1:], uw.results.rmsd[1:])


def test_int16_transfer_accuracy(uni):
    """Quantized staging must stay within its documented resolution
    (~max|x|/32000 per coordinate) of the exact f32 path."""
    exact = AlignedRMSF(uni, select="protein and name CA").run(
        backend="torch", batch_size=8).results.rmsf
    quant = AlignedRMSF(uni, select="protein and name CA").run(
        backend="torch", batch_size=8, transfer_dtype="int16").results.rmsf
    coord_range = np.abs(uni.trajectory.coordinates).max()
    assert np.abs(quant - exact).max() < 5 * coord_range / 32000
    # mesh path too
    qm = AlignedRMSF(uni, select="protein and name CA").run(
        **mesh_kw("mesh"), batch_size=4, transfer_dtype="int16").results.rmsf
    assert np.abs(qm - exact).max() < 5 * coord_range / 32000


def test_bad_transfer_dtype(uni):
    with pytest.raises(ValueError, match="transfer_dtype"):
        AlignedRMSF(uni, select="name CA").run(backend="torch",
                                               transfer_dtype="int4")


def test_rmsd_atomgroup_select_refines_within_group(uni):
    """RMSD(group, select=...) must stay restricted to the group."""
    half = uni.atoms[: uni.topology.n_atoms // 2]
    r = RMSD(half, select="name CA")
    r._prepare()
    assert set(r._idx).issubset(set(half.indices))
    assert len(r._idx) < len(uni.select_atoms("name CA").indices)


def test_aligntraj_preserves_per_frame_boxes():
    u = make_protein_universe(n_residues=4, n_frames=6, noise=0.1, box=30.0)
    # give each frame a distinct box
    u.trajectory._dims[:, 0] = 30.0 + np.arange(6)
    expected = u.trajectory._dims.copy()
    AlignTraj(u, select="name CA").run(backend="torch", batch_size=4)
    for i in range(6):
        np.testing.assert_array_equal(u.trajectory[i].dimensions, expected[i])


def test_rmsd_atomgroup_input(uni):
    ag = uni.select_atoms("name CA")
    r = RMSD(ag).run(backend="serial")
    r2 = RMSD(uni, select="name CA").run(backend="serial")
    np.testing.assert_allclose(r.results.rmsd, r2.results.rmsd)


# ---------------- AlignTraj ----------------

def test_aligntraj_in_memory(uni):
    u = make_protein_universe(n_residues=6, n_frames=10, noise=0.1, seed=5)
    ref_frame0 = u.trajectory[0].positions.copy()
    AlignTraj(u, select="name CA").run(backend="torch", batch_size=4)
    # after alignment every frame should be close to frame 0 (noise only)
    assert u.trajectory.n_frames == 10
    for i in range(10):
        d = np.linalg.norm(u.trajectory[i].positions - ref_frame0, axis=1).mean()
        assert d < 1.0, f"frame {i} misaligned (mean dev {d})"


def test_aligntraj_serial_jax_agree():
    u1 = make_protein_universe(n_residues=6, n_frames=9, noise=0.2, seed=9)
    u2 = make_protein_universe(n_residues=6, n_frames=9, noise=0.2, seed=9)
    AlignTraj(u1, select="name CA").run(backend="serial")
    AlignTraj(u2, select="name CA").run(backend="torch", batch_size=4)
    for i in range(9):
        np.testing.assert_allclose(u1.trajectory[i].positions,
                                   u2.trajectory[i].positions, atol=2e-3)


# ---------------- error paths ----------------

def test_empty_selection_raises(uni):
    with pytest.raises(ValueError, match="matched no atoms"):
        AverageStructure(uni, select="resname XXX").run()


def test_unknown_backend(uni):
    with pytest.raises(ValueError, match="unknown backend"):
        RMSD(uni, select="name CA").run(backend="cuda")


def test_results_lazy_materialization():
    """run() must stay readback-free on device paths: Deferred thunks and
    device arrays materialize (and cache) on attribute access only; raw
    dict indexing returns the stored value untouched.  The port's
    device arrays are torch tensors."""
    import torch

    from mdanalysis_mpi_tpu_torch.analysis.base import Deferred, Results

    calls = []
    r = Results()
    r.lazy_val = Deferred(lambda: calls.append(1) or np.arange(3))
    assert isinstance(r["lazy_val"], Deferred)       # raw access: untouched
    np.testing.assert_array_equal(r.lazy_val, np.arange(3))
    np.testing.assert_array_equal(r.lazy_val, np.arange(3))
    assert calls == [1]                              # evaluated exactly once

    r.dev = torch.ones(4)
    out = r.dev
    assert isinstance(out, np.ndarray)
    assert isinstance(r["dev"], np.ndarray)          # cached back

    # nested: a Deferred returning a device array materializes fully
    r.nested = Deferred(lambda: torch.zeros(2))
    assert isinstance(r.nested, np.ndarray)


class TestRadiusOfGyration:
    def test_backends_agree(self):
        from mdanalysis_mpi_tpu_torch.analysis import RadiusOfGyration
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=12, n_frames=9, seed=7)
        ag = u.select_atoms("protein")
        s = RadiusOfGyration(ag).run(backend="serial")
        j = RadiusOfGyration(ag).run(backend="torch", batch_size=4)
        m = RadiusOfGyration(ag).run(**mesh_kw("mesh"), batch_size=2)
        assert len(s.results.rgyr) == 9
        np.testing.assert_allclose(j.results.rgyr, s.results.rgyr, rtol=1e-5)
        np.testing.assert_allclose(m.results.rgyr, s.results.rgyr, rtol=1e-5)

    def test_hand_computed(self):
        """Two atoms (masses 1 and 3) 4 A apart -> Rg = sqrt(3); second
        frame scaled x2 -> 2*sqrt(3)."""
        from mdanalysis_mpi_tpu_torch.analysis import RadiusOfGyration
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe

        top = Topology(names=np.array(["X1", "X2"]),
                       resnames=np.array(["AAA", "AAA"]),
                       resids=np.array([1, 1]),
                       masses=np.array([1.0, 3.0]))
        pos = np.array([[[0.0, 0, 0], [4.0, 0, 0]],
                        [[0.0, 0, 0], [8.0, 0, 0]]], np.float32)
        u = Universe(top, pos)
        r = RadiusOfGyration(u.atoms).run(backend="torch", batch_size=2)
        np.testing.assert_allclose(
            r.results.rgyr, [np.sqrt(3.0), 2 * np.sqrt(3.0)], rtol=1e-6)

    def test_matches_atomgroup_method(self):
        from mdanalysis_mpi_tpu_torch.analysis import RadiusOfGyration
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=6, n_frames=3, seed=8)
        ag = u.select_atoms("name CA")
        r = RadiusOfGyration(ag).run(backend="serial")
        u.trajectory[2]
        assert r.results.rgyr[2] == pytest.approx(ag.radius_of_gyration())

    def test_empty_group_raises(self):
        from mdanalysis_mpi_tpu_torch.analysis import RadiusOfGyration
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=3, n_frames=2)
        with pytest.raises(ValueError, match="non-empty"):
            RadiusOfGyration(u.select_atoms("name ZZ")).run()


class TestPrefetchThread:
    """The genuine ThreadPoolExecutor double-buffering path (VERDICT r1
    weak #5): single-core hosts degenerate to _InlinePool, so the thread
    path the multi-core v5e target runs needs its own correctness pin."""

    # The port has no ``_staging_pool``/``MDTPU_PREFETCH``: it stages on
    # its own pools (``parallel/executors.py::_run_batches``): a one-thread
    # prefetch pool, or with ``prestage=True`` the cold pipeline's wire
    # thread (``MDTPU_COLD_PIPELINE=1``) or chunks staged inline
    # (``MDTPU_COLD_PIPELINE=0``).  The contract twinned: threaded
    # staging gives the inline result, and both the serial oracle's.

    @staticmethod
    def _run(monkeypatch, backend, prestage, pipeline):
        from concurrent.futures import ThreadPoolExecutor

        from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
        from mdanalysis_mpi_tpu_torch.parallel import executors
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        pools = []

        class _Counting(ThreadPoolExecutor):
            def __init__(self, *a, **k):
                pools.append(k.get("thread_name_prefix", ""))
                super().__init__(*a, **k)

        monkeypatch.setattr(executors, "ThreadPoolExecutor", _Counting)
        monkeypatch.setenv("MDTPU_HOST_STAGE_CACHE_MB", "0")  # force restage
        monkeypatch.setenv("MDTPU_COLD_PIPELINE", pipeline)
        u = make_protein_universe(n_residues=40, n_frames=37, noise=0.4,
                                  seed=21)
        r = AlignedRMSF(u, select="name CA").run(
            **mesh_kw(backend), batch_size=4, prestage=prestage)
        return r.results.rmsf, pools

    @pytest.mark.parametrize("backend", ["torch", "mesh"])
    def test_threaded_staging_parity(self, monkeypatch, backend):
        from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=40, n_frames=37, noise=0.4,
                                  seed=21)
        s = AlignedRMSF(u, select="name CA").run(backend="serial")
        for prestage, pipeline in ((False, "0"), (True, "1")):
            rmsf, pools = self._run(monkeypatch, backend, prestage, pipeline)
            assert pools, "the threaded schedule ran without a thread pool"
            np.testing.assert_allclose(rmsf, s.results.rmsf, atol=1e-4,
                                       err_msg=f"{backend} {prestage}")

    @pytest.mark.parametrize("backend", ["torch", "mesh"])
    def test_inline_pool_when_disabled(self, monkeypatch, backend):
        inline, pools = self._run(monkeypatch, backend, True, "0")
        assert pools == []            # staged on the calling thread
        wired, pools = self._run(monkeypatch, backend, True, "1")
        assert "mdtpu-wire" in pools
        prefetched, _ = self._run(monkeypatch, backend, False, "0")
        np.testing.assert_array_equal(inline, wired)
        np.testing.assert_array_equal(inline, prefetched)


class TestAlignHelpers:
    """align.rotation_matrix / align.alignto (upstream one-shot API)."""

    def test_rotation_matrix_recovers_pure_rotation(self):
        from mdanalysis_mpi_tpu_torch.analysis import rotation_matrix
        from mdanalysis_mpi_tpu_torch.testing import random_rotation_matrices

        rng = np.random.default_rng(0)
        x = rng.normal(size=(40, 3))
        x -= x.mean(axis=0)
        rot = random_rotation_matrices(1, rng)[0]
        r, rmsd = rotation_matrix(x @ rot, x)
        assert rmsd < 1e-12
        # upstream convention: R acts on column vectors -> rows @ R.T
        np.testing.assert_allclose((x @ rot) @ r.T, x, atol=1e-12)

    def test_rotation_matrix_weighted(self):
        from mdanalysis_mpi_tpu_torch.analysis import rotation_matrix

        rng = np.random.default_rng(1)
        a = rng.normal(size=(20, 3)); a -= a.mean(axis=0)
        b = rng.normal(size=(20, 3)); b -= b.mean(axis=0)
        w = rng.uniform(0.5, 2.0, size=20)
        r, rmsd = rotation_matrix(a, b, weights=w)
        d2 = (((a @ r.T) - b) ** 2).sum(axis=1)
        np.testing.assert_allclose(rmsd, np.sqrt((w @ d2) / w.sum()),
                                   rtol=1e-10)

    def test_alignto_reduces_rmsd_in_place(self):
        from mdanalysis_mpi_tpu_torch.analysis import alignto
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=12, n_frames=3, noise=0.2,
                                  seed=4)
        mob = u.copy()
        mob.trajectory[0]
        u.trajectory[2]
        old, new = alignto(mob, u, select="name CA")
        assert new < old
        # in place: the current frame's positions actually moved
        ca = mob.select_atoms("name CA")
        ref = u.select_atoms("name CA")
        d = np.sqrt(((ca.positions - ref.positions) ** 2).sum(1).mean())
        assert d == pytest.approx(new, abs=1e-3)

    def test_alignto_errors(self):
        from mdanalysis_mpi_tpu_torch.analysis import alignto
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=4, n_frames=2)
        ref = make_protein_universe(n_residues=4, n_frames=2)
        with pytest.raises(ValueError, match="matched no atoms"):
            alignto(u, ref, select="name ZZ")
        with pytest.raises(ValueError, match="weights"):
            alignto(u, ref, select="name CA", weights="charge")

    def test_alignto_respects_group_membership(self):
        from mdanalysis_mpi_tpu_torch.analysis import alignto
        from mdanalysis_mpi_tpu_torch.testing import make_solvated_universe

        u = make_solvated_universe(n_residues=5, n_waters=20, n_frames=2,
                                   seed=6)
        ref = make_solvated_universe(n_residues=5, n_waters=20, n_frames=2,
                                     seed=6)
        ref.trajectory[1]
        u.trajectory[0]
        # passing protein groups fits on protein only (select='all'
        # refines within the groups, not over the whole universe) —
        # pinned by a reference universe that HAS no waters: a
        # regression to whole-universe selection cannot match sizes
        from mdanalysis_mpi_tpu_torch.core.universe import Universe

        prot = ref.select_atoms("protein")
        ref_only = Universe(ref.topology.subset(prot.indices),
                            prot.positions[None])
        old, new = alignto(u.select_atoms("protein"), ref_only.atoms)
        assert new <= old

    def test_alignto_requires_reference(self):
        from mdanalysis_mpi_tpu_torch.analysis import alignto
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=4, n_frames=2)
        with pytest.raises(TypeError):
            alignto(u)


class TestExplicitFramesAPI:
    """run(frames=[...]) — upstream's explicit frame-list form."""

    def test_frames_list_matches_slice(self):
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=10, n_frames=20, noise=0.3)
        ag = u.select_atoms("name CA")
        a = RMSF(ag).run(frames=[2, 5, 8, 11, 14], backend="serial")
        b = RMSF(ag).run(start=2, stop=15, step=3, backend="serial")
        np.testing.assert_allclose(a.results.rmsf, b.results.rmsf)
        # non-uniform list on the device path (per-frame staging branch)
        c = RMSF(ag).run(frames=[0, 1, 7, 19], backend="torch", batch_size=3)
        s = RMSF(ag).run(frames=[0, 1, 7, 19], backend="serial")
        np.testing.assert_allclose(c.results.rmsf, s.results.rmsf,
                                   atol=2e-4)
        # negative indices wrap (numpy convention)
        d = RMSF(ag).run(frames=[-1, -2], backend="serial")
        e = RMSF(ag).run(frames=[19, 18], backend="serial")
        np.testing.assert_allclose(d.results.rmsf, e.results.rmsf)
        # boolean mask form (upstream-compatible)
        mask = np.zeros(20, dtype=bool)
        mask[[2, 5, 8, 11, 14]] = True
        f = RMSF(ag).run(frames=mask, backend="serial")
        g = RMSF(ag).run(frames=[2, 5, 8, 11, 14], backend="serial")
        np.testing.assert_allclose(f.results.rmsf, g.results.rmsf)

    def test_frames_validation(self):
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=4, n_frames=6)
        ag = u.select_atoms("name CA")
        with pytest.raises(ValueError, match="not both"):
            RMSF(ag).run(frames=[0, 1], stop=3)
        with pytest.raises(IndexError, match="out of range"):
            RMSF(ag).run(frames=[99])
        with pytest.raises(ValueError, match="boolean frames mask"):
            RMSF(ag).run(frames=np.ones(3, dtype=bool))
        with pytest.raises(TypeError, match="integer indices"):
            RMSF(ag).run(frames=[1.5, 2.5])

    def test_frames_through_aligned_rmsf_and_aligntraj(self):
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
        from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF, AlignTraj

        u = make_protein_universe(n_residues=8, n_frames=12, noise=0.3)
        a = AlignedRMSF(u, select="name CA").run(frames=[1, 3, 5, 7],
                                                 backend="serial")
        b = AlignedRMSF(u, select="name CA").run(start=1, stop=8, step=2,
                                                 backend="serial")
        np.testing.assert_allclose(a.results.rmsf, b.results.rmsf)
        u2 = u.copy()
        AlignTraj(u2, u, select="name CA").run(frames=[0, 2, 4],
                                               backend="serial")
        assert u2.trajectory.n_frames == 3


class TestAnalysisFromFunction:
    def test_wraps_function_over_frames(self):
        from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisFromFunction

        u = make_protein_universe(n_residues=4, n_frames=6, noise=0.2)
        ca = u.select_atoms("name CA")
        r = AnalysisFromFunction(
            lambda ag: ag.radius_of_gyration(), ca).run()
        assert r.results.timeseries.shape == (6,)
        np.testing.assert_array_equal(r.results.frames, np.arange(6))
        # spot-check against a manual loop
        u.trajectory[3]
        np.testing.assert_allclose(r.results.timeseries[3],
                                   ca.radius_of_gyration())

    def test_array_valued_and_window(self):
        from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisFromFunction

        u = make_protein_universe(n_residues=4, n_frames=8, noise=0.2)
        ca = u.select_atoms("name CA")
        r = AnalysisFromFunction(
            lambda ag: ag.center_of_mass(), ca).run(start=2, stop=8, step=2)
        assert r.results.timeseries.shape == (3, 3)
        np.testing.assert_array_equal(r.results.frames, [2, 4, 6])

    def test_analysis_class_decorator(self):
        from mdanalysis_mpi_tpu_torch.analysis.base import analysis_class

        @analysis_class
        def com_z(ag):
            return ag.center_of_mass()[2]

        u = make_protein_universe(n_residues=3, n_frames=4, noise=0.2)
        r = com_z(u.select_atoms("name CA")).run()
        assert r.results.timeseries.shape == (4,)
        assert com_z.__name__ == "com_z"

    def test_needs_group_argument(self):
        from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisFromFunction

        with pytest.raises(ValueError, match="AtomGroup or Universe"):
            AnalysisFromFunction(lambda x: x, 42)

    def test_serial_only(self):
        from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisFromFunction

        u = make_protein_universe(n_residues=3, n_frames=4)
        with pytest.raises(NotImplementedError, match="serial"):
            AnalysisFromFunction(
                lambda ag: ag.n_atoms, u.atoms).run(backend="torch")


class TestOneShotRmsd:
    def test_identical_and_translated(self):
        from mdanalysis_mpi_tpu_torch.analysis.rms import rmsd

        rng = np.random.default_rng(6)
        a = rng.normal(size=(20, 3))
        assert rmsd(a, a) == 0.0
        shifted = a + [1.0, 0, 0]
        assert rmsd(a, shifted) == pytest.approx(1.0)
        assert rmsd(a, shifted, center=True) == pytest.approx(0.0, abs=1e-12)

    def test_superposition_removes_rotation(self):
        from mdanalysis_mpi_tpu_torch.analysis.rms import rmsd
        from mdanalysis_mpi_tpu_torch.testing import random_rotation_matrices

        rng = np.random.default_rng(7)
        a = rng.normal(size=(15, 3))
        r = random_rotation_matrices(1, rng)[0]
        b = a @ r.T + [2.0, -1.0, 0.5]
        assert rmsd(a, b) > 1.0
        assert rmsd(a, b, superposition=True) == pytest.approx(0.0, abs=1e-9)

    def test_weighted_matches_series_analysis(self):
        """One-shot rmsd(mass-weighted, superposed) == RMSD analysis
        value for the same frame pair."""
        from mdanalysis_mpi_tpu_torch.analysis import RMSD
        from mdanalysis_mpi_tpu_torch.analysis.rms import rmsd

        u = make_protein_universe(n_residues=5, n_frames=4, noise=0.4)
        ca = u.select_atoms("name CA")
        series = RMSD(ca, weights="mass").run(backend="serial").results.rmsd
        ref = u.trajectory[0].positions[ca.indices].copy()
        mob = u.trajectory[2].positions[ca.indices]
        got = rmsd(mob, ref, weights=ca.masses, superposition=True)
        np.testing.assert_allclose(got, series[2], atol=1e-6)

    def test_validation(self):
        from mdanalysis_mpi_tpu_torch.analysis.rms import rmsd

        with pytest.raises(ValueError, match="N, 3"):
            rmsd(np.zeros((3, 3)), np.zeros((4, 3)))
        with pytest.raises(ValueError, match="weights"):
            rmsd(np.zeros((3, 3)), np.zeros((3, 3)), weights=[1.0])


class TestRMSDGroupselections:
    def test_rigid_companion_vs_mover(self):
        """A group moving rigidly WITH the main selection has ~0 RMSD in
        the fitted frame; an independently displaced group does not."""
        from mdanalysis_mpi_tpu_torch.analysis import RMSD
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
        from mdanalysis_mpi_tpu_torch.testing import random_rotation_matrices

        rng = np.random.default_rng(44)
        n_main, n_g = 12, 5
        main0 = rng.normal(scale=4.0, size=(n_main, 3))
        rigid0 = rng.normal(scale=4.0, size=(n_g, 3)) + [8.0, 0, 0]
        mover0 = rng.normal(scale=4.0, size=(n_g, 3)) - [8.0, 0, 0]
        t_frames = 6
        rots = random_rotation_matrices(t_frames, rng)
        trans = rng.normal(scale=5.0, size=(t_frames, 3))
        pos = np.empty((t_frames, n_main + 2 * n_g, 3), np.float32)
        for f in range(t_frames):
            body = np.concatenate([main0, rigid0])        # one rigid body
            pos[f, :n_main + n_g] = body @ rots[f].T + trans[f]
            # the mover drifts on its own
            pos[f, n_main + n_g:] = (mover0 @ rots[f].T + trans[f]
                                     + [0, 0, 2.0 * f])
        names = np.array(["CA"] * n_main + ["CB"] * n_g + ["CG"] * n_g)
        top = Topology(names=names,
                       resnames=np.full(len(names), "ALA"),
                       resids=np.arange(1, len(names) + 1))
        u = Universe(top, MemoryReader(pos))
        r = RMSD(u, select="name CA",
                 groupselections=["name CB", "name CG"]).run(
            backend="serial")
        g = r.results.group_rmsd
        assert g.shape == (t_frames, 2)
        np.testing.assert_allclose(g[:, 0], 0.0, atol=1e-4)   # rigid rider
        assert g[1:, 1].min() > 1.0                           # the mover
        np.testing.assert_allclose(r.results.rmsd, 0.0, atol=1e-4)
        # batch backends agree with the serial oracle
        for backend in ("torch", "mesh"):
            b = RMSD(u, select="name CA",
                     groupselections=["name CB", "name CG"]).run(
                **mesh_kw(backend), batch_size=2)
            np.testing.assert_allclose(np.asarray(b.results.group_rmsd),
                                       g, atol=1e-3)
            np.testing.assert_allclose(np.asarray(b.results.rmsd),
                                       r.results.rmsd, atol=1e-3)

    def test_validation(self):
        from mdanalysis_mpi_tpu_torch.analysis import RMSD
        from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

        u = make_protein_universe(n_residues=6, n_frames=4)
        with pytest.raises(ValueError, match="superposition"):
            RMSD(u, select="name CA", superposition=False,
                 groupselections=["name CB"])
        with pytest.raises(ValueError, match="matched no atoms"):
            RMSD(u, select="name CA",
                 groupselections=["name ZZ"]).run(backend="serial")


def test_sequence_alignment():
    """Needleman-Wunsch over residue sequences: identical sequences map
    1:1; an insertion opens a gap; pairs carry resindices."""
    from mdanalysis_mpi_tpu_torch.analysis import sequence_alignment
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    def chain(resnames):
        n = len(resnames)
        top = Topology(names=np.full(n, "CA"),
                       resnames=np.array(resnames),
                       resids=np.arange(1, n + 1))
        return Universe(top, MemoryReader(np.zeros((1, n, 3),
                                                   np.float32)))

    a = chain(["ALA", "GLY", "LYS", "TRP"])
    b = chain(["ALA", "GLY", "LYS", "TRP"])
    s1, s2, pairs = sequence_alignment(a.atoms, b.atoms)
    assert s1 == s2 == "AGKW"
    np.testing.assert_array_equal(pairs,
                                  np.stack([np.arange(4)] * 2, axis=1))
    # an inserted residue in one chain opens a gap, others still pair
    c = chain(["ALA", "GLY", "PHE", "LYS", "TRP"])
    s1, s2, pairs = sequence_alignment(c.atoms, b.atoms)
    assert s1 == "AGFKW" and s2 == "AG-KW"
    assert len(pairs) == 4                       # A, G, K, W columns
    np.testing.assert_array_equal(pairs[:, 1], [0, 1, 2, 3])
    np.testing.assert_array_equal(pairs[:, 0], [0, 1, 3, 4])
    with pytest.raises(ValueError, match="residue"):
        sequence_alignment(a.atoms[[]], b.atoms)


def test_waterdynamics_msd_alias():
    from mdanalysis_mpi_tpu_torch.analysis import (EinsteinMSD,
                                             MeanSquareDisplacement)
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    u = make_water_universe(n_waters=20, n_frames=8, seed=2)
    a = MeanSquareDisplacement(u, select="name OW").run(backend="serial")
    b = EinsteinMSD(u, select="name OW").run(backend="serial")
    np.testing.assert_allclose(a.results.timeseries,
                               b.results.timeseries, atol=1e-10)


def test_sequence_alignment_affine_gap():
    """A multi-residue indel must open ONE affine gap (upstream's
    open -2 / extend -0.1), not pay per-residue linear penalties that
    a mismatch-heavy diagonal would outscore."""
    from mdanalysis_mpi_tpu_torch.analysis import sequence_alignment
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    def chain(resnames):
        n = len(resnames)
        top = Topology(names=np.full(n, "CA"),
                       resnames=np.array(resnames),
                       resids=np.arange(1, n + 1))
        return Universe(top, MemoryReader(np.zeros((1, n, 3),
                                                   np.float32)))

    # reference AGKW; mobile has a 3-residue loop inserted after G
    a = chain(["ALA", "GLY", "PHE", "PHE", "PHE", "LYS", "TRP"])
    b = chain(["ALA", "GLY", "LYS", "TRP"])
    s1, s2, pairs = sequence_alignment(a.atoms, b.atoms)
    assert s1 == "AGFFFKW" and s2 == "AG---KW"
    np.testing.assert_array_equal(pairs[:, 0], [0, 1, 5, 6])
    np.testing.assert_array_equal(pairs[:, 1], [0, 1, 2, 3])


def test_waterdynamics_msd_upstream_signature():
    from mdanalysis_mpi_tpu_torch.analysis import MeanSquareDisplacement
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    u = make_water_universe(n_waters=15, n_frames=10, seed=3)
    # upstream positional window (t0, tf, dtmax)
    m = MeanSquareDisplacement(u, "name OW", 2, 8, 3).run(
        backend="serial")
    assert len(m.results.timeseries) == 4        # dtmax truncation


def test_sequence_alignment_cross_gap_scoring():
    """Full Gotoh: with mismatch far costlier than two adjacent gaps,
    the X<->Y transition path (insertion next to deletion) must win."""
    from mdanalysis_mpi_tpu_torch.analysis import sequence_alignment
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    def chain(resnames):
        n = len(resnames)
        top = Topology(names=np.full(n, "CA"),
                       resnames=np.array(resnames),
                       resids=np.arange(1, n + 1))
        return Universe(top, MemoryReader(np.zeros((1, n, 3),
                                                   np.float32)))

    a = chain(["ALA", "TRP"])
    b = chain(["ALA", "VAL"])
    s1, s2, pairs = sequence_alignment(
        a.atoms, b.atoms, mismatch=-10.0, gap_open=-1.0,
        gap_extend=-0.1)
    # W and V must NOT pair; each sits against a gap
    assert "-" in s1 and "-" in s2
    assert len(pairs) == 1 and tuple(pairs[0]) == (0, 0)


def test_msd_shim_partial_window_and_particles():
    from mdanalysis_mpi_tpu_torch.analysis import MeanSquareDisplacement
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    u = make_water_universe(n_waters=12, n_frames=10, seed=4)
    m = MeanSquareDisplacement(u, "name OW", 2, 8, 3)
    # overriding only start keeps the constructor's stop=8 (6 frames)
    m.run(start=0, backend="serial")
    assert len(m.results.timeseries) == 4            # dtmax
    assert m.results.msds_by_particle.shape[0] == 4  # truncated together


# ---------------- parity with the JAX package ----------------
# The same synthetic trajectory (each package's ``testing`` fixture from
# one seed) through the JAX package's ``backend="jax"`` and the port's
# ``backend="torch"``, at the reference cases' tolerances above.

_PARITY = {
    # name: (select, result, rtol, atol) -- the reference case's gate
    "AverageStructure": ("protein and name CA", "positions", 0, 2e-4),
    "AlignedRMSF": ("protein and name CA", "rmsf", 5e-3, 1e-4),
    "RMSD": ("protein and name CA", "rmsd", 1e-3, 2e-4),
    "RadiusOfGyration": ("protein", "rgyr", 1e-5, 0),
}


@pytest.mark.parametrize("name", sorted(_PARITY))
@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
def test_port_matches_jax_package(name, transfer_dtype):
    import mdanalysis_mpi_tpu.analysis as ref_analysis
    from mdanalysis_mpi_tpu.testing import \
        make_protein_universe as ref_make

    import mdanalysis_mpi_tpu_torch.analysis as port_analysis

    select, key, rtol, atol = _PARITY[name]
    ref_u = ref_make(n_residues=12, n_frames=30, noise=0.25, seed=3)
    u = make_protein_universe(n_residues=12, n_frames=30, noise=0.25, seed=3)
    np.testing.assert_array_equal(ref_u.trajectory.coordinates,
                                  u.trajectory.coordinates)

    def build(mod, uu):
        cls = getattr(mod, name)
        if name == "RadiusOfGyration":
            return cls(uu.select_atoms(select))
        return cls(uu, select=select)

    kw = dict(batch_size=8, transfer_dtype=transfer_dtype)
    ref = getattr(build(ref_analysis, ref_u).run(backend="jax", **kw).results,
                  key)
    port = getattr(build(port_analysis, u).run(backend="torch", **kw).results,
                   key)
    assert np.shape(port) == np.shape(ref)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def test_aligntraj_matches_jax_package():
    from mdanalysis_mpi_tpu.analysis import AlignTraj as RefAlignTraj
    from mdanalysis_mpi_tpu.testing import \
        make_protein_universe as ref_make

    u1 = ref_make(n_residues=6, n_frames=9, noise=0.2, seed=9)
    u2 = make_protein_universe(n_residues=6, n_frames=9, noise=0.2, seed=9)
    RefAlignTraj(u1, select="name CA").run(backend="jax", batch_size=4)
    AlignTraj(u2, select="name CA").run(backend="torch", batch_size=4)
    for i in range(9):
        np.testing.assert_allclose(u2.trajectory[i].positions,
                                   u1.trajectory[i].positions, atol=2e-3)


def test_mesh_without_devices_spans_the_default_device():
    """``backend="mesh"`` with no ``devices`` spans the default
    device's devices, as the JAX package's mesh spans its default
    platform's: on the CPU that is one shard (it raised IndexError on
    an empty device list before)."""
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        MeshExecutor, _resolve_devices)

    assert [d.type for d in _resolve_devices(None)] == ["cpu"]
    u = make_protein_universe(n_residues=8, n_frames=12, noise=0.2, seed=4)
    m = AlignedRMSF(u, select="name CA").run(
        backend=MeshExecutor(batch_size=4))
    t = AlignedRMSF(u, select="name CA").run(backend="torch", batch_size=4)
    np.testing.assert_allclose(m.results.rmsf, t.results.rmsf, atol=1e-5)


@pytest.mark.parametrize("case", ["aligned-fused", "aligned-generic",
                                  "aligned-mesh", "rmsd", "rmsf", "rdf"])
def test_a_finished_analysis_is_freed_without_the_cyclic_collector(case):
    """A run leaves no reference cycle through the analysis: dropped by
    its caller, it is freed at once, with its results, device blocks and
    graphs.  A recursive closure over ``self`` in ``run()`` used to keep
    every analysis alive until the cyclic collector ran, and that
    collection's pause (0.63 s on an H100, chip_smoke phase 5) then
    landed in whichever later run triggered it."""
    import gc
    import weakref

    from mdanalysis_mpi_tpu_torch.analysis import InterRDF
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    u = make_protein_universe(n_residues=8, n_frames=12, noise=0.2, seed=5)
    builders = {
        "aligned-fused": lambda: (AlignedRMSF(u, select="name CA",
                                              engine="fused"),
                                  dict(transfer_dtype="int16")),
        "aligned-generic": lambda: (AlignedRMSF(u, select="name CA"), {}),
        "aligned-mesh": lambda: (AlignedRMSF(u, select="name CA"),
                                 mesh_kw("mesh")),
        "rmsd": lambda: (RMSD(u, select="name CA"), {}),
        "rmsf": lambda: (RMSF(u.select_atoms("name CA")), {}),
        "rdf": lambda: (InterRDF(*[make_water_universe(
            n_waters=40, n_frames=4).select_atoms("name OW")] * 2), {}),
    }
    from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisBase, Results

    a, kw = builders[case]()
    kw = {"backend": "torch", **kw}
    gc.collect()
    gc.disable()
    try:
        a.run(batch_size=4, **kw)
        ref = weakref.ref(a)
        del a
        assert ref() is None, "the analysis outlived its last reference"
        # nor did the passes it ran internally (AlignedRMSF's two)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        left = [type(o).__name__ for o in gc.garbage
                if isinstance(o, (AnalysisBase, Results))]
        assert left == [], f"left for the cyclic collector: {left}"
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
