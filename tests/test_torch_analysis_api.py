"""The port's generic analysis API — ``AnalysisFromFunction``,
``analysis_class`` and ``AnalysisCollection`` — case by case after the
JAX package's tests/test_collection.py, with the same seeded frames
through both packages.

Tolerances: a collection's child equals its solo run on the same
backend exactly (the union is staged once, each child slices its atoms
back out: the same ops); the port's batch results sit within 1e-4 of
the serial float64 oracle and of the JAX package's ``backend="jax"``
(test_collection.py's ``atol``), 1e-3 with int16 staging.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu import analysis as janalysis  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

from mdanalysis_mpi_tpu_torch.analysis import (  # noqa: E402
    PCA, RMSD, RMSF, AlignedRMSF, AlignTraj, AnalysisCollection,
    AnalysisFromFunction, AverageStructure, InterRDF, RadiusOfGyration,
    UncoalescableAnalysisError, analysis_class)
from mdanalysis_mpi_tpu_torch.analysis.base import (  # noqa: E402
    _collection_kernel_for, needs_solo_on_batch)
from mdanalysis_mpi_tpu_torch.testing import (  # noqa: E402
    make_protein_universe, make_water_universe)

CPU = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)
KW = dict(n_residues=30, noise=0.3, seed=9)


def _u(n_frames=24):
    return make_protein_universe(n_frames=n_frames, **KW)


def _ju(n_frames=24):
    return jax_make_protein_universe(n_frames=n_frames, **KW)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# ---------------- AnalysisCollection ----------------

def test_serial_matches_individual_runs():
    u = _u()
    solo_rmsf = RMSF(u.select_atoms("name CA")).run(backend="serial")
    solo_avg = AverageStructure(u, select="name CA",
                                select_only=True).run(backend="serial")
    coll = AnalysisCollection(
        RMSF(u.select_atoms("name CA")),
        AverageStructure(u, select="name CA", select_only=True))
    coll.run(backend="serial")
    np.testing.assert_allclose(coll.analyses[0].results.rmsf,
                               solo_rmsf.results.rmsf)
    np.testing.assert_allclose(_np(coll.analyses[1].results.positions),
                               _np(solo_avg.results.positions))


def test_torch_reductions_match_serial_solo_and_jax():
    """All-reduction children on the torch backend: equal to their solo
    torch runs, within 1e-4 of the serial oracle and of the JAX
    package's collection."""
    u, ju = _u(), _ju()
    sel = "protein and not name H*"
    coll = AnalysisCollection(
        RMSF(u.select_atoms("name CA")),
        AverageStructure(u, select=sel, select_only=True))
    coll.run(**CPU, batch_size=8)
    solo0 = RMSF(u.select_atoms("name CA")).run(**CPU, batch_size=8)
    solo1 = AverageStructure(u, select=sel, select_only=True).run(
        **CPU, batch_size=8)
    assert torch.equal(coll.analyses[0].results["rmsf"],
                       solo0.results["rmsf"])
    assert torch.equal(coll.analyses[1].results["positions"],
                       solo1.results["positions"])
    s0 = RMSF(u.select_atoms("name CA")).run(backend="serial")
    s1 = AverageStructure(u, select=sel, select_only=True).run(
        backend="serial")
    np.testing.assert_allclose(coll.analyses[0].results.rmsf,
                               s0.results.rmsf, atol=1e-4)
    np.testing.assert_allclose(_np(coll.analyses[1].results.positions),
                               _np(s1.results.positions), atol=1e-4)
    jcoll = janalysis.AnalysisCollection(
        janalysis.RMSF(ju.select_atoms("name CA")),
        janalysis.AverageStructure(ju, select=sel, select_only=True))
    jcoll.run(backend="jax", batch_size=8)
    np.testing.assert_allclose(
        coll.analyses[0].results.rmsf,
        np.asarray(jcoll.analyses[0].results.rmsf), atol=1e-4)
    np.testing.assert_allclose(
        _np(coll.analyses[1].results.positions),
        np.asarray(jcoll.analyses[1].results.positions), atol=1e-4)


def test_torch_series_match_serial_solo_and_jax():
    u, ju = _u(), _ju()
    coll = AnalysisCollection(
        RMSD(u.select_atoms("name CA")),
        RadiusOfGyration(u.select_atoms("protein")))
    coll.run(**CPU, batch_size=8)
    solo = RadiusOfGyration(u.select_atoms("protein")).run(
        **CPU, batch_size=8)
    np.testing.assert_array_equal(coll.analyses[1].results.rgyr,
                                  solo.results.rgyr)
    s0 = RMSD(u.select_atoms("name CA")).run(backend="serial")
    s1 = RadiusOfGyration(u.select_atoms("protein")).run(backend="serial")
    np.testing.assert_allclose(_np(coll.analyses[0].results.rmsd),
                               s0.results.rmsd, atol=1e-4)
    np.testing.assert_allclose(coll.analyses[1].results.rgyr,
                               s1.results.rgyr, atol=1e-4)
    jcoll = janalysis.AnalysisCollection(
        janalysis.RMSD(ju.select_atoms("name CA")),
        janalysis.RadiusOfGyration(ju.select_atoms("protein")))
    jcoll.run(backend="jax", batch_size=8)
    np.testing.assert_allclose(
        coll.analyses[1].results.rgyr,
        np.asarray(jcoll.analyses[1].results.rgyr), atol=1e-4)


def test_mesh_reductions_match_serial():
    u = _u(n_frames=32)
    coll = AnalysisCollection(
        RMSF(u.select_atoms("name CA")),
        AverageStructure(u, select="name CA", select_only=True))
    coll.run(**MESH, batch_size=4)
    s0 = RMSF(u.select_atoms("name CA")).run(backend="serial")
    np.testing.assert_allclose(coll.analyses[0].results.rmsf,
                               s0.results.rmsf, atol=1e-4)


def test_mesh_series_match_serial():
    u = _u(n_frames=32)
    coll = AnalysisCollection(
        RMSD(u.select_atoms("name CA")),
        RadiusOfGyration(u.select_atoms("protein")))
    coll.run(**MESH, batch_size=4)
    s1 = RadiusOfGyration(u.select_atoms("protein")).run(backend="serial")
    np.testing.assert_allclose(coll.analyses[1].results.rgyr,
                               s1.results.rgyr, atol=1e-4)


def test_int16_staging():
    u = _u()
    coll = AnalysisCollection(
        RMSF(u.select_atoms("name CA")),
        AverageStructure(u, select="name CA", select_only=True))
    coll.run(**CPU, batch_size=8, transfer_dtype="int16")
    s0 = RMSF(u.select_atoms("name CA")).run(backend="serial")
    np.testing.assert_allclose(coll.analyses[0].results.rmsf,
                               s0.results.rmsf, atol=1e-3)


def test_one_pass_staging(monkeypatch):
    """The collection reads each frame block from the port's reader
    once for all its children."""
    u = _u()
    reads = []
    cls = type(u.trajectory)
    for name in ("read_block", "stage_cached"):
        orig = getattr(cls, name, None)
        if orig is None:
            continue

        def traced(self, *a, _orig=orig, **k):
            reads.append(a[:2])
            return _orig(self, *a, **k)

        monkeypatch.setattr(cls, name, traced)
    AnalysisCollection(
        RMSF(u.select_atoms("name CA")),
        AverageStructure(u, select="name CB", select_only=True),
    ).run(**CPU, batch_size=8)
    n_collection = len(reads)
    reads.clear()
    RMSF(u.select_atoms("name CA")).run(**CPU, batch_size=8)
    AverageStructure(u, select="name CB", select_only=True).run(
        **CPU, batch_size=8)
    assert n_collection == len(reads) // 2
    assert n_collection > 0


def test_union_slots_disjoint_selections():
    """Children with disjoint selections read their own atoms out of
    the union block."""
    u = _u()
    coll = AnalysisCollection(
        RMSF(u.select_atoms("name CA")),
        RMSF(u.select_atoms("name CB")))
    coll.run(**CPU, batch_size=8)
    assert coll._union is not None and coll._slots[0] is not None
    sa = RMSF(u.select_atoms("name CA")).run(backend="serial")
    sb = RMSF(u.select_atoms("name CB")).run(backend="serial")
    np.testing.assert_allclose(coll.analyses[0].results.rmsf,
                               sa.results.rmsf, atol=1e-4)
    np.testing.assert_allclose(coll.analyses[1].results.rmsf,
                               sb.results.rmsf, atol=1e-4)


def test_union_and_slots_match_jax_package():
    """The staged union and each child's slots are the JAX package's
    (the checkpoint fingerprint hashes the union)."""
    u, ju = _u(), _ju()
    coll = AnalysisCollection(RMSF(u.select_atoms("name CA")),
                              RMSF(u.select_atoms("name CB")))
    jcoll = janalysis.AnalysisCollection(
        janalysis.RMSF(ju.select_atoms("name CA")),
        janalysis.RMSF(ju.select_atoms("name CB")))
    for c in (coll, jcoll):
        c.n_frames, c._frame_indices = 24, list(range(24))
        c._prepare()
    np.testing.assert_array_equal(coll._batch_select(),
                                  jcoll._batch_select())
    for a, b in zip(coll._slots, jcoll._slots):
        np.testing.assert_array_equal(a, b)


def test_kernel_identity_is_stable():
    """One batch function per tuple of child functions, so a repeated
    collection finds its cached group programs again."""
    u = _u()

    def kernel():
        c = AnalysisCollection(RMSF(u.select_atoms("name CA")),
                               RMSF(u.select_atoms("name CB")))
        c.n_frames, c._frame_indices = 24, list(range(24))
        c._prepare()
        return c._batch_fn(), c._device_fold_fn

    (k1, f1), (k2, f2) = kernel(), kernel()
    assert k1 is k2 and f1 is f2
    assert k1 is _collection_kernel_for(
        (RMSF(u.select_atoms("name CA"))._batch_fn(),) * 2)


def test_distinct_trajectories_rejected():
    u1, u2 = _u(), _u()
    with pytest.raises(ValueError, match="trajectory"):
        AnalysisCollection(RMSF(u1.select_atoms("name CA")),
                           RMSF(u2.select_atoms("name CA")))


def test_empty_rejected():
    with pytest.raises(ValueError, match="at least one"):
        AnalysisCollection()


def test_results_aggregate():
    u = _u()
    coll = AnalysisCollection(RMSF(u.select_atoms("name CA")))
    coll.run(backend="serial")
    assert coll.results.analyses[0] is coll.analyses[0].results


def test_mixed_runs_on_serial():
    """The serial backend accepts a reduction + series mix (only the
    batch and MPI merges are uniform-typed)."""
    u = _u()
    coll = AnalysisCollection(RMSF(u.select_atoms("name CA")),
                              RMSD(u.select_atoms("name CA")))
    coll.run(backend="serial")
    s0 = RMSF(u.select_atoms("name CA")).run(backend="serial")
    s1 = RMSD(u.select_atoms("name CA")).run(backend="serial")
    np.testing.assert_allclose(coll.analyses[0].results.rmsf,
                               s0.results.rmsf)
    np.testing.assert_allclose(coll.analyses[1].results.rmsd,
                               s1.results.rmsd)


@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_mixed_rejected_on_batch_backend(backend):
    u = _u()
    coll = AnalysisCollection(RMSF(u.select_atoms("name CA")),
                              RMSD(u.select_atoms("name CA")))
    kw = CPU if backend == "torch" else MESH
    with pytest.raises(ValueError, match="mix"):
        coll.run(**kw, batch_size=8)


def test_run_orchestrating_child_rejected():
    u = _u()
    with pytest.raises(ValueError, match="AlignedRMSF"):
        AnalysisCollection(AlignedRMSF(u, select="name CA"))


def test_run_orchestrating_child_rejection_is_typed():
    """The run()-override refusal is the typed
    UncoalescableAnalysisError (still a ValueError), names the
    offending instance, and points at per-job (non-coalesced)
    submission."""
    u = _u()
    for bad in (AlignedRMSF(u, select="name CA"),
                PCA(u, select="name CA"),
                AlignTraj(u, u, select="name CA", in_memory=True)):
        with pytest.raises(UncoalescableAnalysisError) as ei:
            AnalysisCollection(bad)
        assert isinstance(ei.value, ValueError)
        assert ei.value.analysis is bad
        assert "per-job" in str(ei.value)
        assert "non-coalesced" in str(ei.value)
    # healthy members still pass after a refusal (no sticky state)
    AnalysisCollection(RMSF(u.select_atoms("name CA")))


@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_ring_child_rejected_on_batch_only(backend):
    uw = make_water_universe(n_waters=40, n_frames=4, seed=2)
    ow = uw.select_atoms("name OW")
    ring = InterRDF(ow, ow, engine="ring")
    assert needs_solo_on_batch(ring)
    assert not needs_solo_on_batch(RMSF(ow))
    coll = AnalysisCollection(ring)
    kw = CPU if backend == "torch" else MESH
    with pytest.raises(ValueError, match="ring"):
        coll.run(**kw, batch_size=2)


def test_nested_collection_rejected():
    u = _u()
    inner = AnalysisCollection(RMSF(u.select_atoms("name CA")))
    with pytest.raises(ValueError, match="nest"):
        AnalysisCollection(inner)


# ---------------- AnalysisFromFunction / analysis_class ----------------

def test_from_function_runs_serially_by_default():
    """``run()`` with no backend is the serial loop, as in the JAX
    package; the stacked values equal the JAX package's."""
    u, ju = _u(n_frames=6), _ju(n_frames=6)
    ca, jca = u.select_atoms("name CA"), ju.select_atoms("name CA")
    r = AnalysisFromFunction(lambda ag: ag.center_of_mass(), ca).run()
    j = janalysis.AnalysisFromFunction(
        lambda ag: ag.center_of_mass(), jca).run()
    assert r.results.timeseries.shape == (6, 3)
    np.testing.assert_allclose(r.results.timeseries, j.results.timeseries,
                               atol=1e-5)
    np.testing.assert_array_equal(r.results.frames, np.arange(6))


def test_from_function_refuses_a_batch_backend():
    """``backend="torch"`` raises (no batch function), never running
    serially in its place."""
    u = _u(n_frames=4)
    a = AnalysisFromFunction(lambda ag: ag.center_of_mass(),
                             u.select_atoms("name CA"))
    with pytest.raises(NotImplementedError, match="serial"):
        a.run(**CPU)


def test_from_function_needs_a_group():
    with pytest.raises(ValueError, match="AtomGroup or Universe"):
        AnalysisFromFunction(lambda: 1.0, 3.0)


def test_from_function_accepts_updating_groups():
    """The per-frame function reads the group at call time, so an
    UpdatingAtomGroup's membership is seen every frame."""
    u = _u(n_frames=5)
    g = u.select_atoms("name CA and prop x > 0", updating=True)
    r = AnalysisFromFunction(lambda ag: ag.n_atoms, g).run()
    want = [int((u.trajectory[i].positions[
        u.select_atoms("name CA").indices][:, 0] > 0).sum())
        for i in range(5)]
    np.testing.assert_array_equal(r.results.timeseries, want)


def test_analysis_class_decorator():
    u, ju = _u(n_frames=5), _ju(n_frames=5)

    @analysis_class
    def com_z(ag):
        return ag.center_of_mass()[2]

    @janalysis.analysis_class
    def jcom_z(ag):
        return ag.center_of_mass()[2]

    assert com_z.__name__ == "com_z"
    r = com_z(u.select_atoms("name CA")).run()
    j = jcom_z(ju.select_atoms("name CA")).run()
    np.testing.assert_allclose(r.results.timeseries, j.results.timeseries,
                               atol=1e-5)


def test_from_function_joins_a_collection_serially():
    """The JAX package accepts AnalysisFromFunction in a collection on
    the serial backend; so does the port, and a collection with such a
    child runs serially when no backend is named."""
    u = _u(n_frames=6)
    ca = u.select_atoms("name CA")
    coll = AnalysisCollection(
        AnalysisFromFunction(lambda ag: ag.radius_of_gyration(), ca),
        RadiusOfGyration(ca))
    assert coll._default_backend == "serial"
    coll.run()
    np.testing.assert_allclose(coll.analyses[0].results.timeseries,
                               coll.analyses[1].results.rgyr, rtol=1e-6)
    assert AnalysisCollection(RMSF(ca))._default_backend == "torch"
