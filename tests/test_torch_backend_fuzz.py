"""Twin of ``tests/test_backend_fuzz.py``: the randomized cross-backend
differential fuzz, run against the port on the CPU.

Random (frames, batch size, selection, window, stride, staging dtype)
combinations through the port's ``'torch'`` backend and a two-shard
``'mesh'`` (``devices=["cpu"] * 2``), against the serial float64
oracle: the corner cases (partial final batches, strides, tiny
selections, windows smaller than one batch) are where executor
bookkeeping breaks.  The same six seeds per test as the reference
file, each on both backends.

Tolerances are the reference's: 1e-3 Å for int16 and 2e-4 Å for
float32.  The coarse int8 and delta wires are held as
``tests/test_torch_aligned_rmsf.py`` holds them, against the JAX
package's run on the same wire bytes (``tests/test_torch_staging.py``
holds the staged bytes of the two packages equal) within 5e-4 Å (delta
5e-3 Å), and against the oracle within the reference's int8 resolution
(``tests/test_int8_staging.py``).
"""

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu_torch.analysis import (AlignedRMSF,
                                               AnalysisCollection, RMSD,
                                               RMSF)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

# small shapes: one intra-op thread leaves the CPU to the other workers
torch.set_num_threads(1)

CASES = list(range(6))
BACKENDS = {"torch": dict(backend="torch", device="cpu"),
            "mesh": dict(backend="mesh", devices=["cpu"] * 2)}
SELECTIONS = ["name CA", "name CA CB", "protein and heavy", "resid 1:2"]


def _draw(rng, seed):
    """The reference's draw: system, batch, window and selection."""
    n_res = int(rng.integers(3, 40))
    n_frames = int(rng.integers(2, 60))
    batch = int(rng.integers(1, 24))
    start = int(rng.integers(0, max(1, n_frames // 3)))
    step = int(rng.integers(1, 4))
    select = str(rng.choice(SELECTIONS))
    window = dict(start=start, step=step)
    if len(range(start, n_frames, step)) < 2:
        window = {}
    return n_res, n_frames, batch, window, select


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("seed", CASES)
def test_backend_fuzz(seed, backend):
    rng = np.random.default_rng(1000 + seed)
    n_res, n_frames, batch, window, select = _draw(rng, seed)
    tdtype = str(rng.choice(["float32", "int16"]))
    run = dict(BACKENDS[backend], batch_size=batch, transfer_dtype=tdtype,
               **window)
    u = make_protein_universe(n_residues=n_res, n_frames=n_frames,
                              noise=0.3, seed=seed)
    what = f"{select=} {batch=} {tdtype=} {backend=} {window=}"

    s = AlignedRMSF(u, select=select).run(backend="serial", **window)
    a = AlignedRMSF(u, select=select).run(**run)
    tol = 1e-3 if tdtype == "int16" else 2e-4
    np.testing.assert_allclose(a.results.rmsf, s.results.rmsf, atol=tol,
                               err_msg=f"AlignedRMSF {what}")

    ag = u.select_atoms(select)
    sr = RMSD(ag).run(backend="serial", **window)
    ar = RMSD(ag).run(**run)
    np.testing.assert_allclose(ar.results.rmsd, sr.results.rmsd, atol=tol,
                               err_msg=f"RMSD {what}")

    sf = RMSF(ag).run(backend="serial", **window)
    af = RMSF(ag).run(**run)
    np.testing.assert_allclose(af.results.rmsf, sf.results.rmsf, atol=tol,
                               err_msg=f"RMSF {what}")


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("seed", CASES)
def test_fused_and_collection_fuzz(seed, backend):
    """The fused engine (int16) and ``AnalysisCollection``'s union
    staging under the same random sweep, against the serial oracle."""
    rng = np.random.default_rng(2000 + seed)
    n_res, n_frames, batch, window, select = _draw(rng, seed)
    u = make_protein_universe(n_residues=n_res, n_frames=n_frames,
                              noise=0.3, seed=seed)
    what = f"{select=} {batch=} {backend=} {window=}"

    s = AlignedRMSF(u, select=select).run(backend="serial", **window)
    f = AlignedRMSF(u, select=select, engine="fused").run(
        **BACKENDS[backend], batch_size=batch, transfer_dtype="int16",
        **window)
    np.testing.assert_allclose(np.asarray(f.results.rmsf), s.results.rmsf,
                               atol=1e-3, err_msg=f"fused {what}")

    sel2 = str(rng.choice(["name CB", "protein", "name CA"]))
    coll = AnalysisCollection(RMSF(u.select_atoms(select)),
                              RMSF(u.select_atoms(sel2)))
    coll.run(**BACKENDS[backend], batch_size=batch, **window)
    s1 = RMSF(u.select_atoms(select)).run(backend="serial", **window)
    s2 = RMSF(u.select_atoms(sel2)).run(backend="serial", **window)
    np.testing.assert_allclose(
        np.asarray(coll.analyses[0].results.rmsf), s1.results.rmsf,
        atol=2e-4, err_msg=f"collection[0] {what}")
    np.testing.assert_allclose(
        np.asarray(coll.analyses[1].results.rmsf), s2.results.rmsf,
        atol=2e-4, err_msg=f"collection[1] {sel2=} {what}")


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("seed", CASES)
def test_coarse_wire_fuzz(seed, backend):
    """int8 and delta ``AlignedRMSF``, generic and fused, under the same
    sweep: within 5e-4 Å (delta 5e-3 Å) of the JAX package's run on
    the same wire (its single device for ``'torch'``, a two-device mesh
    of its virtual CPU devices for the two-shard mesh: the delta wire
    has one anchor a shard), and within the reference's int8 resolution
    of the serial oracle (``tests/test_int8_staging.py``: the coordinate
    range / 120)."""
    import jax

    from mdanalysis_mpi_tpu.analysis import AlignedRMSF as JAlignedRMSF
    from mdanalysis_mpi_tpu.parallel.executors import \
        MeshExecutor as JMeshExecutor
    from mdanalysis_mpi_tpu.testing import \
        make_protein_universe as jax_make_protein_universe

    rng = np.random.default_rng(3000 + seed)
    n_res, n_frames, batch, window, select = _draw(rng, seed)
    engine = rng.choice([None, "fused"])
    u = make_protein_universe(n_residues=n_res, n_frames=n_frames,
                              noise=0.3, seed=seed)
    ju = jax_make_protein_universe(n_residues=n_res, n_frames=n_frames,
                                   noise=0.3, seed=seed)
    s = AlignedRMSF(u, select=select).run(backend="serial", **window)
    resolution = float(np.abs(u.trajectory.coordinates).max()) / 120.0
    for wire in ("int8", "delta"):
        what = f"{wire=} {engine=} {select=} {batch=} {backend=} {window=}"
        run = dict(batch_size=batch, transfer_dtype=wire, **window)
        a = AlignedRMSF(u, select=select, engine=engine).run(
            **BACKENDS[backend], **run)
        if backend == "torch":
            j = JAlignedRMSF(ju, select=select, engine=engine).run(
                backend="jax", **run)
        else:
            j = JAlignedRMSF(ju, select=select, engine=engine).run(
                backend=JMeshExecutor(batch_size=batch,
                                      devices=jax.devices()[:2],
                                      transfer_dtype=wire), **window)
        np.testing.assert_allclose(a.results.rmsf,
                                   np.asarray(j.results.rmsf),
                                   atol=5e-3 if wire == "delta" else 5e-4,
                                   err_msg=f"same wire {what}")
        err = float(np.abs(a.results.rmsf - s.results.rmsf).max())
        assert err < resolution, f"oracle {what}: {err} >= {resolution}"
