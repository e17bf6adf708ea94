"""The port's RMSD series (BASELINE config 3) on ``device="cpu"``
against the JAX package and the serial float64 oracle.

Both packages build the same universe from the same seed (the port's
``testing`` module is a copy of the JAX package's), so both stage the
same float32 (or int16) bytes.  Tolerances: the port's torch backend
against the JAX package's ``backend="jax"`` on those bytes within
1e-5 Å; against the serial oracle at ``rtol=1e-3, atol=2e-4`` (the JAX
package's own gate, tests/test_analysis.py); the one-shot host
``rmsd()`` to 1e-10 (float64 on both sides).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mdanalysis_mpi_tpu.analysis import RMSD as JRMSD  # noqa: E402
from mdanalysis_mpi_tpu.analysis import rmsd as jrmsd  # noqa: E402
from mdanalysis_mpi_tpu.ops import rmsd as jops  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

from mdanalysis_mpi_tpu_torch.analysis import RMSD, rmsd  # noqa: E402
from mdanalysis_mpi_tpu_torch.analysis.rms import _real_frames  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import rmsd as ops  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import (  # noqa: E402
    make_protein_universe, random_rotation_matrices)

FIXTURE = dict(n_residues=12, n_frames=30, noise=0.25, seed=3)
CPU = dict(backend="torch", device="cpu")


@pytest.fixture(scope="module")
def uni():
    return make_protein_universe(**FIXTURE)


@pytest.fixture(scope="module")
def juni():
    return jax_make_protein_universe(**FIXTURE)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("select,weights,superposition", [
    ("protein and name CA", None, True),
    ("name CA C N", "mass", True),
    ("name CA", None, False),
])
def test_rmsd_series_matches_jax_and_oracle(uni, juni, dtype, select,
                                            weights, superposition):
    kw = dict(select=select, weights=weights, superposition=superposition)
    run = dict(batch_size=8, transfer_dtype=dtype)
    port = RMSD(uni, **kw).run(**CPU, **run)
    raw = port.results["rmsd"]
    assert isinstance(raw, torch.Tensor) and raw.shape == (30,)
    ref = JRMSD(juni, **kw).run(backend="jax", **run)
    np.testing.assert_allclose(port.results.rmsd,
                               np.asarray(ref.results.rmsd), atol=1e-5)
    oracle = RMSD(uni, **kw).run(backend="serial").results.rmsd
    j_oracle = JRMSD(juni, **kw).run(backend="serial").results.rmsd
    np.testing.assert_allclose(oracle, j_oracle, rtol=1e-12, atol=1e-12)
    if dtype == "float32":
        np.testing.assert_allclose(port.results.rmsd, oracle, rtol=1e-3,
                                   atol=2e-4)


def test_rmsd_superposition_removes_rigid_motion():
    u = make_protein_universe(n_residues=10, n_frames=8, noise=0.0)
    fitted = RMSD(u, select="name CA", superposition=True).run(**CPU)
    raw = RMSD(u, select="name CA", superposition=False).run(**CPU)
    np.testing.assert_allclose(fitted.results.rmsd, 0.0, atol=1e-3)
    assert raw.results.rmsd[1:].min() > 1.0
    assert raw.results.rmsd[0] == pytest.approx(0.0, abs=1e-4)


def test_rmsd_mass_weighted(uni):
    mw = RMSD(uni, select="name CA C N", weights="mass").run(**CPU)
    uw = RMSD(uni, select="name CA C N").run(**CPU)
    assert mw.results.rmsd.shape == uw.results.rmsd.shape
    assert not np.allclose(mw.results.rmsd[1:], uw.results.rmsd[1:])


def test_rmsd_atomgroup_select_refines_within_group(uni):
    """RMSD(group, select=...) must stay restricted to the group."""
    half = uni.atoms[: uni.topology.n_atoms // 2]
    r = RMSD(half, select="name CA")
    r._prepare()
    assert set(r._idx).issubset(set(half.indices))
    assert len(r._idx) < len(uni.select_atoms("name CA").indices)


def test_rmsd_atomgroup_input(uni, juni):
    r = RMSD(uni.select_atoms("name CA")).run(**CPU, batch_size=7)
    r2 = RMSD(uni, select="name CA").run(backend="serial")
    np.testing.assert_allclose(r.results.rmsd, r2.results.rmsd, rtol=1e-3,
                               atol=2e-4)
    j = JRMSD(juni.select_atoms("name CA")).run(backend="jax", batch_size=7)
    np.testing.assert_allclose(r.results.rmsd, np.asarray(j.results.rmsd),
                               atol=1e-5)


def test_rmsd_frame_window_and_uneven_last_block(uni, juni):
    """A strided window, 10 frames at batch 4: the last block carries two
    padded frames, and the series keeps exactly the real ones."""
    port = RMSD(uni, select="name CA").run(start=1, step=3, batch_size=4,
                                           **CPU)
    ref = JRMSD(juni, select="name CA").run(start=1, step=3, batch_size=4,
                                            backend="jax")
    assert port.results.rmsd.shape == (10,)
    np.testing.assert_allclose(port.results.rmsd,
                               np.asarray(ref.results.rmsd), atol=1e-5)
    zero = RMSD(uni, select="name CA").run(start=4, stop=4, **CPU)
    assert zero.results.rmsd.shape == (0,)


def test_real_frames_keeps_masked_rows_in_order():
    """The device-side mask filter equals boolean indexing, also for
    padding between real frames."""
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    got = _real_frames(x, mask, 4)
    assert torch.equal(got, x[mask > 0.5])
    np.testing.assert_array_equal(_real_frames(x.numpy(), mask.numpy(), 4),
                                  x.numpy()[mask.numpy() > 0.5])


def _group_universe(pkg_topology, pkg_universe, pkg_memory):
    """A main selection and a rigid rider moving as one body; a mover
    drifting on its own (tests/test_analysis.py's groupselections
    case)."""
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
        body = np.concatenate([main0, rigid0])
        pos[f, :n_main + n_g] = body @ rots[f].T + trans[f]
        pos[f, n_main + n_g:] = (mover0 @ rots[f].T + trans[f]
                                 + [0, 0, 2.0 * f])
    names = np.array(["CA"] * n_main + ["CB"] * n_g + ["CG"] * n_g)
    top = pkg_topology(names=names, resnames=np.full(len(names), "ALA"),
                       resids=np.arange(1, len(names) + 1))
    return pkg_universe(top, pkg_memory(pos))


def test_groupselections_rigid_companion_vs_mover():
    from mdanalysis_mpi_tpu.core.topology import Topology as JTopology
    from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse
    from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader

    u = _group_universe(Topology, Universe, MemoryReader)
    ju = _group_universe(JTopology, JUniverse, JMemoryReader)
    kw = dict(select="name CA", groupselections=["name CB", "name CG"])
    r = RMSD(u, **kw).run(backend="serial")
    g = r.results.group_rmsd
    assert g.shape == (6, 2)
    np.testing.assert_allclose(g[:, 0], 0.0, atol=1e-4)   # rigid rider
    assert g[1:, 1].min() > 1.0                           # the mover
    np.testing.assert_allclose(r.results.rmsd, 0.0, atol=1e-4)
    b = RMSD(u, **kw).run(**CPU, batch_size=4)
    assert isinstance(b.results["group_rmsd"], torch.Tensor)
    np.testing.assert_allclose(b.results.group_rmsd, g, atol=1e-3)
    np.testing.assert_allclose(b.results.rmsd, r.results.rmsd, atol=1e-3)
    j = JRMSD(ju, **kw).run(backend="jax", batch_size=4)
    np.testing.assert_allclose(b.results.group_rmsd,
                               np.asarray(j.results.group_rmsd), atol=1e-5)
    np.testing.assert_allclose(b.results.rmsd, np.asarray(j.results.rmsd),
                               atol=1e-5)
    js = JRMSD(ju, **kw).run(backend="serial")
    np.testing.assert_allclose(g, js.results.group_rmsd, atol=1e-12)


def test_groupselections_on_a_protein_match_jax(uni, juni):
    kw = dict(select="name CA", groupselections=["name CB", "name N C"])
    port = RMSD(uni, **kw).run(**CPU, batch_size=8)
    ref = JRMSD(juni, **kw).run(backend="jax", batch_size=8)
    assert port.results.group_rmsd.shape == (30, 2)
    np.testing.assert_allclose(port.results.group_rmsd,
                               np.asarray(ref.results.group_rmsd), atol=1e-5)
    oracle = RMSD(uni, **kw).run(backend="serial")
    np.testing.assert_allclose(port.results.group_rmsd,
                               oracle.results.group_rmsd, rtol=1e-3,
                               atol=2e-4)


def test_groupselections_validation():
    u = make_protein_universe(n_residues=6, n_frames=4)
    with pytest.raises(ValueError, match="superposition"):
        RMSD(u, select="name CA", superposition=False,
             groupselections=["name CB"])
    with pytest.raises(ValueError, match="matched no atoms"):
        RMSD(u, select="name CA",
             groupselections=["name ZZ"]).run(backend="serial")
    with pytest.raises(ValueError, match="weights"):
        RMSD(u, weights="charge")
    with pytest.raises(ValueError, match="matched no atoms"):
        RMSD(u, select="name ZZ").run(**CPU)


@pytest.mark.parametrize("center,superposition,weighted", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, True, True), (True, True, True),
])
def test_one_shot_rmsd_matches_jax(center, superposition, weighted):
    rng = np.random.default_rng(7)
    a = rng.normal(scale=5.0, size=(40, 3))
    b = a @ random_rotation_matrices(1, rng)[0].T + [1.0, -2.0, 0.5]
    b += rng.normal(scale=0.3, size=b.shape)
    w = rng.uniform(1.0, 16.0, size=40) if weighted else None
    got = rmsd(a, b, w, center=center, superposition=superposition)
    want = jrmsd(a, b, w, center=center, superposition=superposition)
    assert abs(got - want) <= 1e-10
    with pytest.raises(ValueError, match="N, 3"):
        rmsd(a, b[:5])
    with pytest.raises(ValueError, match="weights"):
        rmsd(a, b, np.ones(3))


@pytest.mark.parametrize("superposition", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_rmsd_batch_matches_jax(superposition, weighted):
    rng = np.random.default_rng(11)
    S, B = 64, 9
    ref = rng.normal(scale=6.0, size=(S, 3))
    masses = rng.uniform(1.0, 16.0, size=S)
    ref_c = ref - (ref * (masses / masses.sum())[:, None]).sum(0)
    rots = random_rotation_matrices(B, rng)
    coords = (np.einsum("ni,bji->bnj", ref, rots)
              + rng.normal(scale=4.0, size=(B, 1, 3))
              + rng.normal(scale=0.4, size=(B, S, 3))).astype(np.float32)
    rw = masses if weighted else None
    args = (coords, masses, ref_c)
    got = ops.rmsd_batch(
        *(torch.as_tensor(x, dtype=torch.float32) for x in args),
        superposition=superposition,
        rot_weights=None if rw is None else torch.as_tensor(
            rw, dtype=torch.float32),
        rmsd_weights=None if rw is None else torch.as_tensor(
            rw, dtype=torch.float32))
    want = jops.rmsd_batch(
        *(jnp.asarray(x, jnp.float32) for x in args),
        superposition=superposition,
        rot_weights=None if rw is None else jnp.asarray(rw, jnp.float32),
        rmsd_weights=None if rw is None else jnp.asarray(rw, jnp.float32))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
