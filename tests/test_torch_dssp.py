"""The port's DSSP (``analysis/dssp.py``): the JAX package's
tests/test_dssp.py case by case (the host pattern rules are a copy, the
H-bond map a batch function of torch ops) on ``backend="torch",
device="cpu"`` and a two-shard CPU mesh — maps and letters equal to the
serial float64 oracle's — and the same seeded frames through the JAX
package's ``backend="jax"`` and the port: letters agreeing at ≥ 0.98
of the residues (the suite's gate, the −0.5 kcal/mol cut flips in
float32) and equal on this fixture."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import DSSP
from mdanalysis_mpi_tpu_torch.analysis.dssp import (
    _hbond_map_np, assign_from_hbond_map,
)
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

#: the port's batch backends on the CPU: ``'torch'`` on one device and
#: the mesh over two CPU shards (the JAX package's ``'jax'`` and
#: ``'mesh'``)
TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 2)
BK = {"jax": TORCH, "torch": TORCH, "mesh": MESH,
      "serial": dict(backend="serial")}


def _backbone_universe(n_res, n_frames=1, seed=0, coords=None):
    names = np.tile(np.array(["N", "CA", "C", "O"]), n_res)
    top = Topology(names=names,
                   resnames=np.full(4 * n_res, "ALA"),
                   resids=np.repeat(np.arange(1, n_res + 1), 4))
    if coords is None:
        rng = np.random.default_rng(seed)
        coords = rng.normal(scale=6.0, size=(n_frames, 4 * n_res, 3))
    return Universe(top, MemoryReader(np.asarray(coords, np.float32)))


def test_kabsch_sander_energy_geometry():
    """An ideal linear N-H...O=C geometry H-bonds; a distant one does
    not.  Residues i=0..: donor NH(4) -> acceptor CO(0)."""
    n_res = 6
    pos = np.zeros((4 * n_res, 3))
    # place residues on a line, far apart by default
    for r in range(n_res):
        base = np.array([30.0 * r, 200.0, 0.0])
        pos[4 * r + 0] = base                    # N
        pos[4 * r + 1] = base + [1.2, 0.8, 0.0]  # CA
        pos[4 * r + 2] = base + [2.4, 0.0, 0.0]  # C
        pos[4 * r + 3] = base + [2.4, -1.2, 0.0] # O
    # now craft residue 4's N-H pointing straight at residue 0's O=C:
    # O at origin, C behind it, N at 2.9 A in front, prev C/CA behind N
    pos[4 * 0 + 2] = [0.0, 1.23, 0.0]            # C0
    pos[4 * 0 + 3] = [0.0, 0.0, 0.0]             # O0
    pos[4 * 4 + 0] = [0.0, -2.9, 0.0]            # N4
    pos[4 * 4 + 1] = [1.2, -3.7, 0.0]            # CA4 (behind)
    pos[4 * 3 + 2] = [-1.2, -3.7, 0.0]           # C3 (behind N4)
    hb = _hbond_map_np(pos[0::4], pos[1::4], pos[2::4], pos[3::4])
    assert hb[4, 0]                              # the crafted bond
    assert hb.sum() == 1                         # nothing else bonds
    # local pairs are never counted even if close
    assert not hb[1, 0] and not hb[0, 0]


def test_assignment_helix_ladder():
    """Consecutive i+4 -> i turns (the alpha-helix signature) mark the
    spanned residues 'H'."""
    n = 12
    hb = np.zeros((n, n), dtype=bool)
    for i in range(0, 6):                        # turns at 0..5
        hb[i + 4, i] = True
    out = assign_from_hbond_map(hb)
    # consecutive turn pairs start marking at i=1: residues 1..8
    assert "".join(out) == "-HHHHHHHH---"


def test_assignment_antiparallel_bridge():
    """The antiparallel double-bond pattern hb[i,j] & hb[j,i] marks
    both residues 'E'."""
    n = 10
    hb = np.zeros((n, n), dtype=bool)
    hb[2, 7] = hb[7, 2] = True
    out = assign_from_hbond_map(hb)
    assert out[2] == "E" and out[7] == "E"
    assert (out[[0, 1, 3, 4, 5, 6, 8, 9]] == "-").all()


def test_assignment_parallel_bridge():
    n = 12
    hb = np.zeros((n, n), dtype=bool)
    # parallel bridge (i=3, j=8): hb[2, 8] & hb[8, 4]
    hb[2, 8] = hb[8, 4] = True
    out = assign_from_hbond_map(hb)
    assert out[3] == "E" and out[8] == "E"


def test_no_bonds_is_all_loop():
    out = assign_from_hbond_map(np.zeros((7, 7), dtype=bool))
    assert (out == "-").all()


def test_backend_parity_and_surface():
    u = _backbone_universe(n_res=8, n_frames=5, seed=3)
    s = DSSP(u).run(backend="serial")
    assert s.results.dssp.shape == (5, 8)
    assert set(np.unique(s.results.dssp)) <= {"H", "E", "-"}
    j = DSSP(u).run(**TORCH, batch_size=2)
    np.testing.assert_array_equal(j.results.dssp, s.results.dssp)
    np.testing.assert_array_equal(j.results.hbond_maps,
                                  s.results.hbond_maps)
    m = DSSP(u).run(**MESH, batch_size=2)
    np.testing.assert_array_equal(m.results.dssp, s.results.dssp)


def test_validation():
    u = _backbone_universe(n_res=3)
    with pytest.raises(ValueError, match="at least 5"):
        DSSP(u).run(backend="serial")
    # a residue missing its O
    names = np.array(["N", "CA", "C", "O"] * 4 + ["N", "CA", "C"])
    top = Topology(names=names, resnames=np.full(len(names), "ALA"),
                   resids=np.repeat(np.arange(1, 6),
                                    [4, 4, 4, 4, 3]))
    um = Universe(top, MemoryReader(
        np.zeros((1, len(names), 3), np.float32)))
    with pytest.raises(ValueError, match="lacks backbone"):
        DSSP(um).run(backend="serial")
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    w = make_water_universe(n_waters=5, n_frames=1)
    with pytest.raises(ValueError, match="protein"):
        DSSP(w).run(backend="serial")


def test_chain_break_refused():
    """Multi-segment or resid-gapped selections must be refused loudly
    (the pattern algebra treats row order as sequence order)."""
    names = np.tile(np.array(["N", "CA", "C", "O"]), 10)
    # two 5-residue chains as segments A and B
    top = Topology(names=names, resnames=np.full(40, "ALA"),
                   resids=np.tile(np.arange(1, 6), 2).repeat(4)[:40],
                   segids=np.repeat(["A", "B"], 20))
    top2 = Topology(names=names, resnames=np.full(40, "ALA"),
                    resids=np.repeat([1, 2, 3, 4, 5, 6, 7, 8, 9, 20], 4))
    rng = np.random.default_rng(1)
    pos = rng.normal(scale=6.0, size=(1, 40, 3)).astype(np.float32)
    u1 = Universe(top, MemoryReader(pos))
    with pytest.raises(ValueError, match="single chain"):
        DSSP(u1).run(backend="serial")
    u2 = Universe(top2, MemoryReader(pos))
    with pytest.raises(ValueError, match="contiguous resids"):
        DSSP(u2).run(backend="serial")


def test_empty_run_and_resindices():
    u = _backbone_universe(n_res=6, n_frames=3)
    r = DSSP(u).run(backend="serial", stop=0)
    assert r.results.dssp.shape == (0, 6)
    full = DSSP(u).run(backend="serial")
    np.testing.assert_array_equal(full.results.resindices,
                                  np.arange(6))


# ---------------- against the JAX package ----------------

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from mdanalysis_mpi_tpu.analysis import DSSP as JDSSP  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("backend", ["torch", "mesh"])
def test_port_matches_jax_package(backend):
    kw = dict(n_residues=16, n_frames=6, noise=0.3, seed=2)
    u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    p = DSSP(u).run(**BK[backend], batch_size=4)
    j = JDSSP(ju).run(backend="jax", batch_size=4)
    agree = (p.results.dssp == np.asarray(j.results.dssp)).mean()
    assert agree >= 0.98
    np.testing.assert_array_equal(p.results.dssp, j.results.dssp)
    np.testing.assert_array_equal(p.results.hbond_maps,
                                  j.results.hbond_maps)
    np.testing.assert_array_equal(p.results.resindices,
                                  j.results.resindices)


@pytest.mark.parametrize("n", [5, 7, 12, 40, 120])
@pytest.mark.parametrize("density", [0.01, 0.05, 0.3])
def test_assignment_equals_jax_package(n, density):
    """The port's pattern rules (shifted slices of the map) assign the
    same letters as the JAX package's (index arrays) on random maps."""
    from mdanalysis_mpi_tpu.analysis.dssp import (
        assign_from_hbond_map as jax_assign)

    rng = np.random.default_rng(n * 1000 + int(density * 100))
    for _ in range(10):
        hb = rng.random((n, n)) < density
        np.testing.assert_array_equal(assign_from_hbond_map(hb),
                                      jax_assign(hb))
