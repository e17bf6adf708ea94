"""The port's ``LeafletFinder`` and ``optimize_cutoff`` against the JAX
package's on the same seeded bilayers (tests/test_leaflet.py and
test_nsgrid.py::TestConsumersRouted): EQUAL leaflet groups for every
capped-distance engine, the torch cell list on ``device="cpu"``
included, with and without PBC; the same cutoff from the scan; the same
errors.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mdanalysis_mpi_tpu.analysis import LeafletFinder as JLeafletFinder  # noqa: E402
from mdanalysis_mpi_tpu.analysis import (  # noqa: E402
    optimize_cutoff as joptimize_cutoff)
from mdanalysis_mpi_tpu.core.topology import Topology as JTopology  # noqa: E402
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402

from mdanalysis_mpi_tpu_torch.analysis import (LeafletFinder,  # noqa: E402
                                               optimize_cutoff)
from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402

PORT = (Topology, Universe, MemoryReader)
JAX = (JTopology, JUniverse, JMemoryReader)
ENGINES = ["auto", "nsgrid", "bruteforce", "torch"]


def _bilayer(pkg, nx=8, ny=8, sep=30.0, spacing=8.0, box=64.0, jitter=0.4,
             seed=11):
    """Two nx × ny headgroup sheets at z = 0 and z = sep."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij"),
                 -1).reshape(-1, 2) * spacing
    n = len(g)
    pos = np.zeros((2 * n, 3), np.float32)
    pos[:n, :2] = g
    pos[n:, :2] = g
    pos[n:, 2] = sep
    pos += rng.normal(scale=jitter, size=pos.shape).astype(np.float32)
    top = pkg[0](names=np.full(2 * n, "P"), resnames=np.full(2 * n, "POPC"),
                 resids=np.arange(1, 2 * n + 1))
    dims = (np.array([box, box, box, 90, 90, 90], np.float32)
            if box else None)
    return pkg[1](top, pkg[2](pos[None], dimensions=dims)), n


def _groups(lf):
    return [g.indices.tolist() for g in lf.groups()]


@pytest.mark.parametrize("pbc", [False, True], ids=["nopbc", "pbc"])
@pytest.mark.parametrize("engine", ENGINES)
def test_groups_equal_to_jax(engine, pbc):
    u, n = _bilayer(PORT)
    ju, _ = _bilayer(JAX)
    lf = LeafletFinder(u, "name P", cutoff=12.0, pbc=pbc, engine=engine,
                       device="cpu")
    jlf = JLeafletFinder(ju, "name P", cutoff=12.0, pbc=pbc,
                         engine="bruteforce")
    assert _groups(lf) == _groups(jlf)
    assert lf.sizes() == [n, n]


@pytest.mark.parametrize("engine", ["nsgrid", "torch"])
def test_pbc_merges_across_the_seam(engine):
    """A sheet wrapped across the boundary splits without PBC and stays
    whole with it, in both packages alike."""
    box = 60.0
    out = []
    for pkg in (PORT, JAX):
        u, n = _bilayer(pkg, nx=6, ny=6, box=box, jitter=0.0)
        ts = u.trajectory.ts
        ts.positions[:, 0] = (ts.positions[:, 0] + 30.0) % box
        kw = {"engine": engine, "device": "cpu"} if pkg is PORT else {
            "engine": "jax" if engine == "torch" else engine}
        out.append([LeafletFinder(u, "name P", cutoff=9.0, pbc=p, **kw)
                    if pkg is PORT else
                    JLeafletFinder(u, "name P", cutoff=9.0, pbc=p, **kw)
                    for p in (False, True)])
    for mine, ref in zip(*out):
        assert _groups(mine) == _groups(ref)
    assert out[0][1].sizes() == [36, 36]
    assert len(out[0][0].sizes()) > 2


def test_rerun_tracks_the_frame_and_validation():
    u, n = _bilayer(PORT, box=None)
    lf = LeafletFinder(u, "name P", cutoff=12.0)
    assert lf.groups(0).n_atoms == n
    u.trajectory.ts.positions[:, 2] = 0.0
    lf.run()
    assert len(lf.sizes()) == 1
    # a flat sheet leaves the torch cell list fewer than 3 cells along
    # z: it refuses, as the JAX package's device engine does
    with pytest.raises(ValueError, match="cannot serve"):
        LeafletFinder(u, "name P", cutoff=12.0, engine="torch",
                      device="cpu")
    with pytest.raises(ValueError, match="cutoff"):
        LeafletFinder(u, "name P", cutoff=0.0)
    with pytest.raises(ValueError, match="matches no atoms"):
        LeafletFinder(u, "name XX")
    with pytest.raises(ValueError, match="no box"):
        LeafletFinder(u, "name P", pbc=True)


@pytest.mark.parametrize("engine", ["auto", "torch"])
def test_optimize_cutoff_equal_to_jax(engine):
    u, n = _bilayer(PORT, nx=6, ny=6, box=None)
    ju, _ = _bilayer(JAX, nx=6, ny=6, box=None)
    got = optimize_cutoff(u, "name P", dmin=8.0, dmax=16.0, engine=engine,
                          device="cpu")
    assert got == joptimize_cutoff(ju, "name P", dmin=8.0, dmax=16.0)
    assert got[1] == 2
    small = optimize_cutoff(u, "name P", dmin=0.5, dmax=1.0)
    assert small == joptimize_cutoff(ju, "name P", dmin=0.5, dmax=1.0)
    with pytest.raises(ValueError, match="dmin"):
        optimize_cutoff(u, "name P", dmin=0.0)
