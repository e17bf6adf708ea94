"""Twin of ``tests/test_atomicdistances.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

AtomicDistances (upstream ``analysis.atomicdistances``): paired
per-atom distances with minimum image, hand-placed fixtures + backend
parity."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import AtomicDistances
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    both, mesh_kw, port_runs_on_the_cpu)


def _universe(box=10.0):
    # 2 pairs: (0<->2) separated 9 along x (min image 1), (1<->3) by 3
    pos = np.zeros((2, 4, 3), np.float32)
    pos[:, 2, 0] = 9.0
    pos[:, 3, 1] = 3.0
    pos[1, 2, 0] = 8.0                  # frame 1: pair 0 at 8 -> image 2
    dims = (np.array([box, box, box, 90, 90, 90], np.float32)
            if box else None)
    top = Topology(names=np.array(["A", "B", "C", "D"]),
                   resnames=np.full(4, "X"), resids=np.arange(1, 5))
    return Universe(top, MemoryReader(pos, dimensions=dims))


def test_hand_computed_with_pbc():
    u = _universe()
    ag1, ag2 = u.atoms[[0, 1]], u.atoms[[2, 3]]
    r = AtomicDistances(ag1, ag2).run(backend="serial")
    np.testing.assert_allclose(r.results.distances,
                               [[1.0, 3.0], [2.0, 3.0]], atol=1e-6)
    # pbc=False sees the raw separation
    raw = AtomicDistances(ag1, ag2, pbc=False).run(backend="serial")
    np.testing.assert_allclose(raw.results.distances,
                               [[9.0, 3.0], [8.0, 3.0]], atol=1e-6)


def test_backend_parity():
    u = _universe()
    ag1, ag2 = u.atoms[[0, 1]], u.atoms[[2, 3]]
    for pbc in (True, False):
        s = AtomicDistances(ag1, ag2, pbc=pbc).run(backend="serial")
        for backend in ("torch", "mesh"):
            b = AtomicDistances(ag1, ag2, pbc=pbc).run(
                **mesh_kw(backend), batch_size=1)
            np.testing.assert_allclose(np.asarray(b.results.distances),
                                       s.results.distances, atol=1e-5)


def test_validation():
    u = _universe()
    with pytest.raises(ValueError, match="atom-by-atom"):
        AtomicDistances(u.atoms[[0]], u.atoms[[1, 2]])
    with pytest.raises(ValueError, match="empty"):
        AtomicDistances(u.atoms[[]], u.atoms[[]])
    u2 = _universe()
    with pytest.raises(ValueError, match="universe"):
        AtomicDistances(u.atoms[[0]], u2.atoms[[1]])
    uag = u.select_atoms("name A", updating=True)
    with pytest.raises(TypeError, match="UpdatingAtomGroup"):
        AtomicDistances(uag, u.atoms[[1]])


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("pbc", [True, False])
def test_atomic_distances_match_jax_package(pbc):
    def case(mod):
        u = mod("testing").make_water_universe(n_waters=20, n_frames=5,
                                               seed=4)
        ow, hw = u.select_atoms("name OW"), u.select_atoms("name HW1")
        r = mod("analysis").AtomicDistances(ow, hw, pbc=pbc).run(
            backend="jax" if mod().__name__ == "mdanalysis_mpi_tpu"
            else "torch", batch_size=2)
        return np.asarray(r.results.distances)
    ref, port = both(case)
    np.testing.assert_allclose(port, ref, atol=1e-5)
