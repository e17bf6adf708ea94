"""The port's ``HydrogenBondAnalysis`` against the JAX package's on the
same seeded waters (the cases of tests/test_hbonds.py): per-frame
counts of the ``torch`` (``device="cpu"``), ``mesh`` and ``serial``
backends EQUAL to the JAX package's ``serial`` and ``jax`` counts; the
serial ``hbonds`` table and ``lifetime`` equal; the batch pair guard,
the validation errors, and a scan-folded repeat equal to per-block
dispatch.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu.analysis.hbonds import (  # noqa: E402
    HydrogenBondAnalysis as JHBA)
from mdanalysis_mpi_tpu.core.topology import Topology as JTopology  # noqa: E402
from mdanalysis_mpi_tpu.core.topology import (  # noqa: E402
    make_water_topology as jmake_water_topology)
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_water_universe as jmake_water_universe)

from mdanalysis_mpi_tpu_torch.analysis import HydrogenBondAnalysis  # noqa: E402
from mdanalysis_mpi_tpu_torch.analysis.hbonds import (  # noqa: E402
    _hbond_count_kernel)
from mdanalysis_mpi_tpu_torch.core.topology import (  # noqa: E402
    Topology, make_water_topology)
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel.executors import (  # noqa: E402
    DeviceBlockCache, TorchExecutor)
from mdanalysis_mpi_tpu_torch.testing import make_water_universe  # noqa: E402

PORT = (Topology, Universe, MemoryReader, make_water_topology)
JAX = (JTopology, JUniverse, JMemoryReader, jmake_water_topology)


def _dimer(pkg, angle_deg=180.0, d_a=2.8):
    """Water dimer: the donor's O-H points at the acceptor O along +x;
    the D-H-A angle is set by tilting the acceptor about the H."""
    oh = 0.96
    h = np.array([oh, 0.0, 0.0])
    th = np.radians(180.0 - angle_deg)
    a = h + (d_a - oh) * np.array([np.cos(th), np.sin(th), 0.0])
    pos = np.stack([[0.0, 0.0, 0.0], h, [-0.3, -0.9, 0.0], a,
                    a + [0.76, 0.59, 0.0],
                    a + [-0.76, 0.59, 0.0]]).astype(np.float32)
    return pkg[1](pkg[3](2), pkg[2](pos[None]))


def _waters(n_waters=27, n_frames=8, box=10.0, seed=0):
    return (make_water_universe(n_waters=n_waters, n_frames=n_frames,
                                box=box, seed=seed),
            jmake_water_universe(n_waters=n_waters, n_frames=n_frames,
                                 box=box, seed=seed))


class TestDimer:
    @pytest.mark.parametrize("angle, d_a, count", [
        (180.0, 2.8, 1.0), (120.0, 2.8, 0.0), (180.0, 3.5, 0.0)],
        ids=["ideal", "bent", "far"])
    def test_geometry_equal_to_jax(self, angle, d_a, count):
        u, ju = _dimer(PORT, angle, d_a), _dimer(JAX, angle, d_a)
        r = HydrogenBondAnalysis(u).run(backend="serial")
        j = JHBA(ju).run(backend="serial")
        np.testing.assert_array_equal(r.results.count, j.results.count)
        np.testing.assert_array_equal(r.results.hbonds, j.results.hbonds)
        assert r.results.count[0] == count
        t = HydrogenBondAnalysis(u).run(backend="torch", device="cpu")
        np.testing.assert_array_equal(t.results.count, [count])

    def test_looser_cutoff_finds_the_far_bond(self):
        u = _dimer(PORT, 180.0, 3.5)
        r = HydrogenBondAnalysis(u, d_a_cutoff=4.0).run(backend="torch",
                                                        device="cpu")
        assert r.results.count[0] == 1.0


class TestWaterBox:
    @pytest.mark.parametrize("backend", ["torch", "mesh", "serial"])
    def test_counts_equal_jax(self, backend):
        u, ju = _waters()
        kw = {"torch": dict(device="cpu", batch_size=4),
              "mesh": dict(devices=["cpu"] * 2, batch_size=4),
              "serial": {}}[backend]
        r = HydrogenBondAnalysis(u).run(backend=backend, **kw)
        js = JHBA(ju).run(backend="serial")
        jj = JHBA(ju).run(backend="jax", batch_size=4)
        counts = np.asarray(r.results.count)
        np.testing.assert_array_equal(counts, js.results.count)
        np.testing.assert_array_equal(counts, jj.results.count)
        assert counts.shape == (8,) and counts.sum() > 0

    @pytest.mark.parametrize("engine", ["auto", "nsgrid", "bruteforce",
                                        "torch"])
    def test_serial_table_equal_jax(self, engine):
        u, ju = _waters(n_waters=120, n_frames=3, box=15.0, seed=3)
        kw = dict(d_a_cutoff=3.5, d_h_a_angle_cutoff=90.0)
        r = HydrogenBondAnalysis(u, engine=engine, device="cpu",
                                 **kw).run(backend="serial")
        j = JHBA(ju, engine="jax" if engine == "torch" else engine,
                 **kw).run(backend="serial")
        np.testing.assert_array_equal(r.results.count, j.results.count)
        assert r.results.hbonds.shape == j.results.hbonds.shape
        np.testing.assert_array_equal(r.results.hbonds[:, :4],
                                      j.results.hbonds[:, :4])
        atol = 1e-6 if engine == "torch" else 0.0
        np.testing.assert_allclose(r.results.hbonds[:, 4:],
                                   j.results.hbonds[:, 4:], rtol=0,
                                   atol=atol)
        assert r.results.count.sum() > 0

    @pytest.mark.parametrize("tau_max, intermittency", [(3, 0), (5, 1),
                                                        (2, 2)])
    def test_lifetime_equal_jax(self, tau_max, intermittency):
        u, ju = _waters(n_waters=64, n_frames=8, box=12.4, seed=6)
        kw = dict(d_a_cutoff=3.5, d_h_a_angle_cutoff=120.0)
        r = HydrogenBondAnalysis(u, **kw).run(backend="serial")
        j = JHBA(ju, **kw).run(backend="serial")
        taus, c = r.lifetime(tau_max=tau_max, intermittency=intermittency)
        jtaus, jc = j.lifetime(tau_max=tau_max, intermittency=intermittency)
        np.testing.assert_array_equal(taus, jtaus)
        np.testing.assert_array_equal(c, jc)
        assert c[0] == 1.0

    def test_lifetime_needs_the_serial_table(self):
        u, _ = _waters(n_frames=4)
        r = HydrogenBondAnalysis(u).run(backend="torch", device="cpu",
                                        batch_size=2)
        with pytest.raises(ValueError, match="serial"):
            r.lifetime()
        s = HydrogenBondAnalysis(u).run(backend="serial")
        with pytest.raises(ValueError, match="tau_max"):
            s.lifetime(tau_max=-1)
        with pytest.raises(ValueError, match="intermittency"):
            s.lifetime(intermittency=-1)

    def test_bonds_pairing_matches_heuristic(self):
        u, _ = _waters(n_waters=8, n_frames=2, box=8.0)
        r_heur = HydrogenBondAnalysis(u).run(backend="torch", device="cpu")
        t = u.topology
        bonds = [(3 * w, 3 * w + k) for w in range(8) for k in (1, 2)]
        t2 = Topology(names=t.names, resnames=t.resnames, resids=t.resids,
                      segids=t.segids, bonds=np.array(bonds))
        block, _ = u.trajectory.read_block(0, 2)
        u2 = Universe(t2, MemoryReader(
            block, dimensions=u.trajectory.ts.dimensions))
        r_bond = HydrogenBondAnalysis(u2).run(backend="torch", device="cpu")
        np.testing.assert_array_equal(r_bond.results.count,
                                      r_heur.results.count)

    def test_acceptors_selection_and_apolar_hydrogens(self):
        u, ju = _waters(n_frames=2)
        sel = "name OW and resid 1:5"
        few = HydrogenBondAnalysis(u, acceptors_sel=sel).run(
            backend="torch", device="cpu")
        np.testing.assert_array_equal(
            few.results.count,
            JHBA(ju, acceptors_sel=sel).run(backend="serial").results.count)
        names = np.array(["C", "HC", "OW", "HW1", "HW2"])
        pos = np.array([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                         [2.8, 0.0, 0.0], [3.2, 0.9, 0.0],
                         [3.2, -0.9, 0.0]]], np.float32)
        top = Topology(names=names,
                       resnames=np.array(["LIG"] * 2 + ["SOL"] * 3),
                       resids=np.array([1, 1, 2, 2, 2]),
                       bonds=np.array([(0, 1), (2, 3), (2, 4)]))
        lig = Universe(top, MemoryReader(pos))
        assert HydrogenBondAnalysis(lig).run(
            backend="torch", device="cpu").results.count[0] == 0.0
        assert HydrogenBondAnalysis(lig, hydrogens_sel="name HC").run(
            backend="torch", device="cpu").results.count[0] == 1.0

    def test_batch_pair_guard(self, monkeypatch):
        u, _ = _waters(n_waters=8, n_frames=2)
        assert HydrogenBondAnalysis.MAX_BATCH_PAIRS == 25_000_000
        monkeypatch.setattr(HydrogenBondAnalysis, "MAX_BATCH_PAIRS", 10)
        with pytest.raises(ValueError, match="candidate pairs"):
            HydrogenBondAnalysis(u).run(backend="torch", device="cpu",
                                        batch_size=2)
        HydrogenBondAnalysis(u).run(backend="serial")

    def test_validation(self):
        u, _ = _waters(n_waters=4, n_frames=1)
        with pytest.raises(ValueError, match="no atoms"):
            HydrogenBondAnalysis(u, hydrogens_sel="name XX").run(
                backend="serial")
        with pytest.raises(ValueError, match="heavy"):
            HydrogenBondAnalysis(u, hydrogens_sel="name OW").run(
                backend="serial")
        with pytest.raises(ValueError, match="acceptor"):
            HydrogenBondAnalysis(u, acceptors_sel="name ZZ").run(
                backend="serial")

    def test_count_is_deferred_and_scan_fold_equal(self):
        """The count stays a Deferred over device values; a cached
        repeat folded into one group (``scan_k='auto'``) equals the
        per-block run."""
        u, _ = _waters(n_waters=27, n_frames=12)
        per_block = HydrogenBondAnalysis(u).run(
            backend=TorchExecutor(device="cpu", batch_size=4,
                                  block_cache=DeviceBlockCache(),
                                  scan_k=1))
        from mdanalysis_mpi_tpu_torch.analysis.base import Deferred

        assert isinstance(per_block.results["count"], Deferred)
        cache = DeviceBlockCache()
        exe = TorchExecutor(device="cpu", batch_size=4, block_cache=cache,
                            scan_k="auto")
        first = HydrogenBondAnalysis(u).run(backend=exe)
        repeat = HydrogenBondAnalysis(u).run(backend=exe)
        for r in (first, repeat):
            np.testing.assert_array_equal(r.results.count,
                                          per_block.results.count)

    def test_batch_function_frame_by_frame(self):
        """The module-level batch function on a hand-built batch: masked
        frames give 0, the rest equal the serial count."""
        u, _ = _waters(n_frames=3)
        h = HydrogenBondAnalysis(u)
        h._frame_indices = [0, 1, 2]
        h._prepare()
        params = h._batch_params()
        block, _ = u.trajectory.read_block(0, 3)
        batch = torch.as_tensor(block[:, h._idx])
        boxes = torch.as_tensor(np.tile(u.trajectory.ts.dimensions,
                                        (3, 1)))
        mask = torch.tensor([1.0, 1.0, 0.0])
        counts, m = _hbond_count_kernel(params, batch, boxes, mask)
        serial = HydrogenBondAnalysis(u).run(backend="serial").results.count
        np.testing.assert_array_equal(counts.numpy(),
                                      np.asarray(serial) * mask.numpy())
        assert counts.dtype == torch.float32 and m is mask
