"""Twin of ``tests/test_nsgrid.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Cell-list neighbor search: host (lib.nsgrid) and device
(ops.neighbors) engines must emit IDENTICAL pair/distance sets to the
brute-force path — ortho + triclinic boxes, cutoff ≈ cell edge, atoms
exactly on cell boundaries, empty selections, capacity-overflow retry,
and agreement through the 8-virtual-device mesh path (conftest).  The
port's device engine is ``engine="torch"``; the consumers run it beside
the host engines."""

import numpy as np

from mdanalysis_mpi_tpu_torch.lib.distances import self_capped_distance

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    port_runs_on_the_cpu)


class TestTorchEngineMesh:
    """The reference's ``TestHostGridParity`` and ``TestJaxEngineParity``
    cases are twinned in ``tests/test_torch_neighbors.py``
    (``TestHostEnginesEqualJax``, ``TestTorchEngine``); what it lacks is
    the mesh path."""

    def test_mesh_path_agreement(self):
        """The batched count kernel over four CPU shards of the frame
        axis (the mesh's split, ``executors._split_staged``): per-frame
        counts agree with the host brute-force engine."""
        import torch

        from mdanalysis_mpi_tpu_torch.ops import neighbors
        from mdanalysis_mpi_tpu_torch.parallel.executors import _split_staged

        rng = np.random.default_rng(10)
        B, N = 8, 120
        coords = rng.uniform(0, 20, size=(B, N, 3)).astype(np.float32)
        boxes = np.tile(np.array([20.0, 20, 20, 90, 90, 90],
                                 np.float32), (B, 1))
        mask = np.ones(B, np.float32)
        shards = _split_staged((coords, boxes, mask), 4, planar=False)
        assert len(shards) == 4
        out = [neighbors.self_pair_counts(
            *(torch.as_tensor(x) for x in shard), 4.0, (4, 4, 4), 16)
            for shard in shards]
        counts = torch.cat([c for c, _ in out])
        assert not any(bool(o.any()) for _, o in out)
        host = [len(self_capped_distance(coords[f], 4.0, box=boxes[f],
                                         engine="bruteforce")[0])
                for f in range(B)]
        np.testing.assert_array_equal(counts.numpy(),
                                      np.asarray(host, np.float32))


class TestConsumersRouted:
    """The pair-pruning consumers accept the engine knob and produce
    engine-independent results."""

    def _bilayer_universe(self):
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        rng = np.random.default_rng(11)
        g = np.stack(np.meshgrid(np.arange(8), np.arange(8),
                                 indexing="ij"), -1).reshape(-1, 2) * 8.0
        n = len(g)
        pos = np.zeros((2 * n, 3), np.float32)
        pos[:n, :2] = g
        pos[n:, :2] = g
        pos[n:, 2] = 30.0
        pos += rng.normal(scale=0.4, size=pos.shape).astype(np.float32)
        top = Topology(names=np.full(2 * n, "P"),
                       resnames=np.full(2 * n, "POPC"),
                       resids=np.arange(1, 2 * n + 1))
        dims = np.array([64.0, 64.0, 64.0, 90, 90, 90], np.float32)
        return Universe(top, MemoryReader(pos[None], dimensions=dims))

    def test_leaflet_engines_agree(self):
        from mdanalysis_mpi_tpu_torch.analysis import LeafletFinder

        u = self._bilayer_universe()
        sizes = {}
        for engine in ("bruteforce", "nsgrid", "auto", "torch"):
            lf = LeafletFinder(u, "name P", cutoff=12.0, pbc=True,
                               engine=engine)
            sizes[engine] = lf.sizes()
            groups = [g.indices.tolist() for g in lf.groups()]
            if engine == "bruteforce":
                ref_groups = groups
            else:
                assert groups == ref_groups
        assert (sizes["bruteforce"] == sizes["nsgrid"] == sizes["auto"]
                == sizes["torch"])
        assert len(sizes["auto"]) == 2

    def test_guess_bonds_engines_agree(self):
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        def water_grid():
            rng = np.random.default_rng(12)
            n_w = 64
            cell = np.stack(np.meshgrid(*[np.arange(4)] * 3,
                                        indexing="ij"), -1
                            ).reshape(-1, 3) * 4.0
            pos = np.zeros((3 * n_w, 3), np.float32)
            pos[0::3] = cell
            pos[1::3] = cell + [0.96, 0.0, 0.0]
            pos[2::3] = cell + [-0.24, 0.93, 0.0]
            pos += rng.normal(scale=0.02, size=pos.shape).astype(
                np.float32)
            names = np.tile(np.array(["OW", "HW1", "HW2"]), n_w)
            top = Topology(names=names,
                           resnames=np.full(3 * n_w, "SOL"),
                           resids=np.repeat(np.arange(1, n_w + 1), 3))
            dims = np.array([16.0, 16, 16, 90, 90, 90], np.float32)
            return Universe(top, MemoryReader(pos[None],
                                              dimensions=dims))

        bonds = {}
        for engine in ("bruteforce", "nsgrid", "torch"):
            u = water_grid()
            got = u.atoms.guess_bonds(engine=engine)
            bonds[engine] = sorted(map(tuple, got.tolist()))
        assert bonds["bruteforce"] == bonds["nsgrid"] == bonds["torch"]
        assert len(bonds["nsgrid"]) == 128          # 2 O-H bonds/water

    def test_hbonds_engines_agree(self):
        from mdanalysis_mpi_tpu_torch.analysis.hbonds import (
            HydrogenBondAnalysis)
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        u = make_water_universe(n_waters=120, n_frames=3, seed=3)
        runs = {}
        for engine in ("bruteforce", "nsgrid", "auto"):
            # relaxed geometric criteria so the random fixture yields a
            # NONZERO bond table — an all-zero run would pass parity
            # vacuously
            r = HydrogenBondAnalysis(u, d_a_cutoff=3.5,
                                     d_h_a_angle_cutoff=90.0,
                                     engine=engine).run(backend="serial")
            runs[engine] = (np.asarray(r.results.count),
                            np.asarray(r.results.hbonds))
        assert runs["bruteforce"][0].sum() > 0
        for engine in ("nsgrid", "auto"):
            np.testing.assert_array_equal(runs[engine][0],
                                          runs["bruteforce"][0])
            np.testing.assert_allclose(runs[engine][1],
                                       runs["bruteforce"][1])

    def test_neighborsearch_engines_agree(self):
        from mdanalysis_mpi_tpu_torch.lib.neighborsearch import (
            AtomNeighborSearch)
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        u = make_water_universe(n_waters=200, n_frames=1, seed=14)
        ow = u.select_atoms("name OW")
        probe = u.trajectory.ts.positions[:9]
        got = {}
        for engine in ("bruteforce", "nsgrid", "auto", "torch"):
            ns = AtomNeighborSearch(ow, box=u.trajectory.ts.dimensions,
                                    engine=engine)
            got[engine] = ns.search(probe, 5.0).indices.tolist()
        assert (got["bruteforce"] == got["nsgrid"] == got["auto"]
                == got["torch"])
        assert got["auto"]                          # found something
