"""The port's ``lib.distances``, ``lib.nsgrid`` and ``ops.neighbors``
against the JAX package's on the same seeded inputs (the cases of
tests/test_nsgrid.py and the capped-distance cases of
tests/test_distances.py).

- Host engines (``auto``, ``nsgrid``, ``bruteforce``): pairs and
  distances ``array_equal`` to the JAX package's — the code is a copy.
- ``engine="torch"`` with ``device="cpu"`` against the JAX package's
  ``engine="jax"`` and against ``bruteforce``: equal pairs; distances
  within 1e-6 Å of the JAX engine's for orthorhombic and boxless
  queries, and within 1e-5 Å for the triclinic box, where both float32
  engines build the box matrix from their own float32 cos/sin (one ulp
  apart, 4.8e-7 Å on the matrix) and wrap through it.
- The overflow retry, the kernel's overflow flag, ``self_pair_counts``
  frame by frame, and the refusals.
"""

import logging

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

torch.set_num_threads(1)

from mdanalysis_mpi_tpu.lib import distances as jdist  # noqa: E402
from mdanalysis_mpi_tpu.lib import nsgrid as jnsgrid  # noqa: E402
from mdanalysis_mpi_tpu.lib.neighborsearch import (  # noqa: E402
    AtomNeighborSearch as JAtomNeighborSearch)
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_water_universe as jmake_water_universe)

from mdanalysis_mpi_tpu_torch.lib import distances as tdist  # noqa: E402
from mdanalysis_mpi_tpu_torch.lib import nsgrid as tnsgrid  # noqa: E402
from mdanalysis_mpi_tpu_torch.lib.neighborsearch import (  # noqa: E402
    AtomNeighborSearch)
from mdanalysis_mpi_tpu_torch.ops import neighbors  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import make_water_universe  # noqa: E402

ORTHO = np.array([20.0, 20.0, 20.0, 90.0, 90.0, 90.0])
TRICLINIC = np.array([20.0, 24.0, 18.0, 75.0, 80.0, 95.0])
BOXES = [ORTHO, TRICLINIC, None]
BOX_IDS = ["ortho", "triclinic", "nobox"]
BOX_OF = dict(zip(BOX_IDS, BOXES))
#: the torch engine against the JAX engine, per box (module docstring)
JAX_ATOL = {"ortho": 1e-6, "triclinic": 1e-5, "nobox": 1e-6}
CPU = dict(engine="torch", device="cpu")


def _clouds(seed=0, n=400, m=500, lo=-5.0, hi=25.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, size=(n, 3)),
            rng.uniform(lo, hi, size=(m, 3)))


def _lattice():
    """A 5 Å lattice in a 20 Å box: every atom ON a cell boundary and
    every neighbour at EXACTLY the cutoff."""
    return np.stack(np.meshgrid(*[np.arange(0.0, 20.0, 5.0)] * 3,
                                indexing="ij"), -1).reshape(-1, 3)


def _equal(port, ref):
    (pp, dp), (pr, dr) = port, ref
    np.testing.assert_array_equal(pp, pr)
    np.testing.assert_array_equal(dp, dr)


class TestHostEnginesEqualJax:
    """The copied host engines emit exactly the JAX package's arrays."""

    @pytest.mark.parametrize("engine", ["auto", "nsgrid", "bruteforce"])
    @pytest.mark.parametrize("box", BOXES, ids=BOX_IDS)
    def test_cross_query(self, box, engine):
        a, b = _clouds()
        port = tdist.capped_distance(a, b, 4.5, box=box, engine=engine)
        _equal(port, jdist.capped_distance(a, b, 4.5, box=box,
                                           engine=engine))
        assert len(port[0]) > 100

    @pytest.mark.parametrize("engine", ["auto", "nsgrid", "bruteforce"])
    @pytest.mark.parametrize("box", BOXES, ids=BOX_IDS)
    def test_self_query_min_cutoff(self, box, engine):
        a, _ = _clouds(seed=1)
        port = tdist.self_capped_distance(a, 5.0, min_cutoff=1.0, box=box,
                                          engine=engine)
        _equal(port, jdist.self_capped_distance(a, 5.0, min_cutoff=1.0,
                                                box=box, engine=engine))
        assert (port[0][:, 0] < port[0][:, 1]).all()

    def test_cutoff_equals_cell_edge(self):
        a, b = _clouds(seed=2, lo=0.0, hi=20.0)
        box = np.array([15.0, 15.0, 15.0, 90.0, 90.0, 90.0])
        for engine in ("nsgrid", "bruteforce"):
            _equal(tdist.capped_distance(a, b, 5.0, box=box, engine=engine),
                   jdist.capped_distance(a, b, 5.0, box=box, engine=engine))

    @pytest.mark.parametrize("box", [ORTHO, None], ids=["ortho", "nobox"])
    def test_atoms_exactly_on_cell_boundaries(self, box):
        g = _lattice()
        port = tdist.capped_distance(g, g, 5.0, box=box, engine="nsgrid")
        _equal(port, jdist.capped_distance(g, g, 5.0, box=box,
                                           engine="nsgrid"))
        _equal(port, tdist.capped_distance(g, g, 5.0, box=box,
                                           engine="bruteforce"))
        assert len(port[0]) > 0

    def test_empty_selections(self):
        empty = np.empty((0, 3))
        a, _ = _clouds(seed=3, n=10, m=10)
        for ref, conf in ((empty, a), (a, empty), (empty, empty)):
            for engine in ("nsgrid", "bruteforce", "auto"):
                p, d = tdist.capped_distance(ref, conf, 3.0, box=ORTHO,
                                             engine=engine)
                assert p.shape == (0, 2) and d.shape == (0,)

    def test_grid_plans_equal(self):
        a, b = _clouds(seed=4)
        for box in (ORTHO, TRICLINIC, None):
            assert (tnsgrid.grid_shape(a, b, 4.0, box)
                    == jnsgrid.grid_shape(a, b, 4.0, box))
        with pytest.raises(tnsgrid.GridUnsuitable):
            tnsgrid.grid_shape(a, b, 9.0, np.array([10.0, 10, 10, 90, 90,
                                                    90]))

    def test_forced_nsgrid_refuses_oversize_cutoff(self):
        a, b = _clouds(seed=4, n=20, m=20, lo=0.0, hi=10.0)
        box = np.array([10.0, 10.0, 10.0, 90.0, 90.0, 90.0])
        with pytest.raises(ValueError, match="nsgrid"):
            tdist.capped_distance(a, b, 9.0, box=box, engine="nsgrid")
        p_auto = tdist.capped_distance(a, b, 9.0, box=box, engine="auto",
                                       return_distances=False)
        np.testing.assert_array_equal(
            p_auto, jdist.capped_distance(a, b, 9.0, box=box,
                                          engine="bruteforce",
                                          return_distances=False))

    def test_auto_uses_grid_at_scale_and_never_the_device(self,
                                                          monkeypatch):
        a, b = _clouds(seed=5)
        called = {}
        real = tnsgrid.capped_pairs

        def spy(*args, **kw):
            called["grid"] = True
            return real(*args, **kw)

        def refuse(*args, **kw):
            raise AssertionError("auto picked the torch engine")

        monkeypatch.setattr(tnsgrid, "capped_pairs", spy)
        monkeypatch.setattr(neighbors, "capped_distance", refuse)
        tdist.capped_distance(a, b, 4.5, box=ORTHO, engine="auto",
                              return_distances=False)
        assert called.get("grid")

    def test_engine_and_backend_validated(self):
        x = np.zeros((2, 3))
        with pytest.raises(ValueError, match="engine"):
            tdist.capped_distance(x, x, 1.0, engine="fft")
        with pytest.raises(ValueError, match="'torch'"):
            tdist.capped_distance(x, x, 1.0, engine="jax")
        with pytest.raises(ValueError, match="'torch'"):
            tdist.distance_array(x, x, backend="jax")
        with pytest.raises(ValueError, match="'torch'"):
            tdist.calc_bonds(x, x, backend="jax")
        with pytest.raises(ValueError, match="backend"):
            tdist.self_distance_array(x, backend="cupy")
        with pytest.raises(ValueError, match="max_cutoff"):
            tdist.capped_distance(x, x, 0.0)
        with pytest.raises(ValueError, match="min_cutoff"):
            tdist.capped_distance(x, x, 1.0, min_cutoff=2.0)


class TestTorchEngine:
    """The torch cell list on the CPU against the JAX engine and the
    host brute force."""

    @pytest.mark.parametrize("tag", BOX_IDS)
    def test_cross_query(self, tag):
        box = BOX_OF[tag]
        a, b = _clouds(seed=6)
        pt, dt = tdist.capped_distance(a, b, 4.0, box=box, **CPU)
        pj, dj = jdist.capped_distance(a, b, 4.0, box=box, engine="jax")
        pb, db = tdist.capped_distance(a, b, 4.0, box=box,
                                       engine="bruteforce")
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(pt, pb)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=JAX_ATOL[tag])
        np.testing.assert_allclose(dt, db, rtol=0, atol=5e-4)
        assert pt.dtype == np.int64 and dt.dtype == np.float64
        assert len(pt) > 100

    @pytest.mark.parametrize("tag", BOX_IDS)
    def test_self_query_min_cutoff(self, tag):
        box = BOX_OF[tag]
        a, _ = _clouds(seed=7)
        pt, dt = tdist.self_capped_distance(a, 4.0, min_cutoff=1.0,
                                            box=box, **CPU)
        pj, dj = jdist.self_capped_distance(a, 4.0, min_cutoff=1.0,
                                            box=box, engine="jax")
        pb, _ = tdist.self_capped_distance(a, 4.0, min_cutoff=1.0, box=box,
                                           engine="bruteforce")
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(pt, pb)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=JAX_ATOL[tag])

    def test_pairs_only(self):
        a, b = _clouds(seed=8)
        pt = tdist.capped_distance(a, b, 4.0, box=ORTHO,
                                   return_distances=False, **CPU)
        np.testing.assert_array_equal(
            pt, jdist.capped_distance(a, b, 4.0, box=ORTHO,
                                      return_distances=False,
                                      engine="jax"))

    def test_cell_edge_lattice(self):
        """Every atom on a cell edge, every neighbour at the cutoff: the
        float32 binning may move an atom across an edge, never a pair
        out of the result."""
        g = _lattice()
        pt, _ = tdist.capped_distance(g, g, 5.0 + 1e-3, box=ORTHO, **CPU)
        pj, _ = jdist.capped_distance(g, g, 5.0 + 1e-3, box=ORTHO,
                                      engine="jax")
        pb, _ = tdist.capped_distance(g, g, 5.0 + 1e-3, box=ORTHO,
                                      engine="bruteforce")
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(pt, pb)
        assert len(pt) == len(g) * 7          # itself and six neighbours

    def test_empty_and_degenerate(self):
        empty = np.empty((0, 3))
        a, _ = _clouds(seed=9, n=10, m=10)
        for ref, conf in ((empty, a), (a, empty), (empty, empty)):
            p, d = tdist.capped_distance(ref, conf, 3.0, box=ORTHO, **CPU)
            assert p.shape == (0, 2) and d.shape == (0,)
        with pytest.raises(ValueError, match="partially degenerate"):
            tdist.capped_distance(a, a, 3.0,
                                  box=np.array([10.0, 0, 0, 90, 90, 90]),
                                  **CPU)
        with pytest.raises(ValueError, match="cannot serve"):
            tdist.capped_distance(a, a, 9.0,
                                  box=np.array([10.0, 10, 10, 90, 90, 90]),
                                  **CPU)

    def test_capacity_overflow_retries_to_parity(self, caplog):
        a, b = _clouds(seed=8, n=150, m=200, lo=0.0, hi=20.0)
        pb = tdist.capped_distance(a, b, 4.0, box=ORTHO,
                                   engine="bruteforce",
                                   return_distances=False)
        with caplog.at_level(logging.WARNING, logger="mdtpu"):
            pt = neighbors.capped_distance(a, b, 4.0, dims=ORTHO,
                                           return_distances=False,
                                           capacity=1, device="cpu")
        np.testing.assert_array_equal(pb, pt)
        msgs = [r.getMessage() for r in caplog.records]
        assert any("cell capacity 1 overflowed for 200 atoms" in m
                   and "retrying with 2" in m for m in msgs)

    def test_too_clustered_raises(self, monkeypatch):
        a, b = _clouds(seed=10, n=50, m=50, lo=0.0, hi=20.0)
        monkeypatch.setattr(neighbors, "MAX_KERNEL_ELEMENTS", 100)
        with pytest.raises(ValueError, match="too clustered"):
            tdist.capped_distance(a, b, 4.0, box=ORTHO, **CPU)

    def test_overflow_flag_raised_by_kernel(self):
        x = torch.zeros((16, 3), dtype=torch.float32) + 1.0
        box = torch.tensor([12.0, 12, 12, 90, 90, 90])
        *_, overflow = neighbors.cell_bucket_kernel(
            x, x, box, 2.0, (3, 3, 3), 4, self_upper=True)
        assert bool(overflow)
        *_, ok = neighbors.cell_bucket_kernel(
            x, x, box, 2.0, (3, 3, 3), 16, self_upper=True)
        assert not bool(ok)
        # the JAX kernel flags the same inputs the same way
        import jax.numpy as jnp

        from mdanalysis_mpi_tpu.ops.neighbors import cell_bucket_kernel

        xj = jnp.zeros((16, 3), jnp.float32) + 1.0
        boxj = jnp.asarray([12.0, 12, 12, 90, 90, 90], jnp.float32)
        assert bool(cell_bucket_kernel(xj, xj, boxj, 2.0, (3, 3, 3), 4,
                                       self_upper=True)[3])

    def test_kernel_hits_equal_jax(self):
        """The raw kernel: the same hit count and the same squared
        distances of the hits as the JAX kernel's."""
        import jax.numpy as jnp

        from mdanalysis_mpi_tpu.ops.neighbors import cell_bucket_kernel

        a, b = _clouds(seed=11, n=120, m=150, lo=0.0, hi=20.0)
        a32, b32 = a.astype(np.float32), b.astype(np.float32)
        cand, d2, hit, ov = neighbors.cell_bucket_kernel(
            torch.as_tensor(a32), torch.as_tensor(b32),
            torch.as_tensor(ORTHO, dtype=torch.float32), 4.0, (5, 5, 5), 12)
        jc, jd2, jhit, jov = cell_bucket_kernel(
            jnp.asarray(a32), jnp.asarray(b32),
            jnp.asarray(ORTHO, jnp.float32), 4.0, (5, 5, 5), 12)
        assert not bool(ov) and not bool(jov)
        assert int(hit.sum()) == int(np.asarray(jhit).sum())

        def keyed(c, d, h):
            ii, kk = np.nonzero(h)
            key = ii * len(b) + c[ii, kk]
            order = np.argsort(key)
            return key[order], d[ii, kk][order]

        kt, dt = keyed(cand.numpy(), d2.numpy(), hit.numpy())
        kj, dj = keyed(np.asarray(jc).astype(np.int64), np.asarray(jd2),
                       np.asarray(jhit))
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)

    def test_self_pair_counts_frame_by_frame(self):
        rng = np.random.default_rng(9)
        B, N = 8, 160
        coords = rng.uniform(0, 22, size=(B, N, 3)).astype(np.float32)
        boxes = np.tile(np.array([22.0, 22, 22, 90, 90, 90], np.float32),
                        (B, 1))
        mask = np.ones(B, np.float32)
        mask[-1] = 0.0
        counts, ovs = neighbors.self_pair_counts(
            torch.as_tensor(coords), torch.as_tensor(boxes),
            torch.as_tensor(mask), 4.0, (5, 5, 5), 16)
        assert not ovs.any()
        host = [len(jdist.self_capped_distance(coords[f], 4.0,
                                               box=boxes[f],
                                               engine="nsgrid")[0])
                for f in range(B)]
        np.testing.assert_array_equal(
            counts.numpy(), np.asarray(host, np.float32) * mask)
        assert counts.dtype == torch.float32

    def test_default_device_needs_a_gpu(self):
        a, b = _clouds(seed=12, n=10, m=10)
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device works")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.capped_distance(a, b, 3.0, box=ORTHO, engine="torch")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.distance_array(a, b, backend="torch")


class TestDistanceFunctions:
    """The rest of ``lib.distances``: the torch backend within float32
    of the JAX package's ``'jax'`` backend, the host functions equal."""

    @pytest.mark.parametrize("box", BOXES, ids=BOX_IDS)
    def test_distance_array_and_self(self, box):
        a, b = _clouds(seed=13, n=30, m=40)
        np.testing.assert_array_equal(tdist.distance_array(a, b, box=box),
                                      jdist.distance_array(a, b, box=box))
        np.testing.assert_allclose(
            tdist.distance_array(a, b, box=box, backend="torch",
                                 device="cpu"),
            jdist.distance_array(a, b, box=box, backend="jax"),
            rtol=0, atol=2e-5)
        np.testing.assert_allclose(
            tdist.self_distance_array(a, box=box, backend="torch",
                                      device="cpu"),
            jdist.self_distance_array(a, box=box, backend="jax"),
            rtol=0, atol=2e-5)
        np.testing.assert_array_equal(tdist.self_distance_array(a, box=box),
                                      jdist.self_distance_array(a, box=box))

    @pytest.mark.parametrize("box", BOXES, ids=BOX_IDS)
    def test_calc_bonds_angles_dihedrals(self, box):
        rng = np.random.default_rng(14)
        p = [rng.uniform(0, 20, size=(25, 3)) for _ in range(4)]
        np.testing.assert_array_equal(tdist.calc_bonds(p[0], p[1], box=box),
                                      jdist.calc_bonds(p[0], p[1], box=box))
        np.testing.assert_allclose(
            tdist.calc_bonds(p[0], p[1], box=box, backend="torch",
                             device="cpu"),
            jdist.calc_bonds(p[0], p[1], box=box, backend="jax"),
            rtol=0, atol=2e-5)
        np.testing.assert_array_equal(
            tdist.calc_angles(*p[:3], box=box),
            jdist.calc_angles(*p[:3], box=box))
        np.testing.assert_array_equal(
            tdist.calc_dihedrals(*p, box=box),
            jdist.calc_dihedrals(*p, box=box))

    def test_host_helpers_equal(self):
        rng = np.random.default_rng(15)
        x = rng.uniform(-30, 50, size=(40, 3))
        for box in (ORTHO, TRICLINIC):
            for name in ("apply_PBC", "minimize_vectors", "transform_RtoS",
                         "transform_StoR"):
                np.testing.assert_array_equal(
                    getattr(tdist, name)(x, box),
                    getattr(jdist, name)(x, box))
        np.testing.assert_array_equal(
            tdist.contact_matrix(x, 12.0, box=ORTHO),
            jdist.contact_matrix(x, 12.0, box=ORTHO))
        assert tdist.AUTO_GRID_MIN_PAIRS == jdist.AUTO_GRID_MIN_PAIRS
        assert tdist.AUTO_GRID_MIN_CELLS == jdist.AUTO_GRID_MIN_CELLS
        assert neighbors.MAX_KERNEL_ELEMENTS == 1 << 28


class TestAtomNeighborSearch:
    @pytest.mark.parametrize("engine", ["bruteforce", "nsgrid", "auto",
                                        "torch"])
    @pytest.mark.parametrize("level", ["A", "R"])
    def test_engines_equal_jax(self, engine, level):
        u = make_water_universe(n_waters=200, n_frames=1, seed=14)
        ju = jmake_water_universe(n_waters=200, n_frames=1, seed=14)
        probe = u.trajectory.ts.positions[:9]
        ns = AtomNeighborSearch(u.select_atoms("name OW"),
                                box=u.trajectory.ts.dimensions,
                                engine=engine, device="cpu")
        jns = JAtomNeighborSearch(ju.select_atoms("name OW"),
                                  box=ju.trajectory.ts.dimensions,
                                  engine="bruteforce")
        key = "indices" if level == "A" else "resindices"
        got = getattr(ns.search(probe, 5.0, level=level), key)
        want = getattr(jns.search(probe, 5.0, level=level), key)
        np.testing.assert_array_equal(got, want)
        assert len(got)

    def test_validation(self):
        u = make_water_universe(n_waters=8, n_frames=1)
        with pytest.raises(ValueError, match="empty"):
            AtomNeighborSearch(u.select_atoms("name XX"))
        ns = AtomNeighborSearch(u.atoms)
        with pytest.raises(ValueError, match="radius"):
            ns.search(u.atoms, 0.0)
        with pytest.raises(ValueError, match="level"):
            ns.search(u.atoms, 2.0, level="Q")
