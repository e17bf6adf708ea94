"""The port's WaterBridgeAnalysis (``analysis/waterbridge.py``, a copy of
the JAX package's; serial only): the JAX package's
tests/test_waterbridge.py case by case (constructed geometries with
known bridge topology, the distance and angle criteria, terminal-pair
aggregation, the loud serial-only contract), a bare ``run()`` taking
the serial backend as in the JAX package without touching a device,
and the bridges of the same geometry EQUAL to the JAX package's."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis.waterbridge import WaterBridgeAnalysis
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader


def _bridge_universe(w1_shift=0.0, w2=False, n_frames=1):
    """PROT O–H donating to water W1; W1 donating to ACCP O.

    Geometry (x axis, Å):
      prot O at 0, its H at 1.0 (donor O-H)
      W1 O at 2.8  (accepts from prot H: O···O 2.8, angle 180°)
      W1 H1 at 3.76 pointing at ACCP O
      ACCP O at 5.6 (accepts from W1)
      optional W2 extends the chain to 8.4 before ACCP at 11.2
    ``w1_shift`` displaces W1 perpendicular to break the geometry.
    """
    names, resnames, resids, elements, coords = [], [], [], [], []

    def atom(name, resname, resid, element, xyz):
        names.append(name)
        resnames.append(resname)
        resids.append(resid)
        elements.append(element)
        coords.append(xyz)

    atom("OG", "PROT", 1, "O", [0.0, 0.0, 0.0])
    atom("HG", "PROT", 1, "H", [1.0, 0.0, 0.0])
    atom("OW", "SOL", 2, "O", [2.8, w1_shift, 0.0])
    atom("HW1", "SOL", 2, "H", [3.76, w1_shift, 0.0])
    atom("HW2", "SOL", 2, "H", [2.5, w1_shift + 0.9, 0.0])
    if w2:
        # W1 HW1 now donates to W2; W2 donates on to the acceptor
        coords[3] = [3.76, w1_shift, 0.0]
        atom("OW", "SOL", 3, "O", [5.6, 0.0, 0.0])
        atom("HW1", "SOL", 3, "H", [6.56, 0.0, 0.0])
        atom("HW2", "SOL", 3, "H", [5.3, 0.9, 0.0])
        atom("OD", "ACCP", 4, "O", [8.4, 0.0, 0.0])
        atom("CD", "ACCP", 4, "C", [9.6, 0.0, 0.0])
    else:
        atom("OD", "ACCP", 3, "O", [5.6, 0.0, 0.0])
        atom("CD", "ACCP", 3, "C", [6.8, 0.0, 0.0])
    top = Topology(names=np.array(names), resnames=np.array(resnames),
                   resids=np.array(resids, np.int64),
                   elements=np.array(elements))
    frames = np.tile(np.asarray(coords, np.float32)[None],
                     (n_frames, 1, 1))
    dims = np.array([50, 50, 50, 90, 90, 90], np.float32)
    return Universe(top, MemoryReader(frames, dimensions=dims))


def test_first_order_bridge_found():
    u = _bridge_universe()
    wb = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP").run()
    assert len(wb.results.timeseries) == 1
    bridges = wb.results.timeseries[0]
    assert len(bridges) == 1
    chain = bridges[0]
    assert len(chain) == 2                      # two hbonds, one water
    # chain runs sel1 → water → sel2
    d0, h0, a0 = chain[0][:3]
    d1, h1, a1 = chain[1][:3]
    assert (d0, a0) == (0, 2)                   # prot O donates to W O
    assert (d1, a1) == (2, 5)                   # W donates to acceptor
    assert wb.count_by_time().tolist() == [1]


def test_broken_geometry_no_bridge():
    u = _bridge_universe(w1_shift=8.0)          # water moved away
    wb = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP").run()
    assert wb.count_by_time().tolist() == [0]
    assert wb.results.timeseries[0] == []


def test_second_order_gated_on_order():
    u = _bridge_universe(w2=True)
    wb1 = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                              order=1).run()
    assert wb1.count_by_time().tolist() == [0]
    wb2 = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                              order=2).run()
    assert wb2.count_by_time().tolist() == [1]
    chain = wb2.results.timeseries[0][0]
    assert len(chain) == 3                      # three hbonds, two waters
    waters = {chain[0][2], chain[1][0], chain[1][2], chain[2][0]}
    assert waters == {2, 5}                     # both water oxygens


def test_distance_cutoff_respected():
    u = _bridge_universe()
    wb = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                             distance=2.0).run()
    assert wb.count_by_time().tolist() == [0]


def test_angle_cutoff_respected():
    # in-line geometry has ~180 deg angles; demanding >179.9 still works,
    # but bending W1 sideways breaks a 150 deg requirement
    u = _bridge_universe(w1_shift=1.5)
    loose = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                                angle=90.0).run()
    strict = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                                 angle=180.0 - 1e-6).run()
    assert strict.count_by_time().tolist() == [0]
    # the bent geometry may or may not pass 90 deg — just check it ran
    assert len(loose.results.timeseries) == 1


def test_count_by_type_occupancy():
    u = _bridge_universe(n_frames=4)
    wb = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP").run()
    pairs = wb.count_by_type()
    assert len(pairs) == 1
    a1, a2, occ = pairs[0]
    assert (a1, a2) == (0, 5)                   # prot O to acceptor O
    assert occ == 1.0


def test_network_edges_exposed():
    u = _bridge_universe()
    wb = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP").run()
    edges = wb.results.network[0]
    assert any(e[0] == 0 and e[2] == 2 for e in edges)


def test_serial_only_contract():
    u = _bridge_universe()
    wb = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP")
    with pytest.raises(ValueError, match="serial"):
        wb.run(backend="torch", device="cpu")


def test_validation_errors():
    u = _bridge_universe()
    with pytest.raises(ValueError, match="order"):
        WaterBridgeAnalysis(u, "resname PROT", "resname ACCP", order=0)
    with pytest.raises(ValueError, match="matched no atoms"):
        WaterBridgeAnalysis(u, "resname XXX", "resname ACCP").run()
    with pytest.raises(ValueError, match="disjoint"):
        WaterBridgeAnalysis(u, "resname PROT", "resname PROT").run()
    with pytest.raises(ValueError, match="bridge node"):
        WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                            water_selection="resname PROT or resname SOL"
                            ).run()
    with pytest.raises(RuntimeError, match="run"):
        WaterBridgeAnalysis(u, "resname PROT",
                            "resname ACCP").count_by_time()


# ---- duplicate-resid regression (ADVICE r5 high) ----

def _duplicate_resid_universe(chain=False):
    """Two DISTINCT waters sharing resid 2 (PDB wraparound /
    per-segment restart shape): non-adjacent in the atom list, so the
    topology derives distinct resindices for them.

    ``chain=False``: W1 accepts from PROT near x=2.8; W2 donates to
    ACCP near x=22.8; the waters are 17 Å apart with NO hbond between
    them — no bridge exists at any order.  Keying water nodes by the
    non-unique resid collapsed W1 and W2 into one node and fabricated
    a first-order bridge here.

    ``chain=True``: W2 moves to x=5.6 forming the genuine
    PROT→W1→W2→ACCP chain — a second-order bridge that must still be
    found (and must still be gated off at order=1) when its two waters
    share a resid.
    """
    names, resnames, resids, elements, coords = [], [], [], [], []

    def atom(name, resname, resid, element, xyz):
        names.append(name)
        resnames.append(resname)
        resids.append(resid)
        elements.append(element)
        coords.append(xyz)

    atom("OG", "PROT", 1, "O", [0.0, 0.0, 0.0])
    atom("HG", "PROT", 1, "H", [1.0, 0.0, 0.0])
    atom("OW", "SOL", 2, "O", [2.8, 0.0, 0.0])
    atom("HW1", "SOL", 2, "H", [3.76, 0.0, 0.0])
    atom("HW2", "SOL", 2, "H", [2.5, 0.9, 0.0])
    if chain:
        w2x, accx = 5.6, 8.4
    else:
        w2x, accx = 20.0, 22.8
    atom("OD", "ACCP", 3, "O", [accx, 0.0, 0.0])
    atom("CD", "ACCP", 3, "C", [accx + 1.2, 0.0, 0.0])
    # W2: NON-adjacent to W1 and deliberately reusing resid 2
    atom("OW", "SOL", 2, "O", [w2x, 0.0, 0.0])
    atom("HW1", "SOL", 2, "H", [w2x + 0.96, 0.0, 0.0])
    atom("HW2", "SOL", 2, "H", [w2x - 0.3, 0.9, 0.0])
    top = Topology(names=np.array(names), resnames=np.array(resnames),
                   resids=np.array(resids, np.int64),
                   elements=np.array(elements))
    # the scenario's premise: same resid, distinct residues
    assert top.resindices[2] != top.resindices[7]
    assert top.resids[2] == top.resids[7]
    frames = np.asarray(coords, np.float32)[None]
    dims = np.array([50, 50, 50, 90, 90, 90], np.float32)
    return Universe(top, MemoryReader(frames, dimensions=dims))


def test_duplicate_resids_do_not_fabricate_bridges():
    u = _duplicate_resid_universe(chain=False)
    for order in (1, 2):
        wb = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                                 order=order).run()
        assert wb.count_by_time().tolist() == [0], (
            f"order={order}: far-apart waters sharing a resid must not "
            "merge into one bridge node")


def test_duplicate_resids_keep_real_chain_and_order_gating():
    u = _duplicate_resid_universe(chain=True)
    # order=1 must NOT see the two-water chain (with resid-keyed nodes
    # the merged W1/W2 node made it look first-order)
    wb1 = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                              order=1).run()
    assert wb1.count_by_time().tolist() == [0]
    wb2 = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                              order=2).run()
    bridges = wb2.results.timeseries[0]
    assert len(bridges) == 1
    assert len(bridges[0]) == 3            # prot→W1, W1→W2, W2→ACCP


def test_bare_run_is_serial_and_needs_no_device(monkeypatch):
    """``_default_backend = "serial"``: a bare run() works as in the JAX
    package (whose run() defaults to serial) and resolves no device."""
    import torch

    from mdanalysis_mpi_tpu_torch import device as port_device

    def refuse(device=None):
        raise AssertionError(f"a device was resolved: {device!r}")

    monkeypatch.setattr(port_device, "resolve_device", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert WaterBridgeAnalysis._default_backend == "serial"
    wb = WaterBridgeAnalysis(_bridge_universe(n_frames=2), "resname PROT",
                             "resname ACCP").run()
    np.testing.assert_array_equal(wb.results.bridge_counts, [1, 1])


@pytest.mark.parametrize("w2,order", [(False, 1), (True, 1), (True, 2)])
def test_bridges_equal_jax_package(w2, order):
    from mdanalysis_mpi_tpu.analysis.waterbridge import (
        WaterBridgeAnalysis as JWB)
    from mdanalysis_mpi_tpu.core.topology import Topology as JTop
    from mdanalysis_mpi_tpu.core.universe import Universe as JU
    from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMR

    u = _bridge_universe(w2=w2, n_frames=2)
    t = u.topology
    uj = JU(JTop(names=t.names, resnames=t.resnames, resids=t.resids,
                 elements=t.elements),
            JMR(u.trajectory.read_block(0, 2)[0],
                dimensions=u.trajectory.ts.dimensions))
    a = WaterBridgeAnalysis(u, "resname PROT", "resname ACCP",
                            order=order).run()
    b = JWB(uj, "resname PROT", "resname ACCP", order=order).run()
    assert a.results.timeseries == b.results.timeseries
    assert a.results.network == b.results.network
    assert a.count_by_type() == b.count_by_type()

