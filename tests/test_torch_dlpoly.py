"""The port's DL_POLY CONFIG/REVCON/HISTORY formats (``io/dlpoly.py``):
the JAX package's tests/test_dlpoly.py case by case (writer→parser
round trips, index re-ordering, levcfg velocity-line skipping,
triclinic cells through the shared box math, extensionless-filename
dispatch, truncation error paths), then parity with the JAX package:
``write_config`` and ``write_history`` give the JAX writers' bytes, and
both packages read the same topologies, frames and cells."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.dlpoly import (HistoryReader, parse_config,
                                                write_config, write_history)

from mdanalysis_mpi_tpu.core.topology import Topology as JTopology
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse
from mdanalysis_mpi_tpu.io import dlpoly as jdlpoly


def _top(n=5):
    return Topology(names=np.array([f"A{i}" for i in range(n)]),
                    resnames=np.full(n, "SYS"),
                    resids=np.ones(n, np.int64))


def _coords(n=5, seed=0):
    return np.random.default_rng(seed).normal(0, 4, (n, 3)).astype(
        np.float32)


def test_config_round_trip(tmp_path):
    top, xyz = _top(), _coords()
    p = str(tmp_path / "CONFIG")
    write_config(p, top, xyz, dimensions=[20, 24, 28, 90, 90, 90])
    got = parse_config(p)
    assert got.n_atoms == 5
    assert list(got.names) == [f"A{i}" for i in range(5)]
    np.testing.assert_allclose(got._coordinates[0], xyz, atol=1e-6)
    np.testing.assert_allclose(got._dimensions[:3], [20, 24, 28])


def test_config_universe_via_extensionless_name(tmp_path):
    top, xyz = _top(), _coords(seed=1)
    p = str(tmp_path / "CONFIG")
    write_config(p, top, xyz)
    u = Universe(p)
    assert u.topology.n_atoms == 5
    np.testing.assert_allclose(u.trajectory[0].positions, xyz,
                               atol=1e-6)


def test_config_sorts_by_dlpoly_index(tmp_path):
    p = str(tmp_path / "CONFIG")
    with open(p, "w") as fh:
        fh.write("scrambled\n         0         0         3\n")
        # atoms written in order 3, 1, 2
        fh.write("C3              3\n 3.0 3.0 3.0\n")
        fh.write("C1              1\n 1.0 1.0 1.0\n")
        fh.write("C2              2\n 2.0 2.0 2.0\n")
    top = parse_config(p)
    assert list(top.names) == ["C1", "C2", "C3"]
    np.testing.assert_allclose(top._coordinates[0, :, 0], [1, 2, 3])


def test_config_levcfg_velocity_lines_skipped(tmp_path):
    p = str(tmp_path / "CONFIG")
    with open(p, "w") as fh:
        fh.write("levcfg1\n         1         0\n")
        fh.write("O               1\n 1.5 0.0 0.0\n 0.1 0.2 0.3\n")
        fh.write("H               2\n 2.5 0.0 0.0\n 0.4 0.5 0.6\n")
    top = parse_config(p)
    assert top.n_atoms == 2
    np.testing.assert_allclose(top._coordinates[0, :, 0], [1.5, 2.5])


def test_history_round_trip_with_box_and_universe(tmp_path):
    top = _top()
    frames = np.stack([_coords(seed=s) for s in range(4)])
    hist = str(tmp_path / "HISTORY")
    cfg = str(tmp_path / "CONFIG")
    write_config(cfg, top, frames[0])
    write_history(hist, top, frames,
                  dimensions=[18, 18, 22, 90, 90, 90], dt=0.5)
    u = Universe(cfg, hist)
    assert u.trajectory.n_frames == 4
    for f in range(4):
        np.testing.assert_allclose(u.trajectory[f].positions, frames[f],
                                   atol=1e-6)
    np.testing.assert_allclose(u.trajectory[2].dimensions[:3],
                               [18, 18, 22], atol=1e-5)
    # block reads feed the staging stack like any MemoryReader
    blk, _ = u.trajectory.read_block(1, 3)
    np.testing.assert_allclose(blk, frames[1:3], atol=1e-6)


def test_history_triclinic_cell(tmp_path):
    top = _top(3)
    frames = np.stack([_coords(3, seed=7)])
    p = str(tmp_path / "HISTORY")
    write_history(p, top, frames,
                  dimensions=[10, 12, 14, 80, 95, 100])
    r = HistoryReader(p)
    np.testing.assert_allclose(r[0].dimensions,
                               [10, 12, 14, 80, 95, 100], atol=1e-4)


def test_history_atom_count_mismatch(tmp_path):
    top = _top()
    p = str(tmp_path / "HISTORY")
    write_history(p, top, np.stack([_coords()]))
    with pytest.raises(ValueError, match="topology has 4"):
        HistoryReader(p, n_atoms=4)


def test_history_truncated_frame(tmp_path):
    top = _top()
    p = str(tmp_path / "HISTORY")
    write_history(p, top, np.stack([_coords()]))
    lines = open(p).read().splitlines()
    open(p, "w").write("\n".join(lines[:-3]) + "\n")
    with pytest.raises(ValueError, match="truncated"):
        HistoryReader(p)


def test_config_error_paths(tmp_path):
    p = str(tmp_path / "CONFIG")
    open(p, "w").write("only-title\n")
    with pytest.raises(ValueError, match="too short"):
        parse_config(p)
    open(p, "w").write("t\n 5 0\n")
    with pytest.raises(ValueError, match="levcfg"):
        parse_config(p)
    # levcfg=1 atom record missing its velocity line: loud, not a
    # raw IndexError
    open(p, "w").write("t\n 1 0\nO 1\n 1.0 2.0 3.0\n")
    with pytest.raises(ValueError, match="truncated atom record"):
        parse_config(p)
    # imcon > 0 with fewer than 3 cell lines
    open(p, "w").write("t\n 0 3\n 10 0 0\n")
    with pytest.raises(ValueError, match="truncated cell"):
        parse_config(p)
    # declared atom count cross-check catches truncation at a record
    # boundary
    open(p, "w").write("t\n 0 0 5\nA 1\n 1 1 1\nB 2\n 2 2 2\n")
    with pytest.raises(ValueError, match="declares 5 atoms, found 2"):
        parse_config(p)


# ---------------- parity with the JAX package ----------------

TOP_FIELDS = ("names", "resnames", "resids", "segids", "elements", "masses",
              "charges", "radii", "resindices", "bonds", "angles",
              "dihedrals", "impropers")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_topology(top, jtop):
    """Every Topology attribute equal between the packages."""
    for key in TOP_FIELDS:
        a, b = getattr(top, key), getattr(jtop, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=key)


def assert_same_universe(u, ju):
    """Equal topologies, and every frame and box equal."""
    assert_same_topology(u.topology, ju.topology)
    n = u.trajectory.n_frames
    assert n == ju.trajectory.n_frames
    (a, ab), (b, bb) = (u.trajectory.read_block(0, n),
                        ju.trajectory.read_block(0, n))
    np.testing.assert_array_equal(a, b)
    assert (ab is None) == (bb is None)
    if ab is not None:
        np.testing.assert_array_equal(ab, bb)


def _jtop(n=5):
    return JTopology(names=np.array([f"A{i}" for i in range(n)]),
                     resnames=np.full(n, "SYS"),
                     resids=np.ones(n, np.int64))


@pytest.mark.parametrize("dims", [None, [20, 24, 28, 90, 90, 90],
                                  [20, 24, 28, 70, 80, 100]],
                         ids=["boxless", "ortho", "triclinic"])
def test_write_config_bytes_and_parse_equal_jax(tmp_path, dims):
    xyz = _coords(seed=3)
    p, jp = str(tmp_path / "CONFIG"), str(tmp_path / "jax" / "CONFIG")
    (tmp_path / "jax").mkdir()
    write_config(p, _top(), xyz, dimensions=dims)
    jdlpoly.write_config(jp, _jtop(), xyz, dimensions=dims)
    assert _bytes(p) == _bytes(jp)
    got, want = parse_config(p), jdlpoly.parse_config(p)
    assert_same_topology(got, want)
    np.testing.assert_array_equal(got._coordinates, want._coordinates)
    if dims is not None:
        np.testing.assert_array_equal(got._dimensions, want._dimensions)
    assert_same_universe(Universe(p), JUniverse(p))


@pytest.mark.parametrize("per_frame", [False, True])
def test_write_history_bytes_and_reads_equal_jax(tmp_path, per_frame):
    frames = np.stack([_coords(seed=s) for s in range(4)])
    dims = np.array([20.0, 24, 28, 70, 80, 100])
    if per_frame:
        dims = np.stack([dims + [i, 0, 0, 0, 0, 0] for i in range(4)])
    p, jp = str(tmp_path / "HISTORY"), str(tmp_path / "jax" / "HISTORY")
    (tmp_path / "jax").mkdir()
    write_history(p, _top(), frames, dimensions=dims, dt=0.5)
    jdlpoly.write_history(jp, _jtop(), frames, dimensions=dims, dt=0.5)
    assert _bytes(p) == _bytes(jp)
    r, j = HistoryReader(p), jdlpoly.HistoryReader(p)
    (a, ab), (b, bb) = r.read_block(0, 4), j.read_block(0, 4)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ab, bb)
    np.testing.assert_array_equal(r.frame_times(range(4)),
                                  j.frame_times(range(4)))
