"""The port's PDBQT, Tinker TXYZ/ARC and Desmond DMS formats
(``io/pdbqt.py``, ``io/txyz.py``, ``io/dms.py``) and the closed
container formats' guidance: the JAX package's tests/test_pdbqt_txyz.py
case by case (hand fixtures and writer round trips), then parity with
the JAX package: each fixture reads to equal topologies and frames in
both packages, every writer gives the JAX writer's bytes, and the
closed formats refuse with the same message."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.pdbqt import parse_pdbqt, write_pdbqt
from mdanalysis_mpi_tpu_torch.io.txyz import parse_txyz, write_txyz

from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse
from mdanalysis_mpi_tpu.io import pdbqt as jpdbqt
from mdanalysis_mpi_tpu.io import txyz as jtxyz

PDBQT = """\
REMARK  receptor fragment
ATOM      1  N   LYS A  12      10.000  20.000  30.000  1.00  0.00    -0.347 N
ATOM      2  CA  LYS A  12      11.000  20.500  30.200  1.00  0.00     0.177 C
ATOM      3  HZ1 LYS A  12      12.000  21.000  31.000  1.00  0.00     0.274 HD
ATOM      4  OD1 ASP A  13      13.500  19.000  29.000  1.00  0.00    -0.648 OA
END
"""

PDBQT_POSES = """\
MODEL 1
ATOM      1  C1  LIG A   1       0.000   0.000   0.000  1.00  0.00     0.100 C
ATOM      2  O1  LIG A   1       1.200   0.000   0.000  1.00  0.00    -0.300 OA
ENDMDL
MODEL 2
ATOM      1  C1  LIG A   1       5.000   0.000   0.000  1.00  0.00     0.100 C
ATOM      2  O1  LIG A   1       6.200   0.000   0.000  1.00  0.00    -0.300 OA
ENDMDL
"""

TXYZ = """\
     4  ethanol fragment
     1  C      0.000000    0.000000    0.000000     1     2     3
     2  C      1.530000    0.000000    0.000000     1     1     4
     3  H     -0.500000    0.900000    0.000000     5     1
     4  O      2.200000    1.100000    0.000000     6     2
"""


def test_pdbqt_parse(tmp_path):
    p = tmp_path / "x.pdbqt"
    p.write_text(PDBQT)
    u = Universe(str(p))
    assert u.atoms.n_atoms == 4
    np.testing.assert_allclose(u.atoms.charges,
                               [-0.347, 0.177, 0.274, -0.648])
    assert list(u.atoms.elements) == ["N", "C", "H", "O"]
    assert list(u.topology.segids) == ["A"] * 4
    assert u.select_atoms("prop charge < 0").n_atoms == 2


def test_pdbqt_poses_become_frames(tmp_path):
    p = tmp_path / "poses.pdbqt"
    p.write_text(PDBQT_POSES)
    u = Universe(str(p))
    assert u.trajectory.n_frames == 2
    np.testing.assert_allclose(u.trajectory[1].positions[0],
                               [5, 0, 0], atol=1e-5)


def test_pdbqt_round_trip(tmp_path):
    p = tmp_path / "x.pdbqt"
    p.write_text(PDBQT)
    u = Universe(str(p))
    out = tmp_path / "rt.pdbqt"
    write_pdbqt(str(out), u)
    v = Universe(str(out))
    np.testing.assert_allclose(v.atoms.charges, u.atoms.charges,
                               atol=1e-3)
    np.testing.assert_allclose(v.trajectory[0].positions,
                               u.trajectory[0].positions, atol=1e-3)
    assert list(v.atoms.names) == list(u.atoms.names)
    assert list(v.atoms.elements) == list(u.atoms.elements)


def test_txyz_parse(tmp_path):
    p = tmp_path / "m.txyz"
    p.write_text(TXYZ)
    u = Universe(str(p))
    assert u.atoms.n_atoms == 4
    assert list(u.atoms.names) == ["C", "C", "H", "O"]
    # bonds deduplicated from both atoms' neighbor lists
    assert sorted(map(tuple, u.topology.bonds.tolist())) == [
        (0, 1), (0, 2), (1, 3)]
    np.testing.assert_allclose(u.trajectory[0].positions[1],
                               [1.53, 0, 0], atol=1e-5)


def test_txyz_arc_multiframe_and_round_trip(tmp_path):
    p = tmp_path / "m.txyz"
    p.write_text(TXYZ)
    u = Universe(str(p))
    out = tmp_path / "m.arc"
    # write two frames (same coords twice via current frame)
    write_txyz(str(out), u, frames=[0, 0])
    top, frames, box = parse_txyz(str(out))
    assert frames.shape == (2, 4, 3)
    assert sorted(map(tuple, top.bonds.tolist())) == sorted(
        map(tuple, u.topology.bonds.tolist()))
    # and as a trajectory against the txyz topology
    v = Universe(str(p), str(out))
    assert v.trajectory.n_frames == 2


def test_txyz_truncated_loud(tmp_path):
    p = tmp_path / "m.txyz"
    p.write_text("     3  broken\n     1  C 0.0 0.0 0.0 1\n")
    with pytest.raises(ValueError, match="truncated"):
        parse_txyz(str(p))


def test_pdbqt_writer_column_exactness(tmp_path):
    """Round trip with field-filling values: an 8-char coordinate
    (1000.000) and 4-char resname must land on the standard columns
    the parser slices."""
    p = tmp_path / "x.pdbqt"
    # width-preserving edits: resname field [17:21] "LYS " -> "LYSX",
    # x field [30:38] "  10.000" -> "1000.000"
    p.write_text(PDBQT.replace("LYS A", "LYSXA")
                 .replace("  10.000  20.000", "1000.000  20.000"))
    u = Universe(str(p))
    out = tmp_path / "rt.pdbqt"
    write_pdbqt(str(out), u)
    v = Universe(str(out))
    assert list(v.atoms.resnames) == list(u.atoms.resnames)
    assert list(v.topology.segids) == list(u.topology.segids)
    np.testing.assert_allclose(v.trajectory[0].positions,
                               u.trajectory[0].positions, atol=1e-3)
    np.testing.assert_allclose(v.atoms.charges, u.atoms.charges,
                               atol=1e-3)


def test_txyz_per_frame_boxes(tmp_path):
    """NPT archives: every frame's box line is kept, not just frame
    1's."""
    arc = """\
     1  npt frame 1
    10.000000   10.000000   10.000000   90.000000   90.000000   90.000000
     1  C      0.000000    0.000000    0.000000     1
     1  npt frame 2
    12.000000   12.000000   12.000000   90.000000   90.000000   90.000000
     1  C      1.000000    0.000000    0.000000     1
"""
    p = tmp_path / "npt.arc"
    p.write_text(arc)
    top, frames, boxes = parse_txyz(str(p))
    assert frames.shape == (2, 1, 3)
    np.testing.assert_allclose(boxes[0][:3], 10.0)
    np.testing.assert_allclose(boxes[1][:3], 12.0)
    # and .arc opens standalone as a Universe (topology + frames)
    u = Universe(str(p))
    assert u.trajectory.n_frames == 2
    np.testing.assert_allclose(u.trajectory[1].dimensions[:3], 12.0)


# ---- DMS (Desmond sqlite) ----


def _make_dms(path, with_cell=True, seg_col="segid"):
    import sqlite3

    con = sqlite3.connect(path)
    cur = con.cursor()
    cur.execute(f"""CREATE TABLE particle (
        id INTEGER PRIMARY KEY, anum INTEGER, name TEXT, resname TEXT,
        resid INTEGER, {seg_col} TEXT, mass REAL, charge REAL,
        x REAL, y REAL, z REAL)""")
    rows = [
        (0, 7, "N", "ALA", 1, "A", 14.007, -0.3, 1.0, 2.0, 3.0),
        (1, 6, "CA", "ALA", 1, "A", 12.011, 0.1, 2.0, 2.5, 3.5),
        (2, 8, "OW", "SOL", 2, "B", 15.999, -0.8, 9.0, 9.0, 9.0),
    ]
    cur.executemany("INSERT INTO particle VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                    rows)
    cur.execute("CREATE TABLE bond (p0 INTEGER, p1 INTEGER)")
    cur.execute("INSERT INTO bond VALUES (0, 1)")
    if with_cell:
        cur.execute("""CREATE TABLE global_cell (
            id INTEGER PRIMARY KEY, x REAL, y REAL, z REAL)""")
        cur.executemany("INSERT INTO global_cell VALUES (?,?,?,?)",
                        [(1, 30.0, 0, 0), (2, 0, 40.0, 0),
                         (3, 0, 0, 50.0)])
    con.commit()
    con.close()


def test_dms_parse(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.dms import parse_dms

    p = tmp_path / "sys.dms"
    _make_dms(str(p))
    u = Universe(str(p))
    assert u.atoms.n_atoms == 3
    assert list(u.atoms.names) == ["N", "CA", "OW"]
    assert list(u.atoms.elements) == ["N", "C", "O"]
    np.testing.assert_allclose(u.atoms.charges, [-0.3, 0.1, -0.8])
    np.testing.assert_allclose(u.atoms.masses, [14.007, 12.011, 15.999])
    assert list(u.topology.segids) == ["A", "A", "B"]
    assert u.topology.bonds.tolist() == [[0, 1]]
    np.testing.assert_allclose(u.trajectory[0].positions[0], [1, 2, 3])
    np.testing.assert_allclose(u.trajectory[0].dimensions,
                               [30, 40, 50, 90, 90, 90], atol=1e-4)


def test_dms_chain_column_variant(tmp_path):
    p = tmp_path / "sys.dms"
    _make_dms(str(p), with_cell=False, seg_col="chain")
    u = Universe(str(p))
    assert list(u.topology.segids) == ["A", "A", "B"]
    assert u.trajectory[0].dimensions is None


def test_dms_not_sqlite_loud(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.dms import parse_dms

    p = tmp_path / "fake.dms"
    p.write_text("this is not sqlite")
    with pytest.raises(ValueError, match="SQLite"):
        parse_dms(str(p))


def test_dms_optional_anum_and_velocities(tmp_path):
    import sqlite3

    p = tmp_path / "v.dms"
    con = sqlite3.connect(str(p))
    cur = con.cursor()
    cur.execute("""CREATE TABLE particle (
        id INTEGER PRIMARY KEY, name TEXT, resname TEXT, resid INTEGER,
        mass REAL, charge REAL, x REAL, y REAL, z REAL,
        vx REAL, vy REAL, vz REAL)""")
    cur.execute("INSERT INTO particle VALUES "
                "(0,'CA','ALA',1,12.0,0.0, 1,2,3, 0.1,0.2,0.3)")
    con.commit(); con.close()
    u = Universe(str(p))
    assert u.atoms.n_atoms == 1
    np.testing.assert_allclose(u.atoms.velocities[0], [0.1, 0.2, 0.3],
                               atol=1e-6)


def test_dms_missing_id_column_loud(tmp_path):
    import sqlite3
    from mdanalysis_mpi_tpu_torch.io.dms import parse_dms

    p = tmp_path / "noid.dms"
    con = sqlite3.connect(str(p))
    con.execute("CREATE TABLE particle (name TEXT, resname TEXT, "
                "resid INTEGER, mass REAL, charge REAL, "
                "x REAL, y REAL, z REAL)")
    con.commit(); con.close()
    with pytest.raises(ValueError, match="id"):
        parse_dms(str(p))


def test_closed_container_formats_loud(tmp_path):
    """H5MD/GSD/TNG refuse with conversion guidance, not a bare
    'no trajectory reader'."""
    from mdanalysis_mpi_tpu_torch.io import trajectory_files

    for ext, word in (("h5md", "h5py"), ("gsd", "gsd"),
                      ("tng", "trjconv"), ("trz", "circular")):
        p = tmp_path / f"x.{ext}"
        p.write_bytes(b"\x00" * 16)
        with pytest.raises(ValueError, match=word):
            trajectory_files.open(str(p), n_atoms=5)


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


NPT_ARC = """\
     2  npt frame 1
    10.000000   10.000000   10.000000   90.000000   90.000000   90.000000
     1  C      0.000000    0.000000    0.000000     1     2
     2  O      1.200000    0.000000    0.000000     2     1
     2  npt frame 2
    12.000000   12.000000   12.000000   90.000000   90.000000   90.000000
     1  C      1.000000    0.000000    0.000000     1     2
     2  O      2.300000    0.100000    0.000000     2     1
"""


def _fixture(tmp_path, name):
    p = tmp_path / name
    if name.endswith(".dms"):
        _make_dms(str(p), with_cell=name == "cell.dms",
                  seg_col="segid" if name == "cell.dms" else "chain")
    else:
        p.write_text({"x.pdbqt": PDBQT, "poses.pdbqt": PDBQT_POSES,
                      "x.txyz": TXYZ, "npt.arc": NPT_ARC}[name])
    return str(p)


@pytest.mark.parametrize("name", ["x.pdbqt", "poses.pdbqt", "x.txyz",
                                  "npt.arc", "cell.dms", "chain.dms"])
def test_fixture_universe_like_jax(tmp_path, name):
    p = _fixture(tmp_path, name)
    assert_same_universe(Universe(p), JUniverse(p))


@pytest.mark.parametrize("name", ["x.pdbqt", "x.txyz", "npt.arc"])
def test_writer_bytes_equal_jax(tmp_path, name):
    p = _fixture(tmp_path, name)
    u, ju = Universe(p), JUniverse(p)
    ext = name.split(".")[1]
    out, jout = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    if ext == "pdbqt":
        write_pdbqt(out, u)
        jpdbqt.write_pdbqt(jout, ju)
    else:
        frames = range(u.trajectory.n_frames)
        write_txyz(out, u, frames=frames)
        jtxyz.write_txyz(jout, ju, frames=frames)
    assert _bytes(out) == _bytes(jout)
    assert_same_universe(Universe(out), JUniverse(out))


def test_closed_container_formats_refuse_like_jax(tmp_path):
    from mdanalysis_mpi_tpu.io import trajectory_files as jtf
    from mdanalysis_mpi_tpu_torch.io import trajectory_files

    for ext in ("h5md", "h5", "gsd", "tng", "trz"):
        p = tmp_path / f"x.{ext}"
        p.write_bytes(b"\x00" * 16)
        msgs = []
        for tf in (trajectory_files, jtf):
            with pytest.raises(ValueError) as err:
                tf.open(str(p), n_atoms=5)
            msgs.append(str(err.value))
        assert msgs[0].split(":")[0] == msgs[1].split(":")[0]
        assert "convert once" in msgs[0]
