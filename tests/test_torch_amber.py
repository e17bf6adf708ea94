"""The port's AMBER PRMTOP, INPCRD and mdcrd formats (``io/prmtop.py``,
``io/inpcrd.py``, ``io/mdcrd.py``): the JAX package's tests/test_amber.py
case by case (a hand-written prmtop with the quirks that matter: packed
20a4 names, the 18.2223 charge scale, the index*3 bond convention,
residue pointers; the writers' round trips; the restart reader's
trailing-block disambiguation; the PRMTOP + RST7 + NetCDF combination),
then parity with the JAX package: the written bytes equal, the parsed
topologies and read frames equal, and the combination run through both
packages."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.inpcrd import (read_inpcrd, write_inpcrd)
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.io.prmtop import (AMBER_CHARGE_SCALE,
                                                parse_prmtop, write_prmtop)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse
from mdanalysis_mpi_tpu.io import inpcrd as jinpcrd
from mdanalysis_mpi_tpu.io import mdcrd as jmdcrd
from mdanalysis_mpi_tpu.io import prmtop as jprmtop
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader
from mdanalysis_mpi_tpu.testing import (
    make_protein_universe as jax_make_protein_universe)

PRMTOP = """\
%VERSION  VERSION_STAMP = V0001.000  DATE = 01/01/01
%FLAG POINTERS
%FORMAT(10I8)
       5       2       1       1       0       0       0       0       0       0
       0       2       0       0       0       0       0       0       0       0
       0       0       0       0       0       0       0       0       0       0
       0       0
%FLAG ATOM_NAME
%FORMAT(20a4)
N   CA  HA1 OW  HW1
%FLAG CHARGE
%FORMAT(5E16.8)
 -7.73130000E+00  1.82223000E+00  3.64446000E+00 -1.51245090E+01  7.56225450E+00
%FLAG MASS
%FORMAT(5E16.8)
  1.40070000E+01  1.20110000E+01  1.00800000E+00  1.59990000E+01  1.00800000E+00
%FLAG ATOMIC_NUMBER
%FORMAT(10I8)
       7       6       1       8       1
%FLAG RESIDUE_LABEL
%FORMAT(20a4)
ALA WAT
%FLAG RESIDUE_POINTER
%FORMAT(10I8)
       1       4
%FLAG BONDS_INC_HYDROGEN
%FORMAT(10I8)
       3       6       1       9      12       2
%FLAG BONDS_WITHOUT_HYDROGEN
%FORMAT(10I8)
       0       3       3
%FLAG SOME_UNKNOWN_FUTURE_FLAG
%FORMAT(5E16.8)
  1.00000000E+00
"""


def test_prmtop_parse(tmp_path):
    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    top = parse_prmtop(str(p))
    assert top.n_atoms == 5
    assert list(top.names) == ["N", "CA", "HA1", "OW", "HW1"]
    assert list(top.resnames) == ["ALA", "ALA", "ALA", "WAT", "WAT"]
    assert list(top.resids) == [1, 1, 1, 2, 2]
    assert list(top.elements) == ["N", "C", "H", "O", "H"]
    np.testing.assert_allclose(
        top.charges,
        np.array([-7.7313, 1.82223, 3.64446, -15.124509, 7.5622545])
        / AMBER_CHARGE_SCALE)
    np.testing.assert_allclose(top.masses,
                               [14.007, 12.011, 1.008, 15.999, 1.008])
    # index*3 convention: (3,6)->1-2, (9,12)->3-4, (0,3)->0-1
    assert sorted(map(tuple, top.bonds.tolist())) == [
        (0, 1), (1, 2), (3, 4)]


def test_prmtop_universe_and_selections(tmp_path):
    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    coords = np.zeros((1, 5, 3), np.float32)
    u = Universe(str(p), coords)
    assert u.select_atoms("resname WAT").n_atoms == 2
    assert u.select_atoms("prop mass > 10").n_atoms == 3


def test_prmtop_round_trip(tmp_path):
    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    u = Universe(str(p), np.zeros((1, 5, 3), np.float32))
    out = tmp_path / "rt.prmtop"
    write_prmtop(str(out), u)
    t2 = parse_prmtop(str(out))
    assert list(t2.names) == list(u.topology.names)
    assert list(t2.resnames) == list(u.topology.resnames)
    np.testing.assert_allclose(t2.charges, u.topology.charges,
                               atol=1e-7)
    np.testing.assert_allclose(t2.masses, u.topology.masses)
    assert sorted(map(tuple, t2.bonds.tolist())) == sorted(
        map(tuple, u.topology.bonds.tolist()))


def test_prmtop_packed_names(tmp_path):
    """20a4 names with no separators must split by field width."""
    packed = PRMTOP.replace("N   CA  HA1 OW  HW1", "N1*AC2'BH3TCO5'DHW2E")
    p = tmp_path / "packed.prmtop"
    p.write_text(packed)
    top = parse_prmtop(str(p))
    assert list(top.names) == ["N1*A", "C2'B", "H3TC", "O5'D", "HW2E"]


def _rst_text(coords, vels=None, box=None, natom=None):
    out = ["fixture", f"{natom if natom is not None else len(coords):5d}"]
    flat = list(np.asarray(coords, np.float64).reshape(-1))
    if vels is not None:
        flat += list(np.asarray(vels, np.float64).reshape(-1))
    if box is not None:
        flat += list(np.asarray(box, np.float64))
    lines = []
    for k in range(0, len(flat), 6):
        lines.append("".join(f"{v:12.7f}" for v in flat[k:k + 6]))
    return "\n".join(out + lines) + "\n"


def test_inpcrd_coords_only(tmp_path):
    c = np.arange(9, dtype=np.float64).reshape(3, 3) / 7.0
    p = tmp_path / "x.inpcrd"
    p.write_text(_rst_text(c))
    coords, vels, box = read_inpcrd(str(p))
    np.testing.assert_allclose(coords, c, atol=1e-6)
    assert vels is None and box is None


def test_inpcrd_velocities_and_box(tmp_path):
    rng = np.random.default_rng(1)
    c = rng.normal(size=(4, 3))
    v = rng.normal(size=(4, 3))
    b = [20.0, 21.0, 22.0, 90.0, 90.0, 90.0]
    p = tmp_path / "x.rst7"
    p.write_text(_rst_text(c, v, b))
    coords, vels, box = read_inpcrd(str(p))
    np.testing.assert_allclose(coords, c, atol=1e-6)
    np.testing.assert_allclose(vels, v, atol=1e-6)
    np.testing.assert_allclose(box, b)


def test_inpcrd_box_only(tmp_path):
    c = np.ones((5, 3))
    b = [10.0, 10.0, 10.0, 90.0, 90.0, 90.0]
    p = tmp_path / "x.restrt"
    p.write_text(_rst_text(c, box=b))
    coords, vels, box = read_inpcrd(str(p))
    assert vels is None
    np.testing.assert_allclose(box, b)


def test_inpcrd_trailing_garbage_rejected(tmp_path):
    c = np.ones((5, 3))
    p = tmp_path / "x.inpcrd"
    p.write_text(_rst_text(c) + "   1.0000000   2.0000000\n")
    with pytest.raises(ValueError, match="trailing"):
        read_inpcrd(str(p))


def test_amber_combo_prmtop_inpcrd_netcdf(tmp_path):
    """The full AMBER stack: prmtop topology + rst7 coordinates, then
    the same topology over a NetCDF trajectory, analyzed end to end."""
    from mdanalysis_mpi_tpu_torch.analysis import RMSF
    from mdanalysis_mpi_tpu_torch.io.netcdf import write_ncdf

    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    rng = np.random.default_rng(5)
    c0 = rng.normal(scale=5.0, size=(5, 3))
    rst = tmp_path / "sys.rst7"
    rst.write_text(_rst_text(c0))
    u = Universe(str(p), str(rst))
    assert u.trajectory.n_frames == 1
    np.testing.assert_allclose(u.atoms.positions, c0, atol=1e-5)

    frames = (c0[None] + rng.normal(scale=0.2, size=(12, 5, 3))
              ).astype(np.float32)
    nc = tmp_path / "md.nc"
    write_ncdf(str(nc), frames)
    u2 = Universe(str(p), str(nc))
    r = RMSF(u2.select_atoms("resname ALA")).run(backend="serial")
    assert r.results.rmsf.shape == (3,)
    assert np.isfinite(r.results.rmsf).all()


def test_inpcrd_writer_round_trip(tmp_path):
    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    rng = np.random.default_rng(8)
    c0 = rng.normal(scale=5.0, size=(5, 3)).astype(np.float32)
    u = Universe(str(p), c0[None])
    out = tmp_path / "out.rst7"
    vel = rng.normal(size=(5, 3))
    write_inpcrd(str(out), u, velocities=vel, time=100.0)
    coords, vels, box = read_inpcrd(str(out))
    np.testing.assert_allclose(coords, c0, atol=1e-6)
    np.testing.assert_allclose(vels, vel, atol=1e-6)


def test_direct_inpcrd_import_keeps_registry(tmp_path):
    """Importing io.inpcrd directly must not suppress the other
    trajectory format registrations (flag-guarded autoload)."""
    from mdanalysis_mpi_tpu_torch.io import trajectory_files

    trajectory_files._autoload()
    for ext in ("xtc", "nc", "xyz", "inpcrd"):
        assert ext in trajectory_files._READERS


def test_write_prmtop_empty_group_refuses_or_roundtrips(tmp_path):
    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    u = Universe(str(p), np.zeros((1, 5, 3), np.float32))
    out = tmp_path / "empty.prmtop"
    write_prmtop(str(out), u.select_atoms("resname NOPE"))
    t = parse_prmtop(str(out))
    assert t.n_atoms == 0


def test_write_inpcrd_overflow_refused(tmp_path):
    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    c = np.zeros((1, 5, 3), np.float32)
    c[0, 0, 0] = -12345.0
    u = Universe(str(p), c)
    with pytest.raises(ValueError, match="F12.7"):
        write_inpcrd(str(tmp_path / "x.rst7"), u)


# ---- mdcrd (AMBER ASCII trajectory) ----


def test_mdcrd_round_trip_plain(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.mdcrd import read_mdcrd, write_mdcrd

    rng = np.random.default_rng(3)
    frames = rng.normal(scale=8.0, size=(5, 7, 3))
    p = tmp_path / "x.mdcrd"
    write_mdcrd(str(p), frames)
    coords, boxes = read_mdcrd(str(p), 7)
    assert boxes is None
    np.testing.assert_allclose(coords, frames, atol=1e-3)


def test_mdcrd_round_trip_boxed(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.mdcrd import read_mdcrd, write_mdcrd

    rng = np.random.default_rng(4)
    frames = rng.normal(scale=8.0, size=(4, 6, 3))
    box = np.array([30.0, 31.0, 32.0])
    p = tmp_path / "x.crdbox"
    write_mdcrd(str(p), frames, boxes=box)
    coords, boxes = read_mdcrd(str(p), 6)
    np.testing.assert_allclose(coords, frames, atol=1e-3)
    np.testing.assert_allclose(boxes[0], [30, 31, 32, 90, 90, 90])


def test_mdcrd_universe_combo(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.mdcrd import write_mdcrd

    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    rng = np.random.default_rng(6)
    frames = rng.normal(scale=5.0, size=(8, 5, 3))
    t = tmp_path / "md.mdcrd"
    write_mdcrd(str(t), frames)
    u = Universe(str(p), str(t))
    assert u.trajectory.n_frames == 8
    np.testing.assert_allclose(u.trajectory[3].positions, frames[3],
                               atol=1e-3)


def test_mdcrd_line_replay_disambiguates_3mod10(tmp_path):
    """3n ≡ 3 (mod 10) but n > 1: the per-frame line PATTERN still
    differs between plain ([...,3]) and boxed ([...,3,3]) layouts, so
    the replay check resolves it without guessing."""
    from mdanalysis_mpi_tpu_torch.io.mdcrd import read_mdcrd, write_mdcrd

    rng = np.random.default_rng(7)
    frames = rng.normal(scale=5.0, size=(2, 11, 3))
    p = tmp_path / "x.mdcrd"
    write_mdcrd(str(p), frames, boxes=np.array([20.0, 20, 20]))
    coords, boxes = read_mdcrd(str(p), 11)
    np.testing.assert_allclose(coords, frames, atol=1e-3)
    np.testing.assert_allclose(boxes[:, :3], 20.0)


def test_mdcrd_truly_ambiguous_refused(tmp_path):
    """n=1 is the one genuinely ambiguous shape: every line carries 3
    values whether coordinates or box — must refuse, not guess."""
    from mdanalysis_mpi_tpu_torch.io.mdcrd import read_mdcrd, write_mdcrd

    frames = np.zeros((2, 1, 3))
    p = tmp_path / "x.mdcrd"
    write_mdcrd(str(p), frames, boxes=np.array([20.0, 20, 20]))
    with pytest.raises(ValueError, match="ambiguous"):
        read_mdcrd(str(p), 1)


def test_mdcrd_wrong_topology_refused(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.mdcrd import read_mdcrd, write_mdcrd

    p = tmp_path / "x.mdcrd"
    write_mdcrd(str(p), np.zeros((2, 7, 3)))
    with pytest.raises(ValueError, match="neither"):
        read_mdcrd(str(p), 9)


def test_mdcrd_empty_file_loud(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.mdcrd import read_mdcrd

    p = tmp_path / "x.mdcrd"
    p.write_text("just a title\n")
    with pytest.raises(ValueError, match="truncated"):
        read_mdcrd(str(p), 7)


def test_mdcrd_f83_overflow_refused(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.mdcrd import write_mdcrd

    frames = np.zeros((1, 2, 3))
    frames[0, 0, 0] = -1000.5          # passes |x|<1e4, overflows F8.3
    with pytest.raises(ValueError, match="F8.3"):
        write_mdcrd(str(tmp_path / "x.mdcrd"), frames)


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


PACKED = PRMTOP.replace("N   CA  HA1 OW  HW1", "N1*AC2'BH3TCO5'DHW2E")
BOX = np.array([20.0, 21.0, 22.0, 90.0, 90.0, 90.0], np.float32)


@pytest.mark.parametrize("text", [PRMTOP, PACKED], ids=["plain", "packed"])
def test_prmtop_parses_like_jax(tmp_path, text):
    p = tmp_path / "sys.prmtop"
    p.write_text(text)
    assert_same_topology(parse_prmtop(str(p)), jprmtop.parse_prmtop(str(p)))


@pytest.mark.parametrize("source", ["fixture", "protein", "selection"])
def test_write_prmtop_bytes_equal_jax(tmp_path, source):
    if source == "fixture":
        p = tmp_path / "sys.prmtop"
        p.write_text(PRMTOP)
        zeros = np.zeros((1, 5, 3), np.float32)
        u, ju = Universe(str(p), zeros), JUniverse(str(p), zeros)
    else:
        kw = dict(n_residues=6, n_frames=2, seed=4)
        u, ju = make_protein_universe(**kw), jax_make_protein_universe(**kw)
    ag, jag = u.atoms, ju.atoms
    if source == "selection":
        ag, jag = u.select_atoms("name CA or name N"), ju.select_atoms(
            "name CA or name N")
    out, jout = str(tmp_path / "port.prmtop"), str(tmp_path / "jax.prmtop")
    write_prmtop(out, ag)
    jprmtop.write_prmtop(jout, jag)
    assert _bytes(out) == _bytes(jout)
    assert_same_topology(parse_prmtop(out), jprmtop.parse_prmtop(out))


@pytest.mark.parametrize("boxed", [False, True])
def test_write_inpcrd_bytes_and_reads_equal_jax(tmp_path, boxed):
    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    rng = np.random.default_rng(12)
    c = rng.normal(scale=6.0, size=(1, 5, 3)).astype(np.float32)
    vel = rng.normal(size=(5, 3))
    dims = BOX if boxed else None
    u = Universe(str(p), MemoryReader(c, dimensions=dims))
    ju = JUniverse(str(p), JMemoryReader(c, dimensions=dims))
    out, jout = str(tmp_path / "port.rst7"), str(tmp_path / "jax.rst7")
    write_inpcrd(out, u, velocities=vel, time=12.5)
    jinpcrd.write_inpcrd(jout, ju, velocities=vel, time=12.5)
    assert _bytes(out) == _bytes(jout)
    for a, b in zip(read_inpcrd(out), jinpcrd.read_inpcrd(out)):
        np.testing.assert_array_equal(a, b)
    assert_same_universe(Universe(str(p), out), JUniverse(str(p), out))


@pytest.mark.parametrize("boxed", [False, True])
def test_write_mdcrd_bytes_and_reads_equal_jax(tmp_path, boxed):
    from mdanalysis_mpi_tpu_torch.io.mdcrd import read_mdcrd, write_mdcrd

    rng = np.random.default_rng(13)
    frames = rng.normal(scale=8.0, size=(4, 5, 3))
    boxes = (np.array([[30.0 + f, 31.0, 32.0] for f in range(4)])
             if boxed else None)
    out, jout = str(tmp_path / "port.mdcrd"), str(tmp_path / "jax.mdcrd")
    write_mdcrd(out, frames, boxes=boxes)
    jmdcrd.write_mdcrd(jout, frames, boxes=boxes)
    assert _bytes(out) == _bytes(jout)
    (c, b), (jc, jb) = read_mdcrd(out, 5), jmdcrd.read_mdcrd(out, 5)
    np.testing.assert_array_equal(c, jc)
    assert (b is None) == (jb is None)
    if b is not None:
        np.testing.assert_array_equal(b, jb)
    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    assert_same_universe(Universe(str(p), out), JUniverse(str(p), out))


def test_amber_combo_prmtop_inpcrd_netcdf_like_jax(tmp_path):
    """The PRMTOP + RST7 + NetCDF combination through both packages:
    equal universes, and the port's RMSF on ``backend="torch",
    device="cpu"`` within 1e-4 Å of the JAX package's serial oracle."""
    pytest.importorskip("jax")
    from mdanalysis_mpi_tpu.analysis import RMSF as JRMSF
    from mdanalysis_mpi_tpu_torch.analysis import RMSF
    from mdanalysis_mpi_tpu_torch.io.netcdf import write_ncdf

    p = tmp_path / "sys.prmtop"
    p.write_text(PRMTOP)
    rng = np.random.default_rng(5)
    c0 = rng.normal(scale=5.0, size=(5, 3))
    rst = tmp_path / "sys.rst7"
    rst.write_text(_rst_text(c0, box=[25.0, 25.0, 25.0, 90.0, 90.0, 90.0]))
    assert_same_universe(Universe(str(p), str(rst)),
                         JUniverse(str(p), str(rst)))
    frames = (c0[None] + rng.normal(scale=0.2, size=(12, 5, 3))
              ).astype(np.float32)
    nc = str(tmp_path / "md.nc")
    write_ncdf(nc, frames, dimensions=np.array([25.0, 25, 25, 90, 90, 90]))
    u, ju = Universe(str(p), nc), JUniverse(str(p), nc)
    assert_same_universe(u, ju)
    got = RMSF(u.select_atoms("resname ALA")).run(
        backend="torch", device="cpu", batch_size=4).results.rmsf
    want = JRMSF(ju.select_atoms("resname ALA")).run(
        backend="serial").results.rmsf
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)
