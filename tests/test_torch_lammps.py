"""The port's LAMMPS dump format (``io/lammps.py``): the JAX package's
tests/test_lammps.py case by case (round trips, id-unordered rows,
plain / scaled / unwrapped coordinate columns, box handling, loud
refusals), then parity with the JAX package: ``write_lammpsdump`` gives
the JAX writer's bytes, and both readers give equal frames, boxes and
times on the same dumps."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.lammps import (LAMMPSDumpReader,
                                                write_lammpsdump)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

from mdanalysis_mpi_tpu.io import lammps as jlammps


def _frames(f=3, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=4.0, size=(f, n, 3)).astype(np.float64)


def test_round_trip_and_box(tmp_path):
    p = str(tmp_path / "t.lammpsdump")
    fr = _frames()
    dims = np.array([20.0, 21.0, 22.0, 90, 90, 90])
    write_lammpsdump(p, fr, dimensions=dims, steps=[0, 100, 200])
    r = LAMMPSDumpReader(p)
    assert r.n_frames == 3 and r.n_atoms == 5
    np.testing.assert_allclose(r[1].positions, fr[1], atol=1e-5)
    np.testing.assert_allclose(r[1].dimensions, dims, atol=1e-5)
    assert r[2].time == 200.0
    np.testing.assert_allclose(r[0].positions, fr[0], atol=1e-5)


def test_unordered_ids_sorted(tmp_path):
    """Dump rows in arbitrary id order must come back id-sorted."""
    p = str(tmp_path / "u.dump")
    write_lammpsdump(p, _frames(f=1, n=4))
    lines = open(p).read().splitlines()
    head, rows = lines[:9], lines[9:]
    open(p, "w").write("\n".join(head + rows[::-1]) + "\n")
    r = LAMMPSDumpReader(p)
    np.testing.assert_allclose(r[0].positions, _frames(f=1, n=4)[0],
                               atol=1e-5)


def test_scaled_and_unwrapped_columns(tmp_path):
    fr = _frames(f=1, n=3, seed=2)
    lo, hi = -10.0, 10.0
    scaled = (fr[0] - lo) / (hi - lo)
    body = "".join(f"{a + 1} 1 {x:.8f} {y:.8f} {z:.8f}\n"
                   for a, (x, y, z) in enumerate(scaled))
    text = ("ITEM: TIMESTEP\n5\nITEM: NUMBER OF ATOMS\n3\n"
            "ITEM: BOX BOUNDS pp pp pp\n"
            + f"{lo} {hi}\n" * 3
            + "ITEM: ATOMS id type xs ys zs\n" + body)
    p = str(tmp_path / "s.dump")
    open(p, "w").write(text)
    r = LAMMPSDumpReader(p)
    np.testing.assert_allclose(r[0].positions, fr[0], atol=1e-4)
    # unwrapped columns pass through untouched
    text2 = text.replace("xs ys zs", "xu yu zu")
    p2 = str(tmp_path / "uw.dump")
    open(p2, "w").write(text2)
    np.testing.assert_allclose(LAMMPSDumpReader(p2)[0].positions,
                               scaled, atol=1e-6)


def test_universe_and_chain_dispatch(tmp_path):
    u0 = make_protein_universe(n_residues=4, n_frames=4, noise=0.3,
                               seed=3)
    fr, _ = u0.trajectory.read_block(0, 4)
    p = str(tmp_path / "traj.lammpstrj")
    write_lammpsdump(p, fr)
    u = Universe(u0.topology, p)
    assert u.trajectory.n_frames == 4
    np.testing.assert_allclose(u.trajectory[2].positions, fr[2],
                               atol=1e-5)


def test_loud_refusals(tmp_path):
    tric = ("ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
            "ITEM: BOX BOUNDS xy xz yz pp pp pp\n"
            "0 10 0\n0 10 0\n0 10 0\n"
            "ITEM: ATOMS id type x y z\n1 1 0 0 0\n")
    p = str(tmp_path / "t.dump")
    open(p, "w").write(tric)
    with pytest.raises(ValueError, match="triclinic"):
        LAMMPSDumpReader(p)[0]
    noid = ("ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n1\n"
            "ITEM: BOX BOUNDS pp pp pp\n0 1\n0 1\n0 1\n"
            "ITEM: ATOMS type x y z\n1 0 0 0\n")
    p2 = str(tmp_path / "n.dump")
    open(p2, "w").write(noid)
    with pytest.raises(ValueError, match="no id"):
        LAMMPSDumpReader(p2)[0]
    nocoord = noid.replace("type x y z\n1 0 0 0", "id type q\n1 1 0")
    p3 = str(tmp_path / "c.dump")
    open(p3, "w").write(nocoord)
    with pytest.raises(ValueError, match="coordinates"):
        LAMMPSDumpReader(p3)[0]
    empty = str(tmp_path / "e.dump")
    open(empty, "w").write("not a dump\n")
    with pytest.raises(ValueError, match="no LAMMPS"):
        LAMMPSDumpReader(empty)
    ok = str(tmp_path / "ok.dump")
    write_lammpsdump(ok, _frames(f=1, n=2))
    with pytest.raises(ValueError, match="atoms"):
        LAMMPSDumpReader(ok, n_atoms=7)
    with pytest.raises(ValueError, match="orthogonal"):
        write_lammpsdump(ok, _frames(f=1, n=2),
                         dimensions=[10, 10, 10, 80, 90, 90])


# ---------------- parity with the JAX package ----------------

def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("boxed", [False, True])
def test_write_lammpsdump_bytes_and_reads_equal_jax(tmp_path, boxed):
    fr = _frames(f=4, n=6, seed=7)
    kw = dict(steps=[0, 10, 20, 30])
    if boxed:
        kw["dimensions"] = np.array([30.0, 31, 32, 90, 90, 90])
    p, jp = str(tmp_path / "port.dump"), str(tmp_path / "jax.dump")
    write_lammpsdump(p, fr, **kw)
    jlammps.write_lammpsdump(jp, fr, **kw)
    assert _bytes(p) == _bytes(jp)
    # rows reversed: both readers sort by id the same way
    lines = open(p).read().splitlines()
    rev = str(tmp_path / "rev.dump")
    with open(rev, "w") as f:
        for k in range(0, len(lines), 15):
            frame = lines[k:k + 15]
            f.write("\n".join(frame[:9] + frame[9:][::-1]) + "\n")
    for path in (p, rev):
        r, j = LAMMPSDumpReader(path), jlammps.LAMMPSDumpReader(path)
        assert (r.n_frames, r.n_atoms) == (j.n_frames, j.n_atoms) == (4, 6)
        (a, ab), (b, bb) = r.read_block(0, 4), j.read_block(0, 4)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ab, bb)
        for i in range(4):
            assert r[i].time == j[i].time
