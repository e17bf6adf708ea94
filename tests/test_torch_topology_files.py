"""Twin of ``tests/test_topology_files.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

GRO/PSF/PDB parser + writer round-trip tests."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.topology import make_protein_topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.gro import parse_gro, write_gro
from mdanalysis_mpi_tpu_torch.io.pdb import parse_pdb, write_pdb
from mdanalysis_mpi_tpu_torch.io.psf import parse_psf, write_psf

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, port_runs_on_the_cpu)


RNG = np.random.default_rng(11)


@pytest.fixture
def top():
    return make_protein_topology(4)


@pytest.fixture
def coords(top):
    return RNG.normal(scale=8.0, size=(top.n_atoms, 3)).astype(np.float32)


class TestGRO:
    def test_round_trip(self, tmp_path, top, coords):
        dims = np.array([30.0, 32.0, 34.0, 90.0, 90.0, 90.0])
        path = str(tmp_path / "x.gro")
        write_gro(path, top, coords, dimensions=dims)
        t2 = parse_gro(path)
        assert t2.n_atoms == top.n_atoms
        np.testing.assert_array_equal(t2.names, top.names)
        np.testing.assert_array_equal(t2.resids, top.resids)
        # GRO has 0.001 nm = 0.01 A resolution
        np.testing.assert_allclose(t2._coordinates[0], coords, atol=0.006)
        np.testing.assert_allclose(t2._dimensions, dims, atol=1e-3)

    def test_triclinic_box(self, tmp_path, top, coords):
        dims = np.array([30.0, 30.0, 30.0, 80.0, 95.0, 110.0])
        path = str(tmp_path / "tri.gro")
        write_gro(path, top, coords, dimensions=dims)
        np.testing.assert_allclose(parse_gro(path)._dimensions, dims,
                                   atol=0.05)

    def test_universe_from_gro(self, tmp_path, top, coords):
        path = str(tmp_path / "u.gro")
        write_gro(path, top, coords)
        u = Universe(path)
        assert u.select_atoms("protein and name CA").n_atoms == 4
        np.testing.assert_allclose(u.atoms.positions, coords, atol=0.006)

    def test_universe_gro_plus_xtc(self, tmp_path, top, coords):
        """The reference's exact constructor shape: Universe(GRO, XTC)
        (RMSF.py:56), then the full pipeline."""
        from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
        from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc

        gro = str(tmp_path / "top.gro")
        xtc = str(tmp_path / "traj.xtc")
        write_gro(gro, top, coords)
        traj = coords + RNG.normal(scale=0.3, size=(8,) + coords.shape
                                   ).astype(np.float32)
        write_xtc(xtc, traj)
        u = Universe(gro, xtc)
        assert u.trajectory.n_frames == 8
        r = AlignedRMSF(u, select="protein and name CA").run(
            backend="torch", batch_size=4)
        s = AlignedRMSF(u, select="protein and name CA").run(backend="serial")
        np.testing.assert_allclose(r.results.rmsf, s.results.rmsf,
                                   rtol=5e-3, atol=1e-3)

    def test_malformed(self, tmp_path):
        p = tmp_path / "bad.gro"
        p.write_text("title\nnot_a_number\n")
        with pytest.raises(ValueError):
            parse_gro(str(p))


class TestPSF:
    def test_round_trip(self, tmp_path, top):
        top.charges = RNG.normal(scale=0.5, size=top.n_atoms)
        top.bonds = np.array([[0, 1], [1, 2], [2, 3]])
        path = str(tmp_path / "x.psf")
        write_psf(path, top)
        t2 = parse_psf(path)
        assert t2.n_atoms == top.n_atoms
        np.testing.assert_array_equal(t2.names, top.names)
        np.testing.assert_array_equal(t2.resids, top.resids)
        np.testing.assert_allclose(t2.charges, top.charges, atol=1e-6)
        np.testing.assert_allclose(t2.masses, top.masses, atol=1e-4)
        np.testing.assert_array_equal(t2.bonds, top.bonds)

    def test_universe_psf_dcd(self, tmp_path, top):
        """BASELINE config 1: Universe(PSF, DCD) → RMSF of Cα."""
        from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
        from mdanalysis_mpi_tpu_torch.io.dcd import write_dcd

        psf = str(tmp_path / "adk.psf")
        dcd = str(tmp_path / "adk.dcd")
        write_psf(psf, top)
        base = RNG.normal(scale=6.0, size=(top.n_atoms, 3)).astype(np.float32)
        write_dcd(dcd, base + RNG.normal(
            scale=0.25, size=(10, top.n_atoms, 3)).astype(np.float32))
        u = Universe(psf, dcd)
        assert u.trajectory.n_frames == 10
        r = AlignedRMSF(u, select="protein and name CA").run(backend="torch",
                                                             batch_size=5)
        assert r.results.rmsf.shape == (4,)
        assert (r.results.rmsf > 0).all()

    def test_not_psf(self, tmp_path):
        p = tmp_path / "bad.psf"
        p.write_text("garbage\n")
        with pytest.raises(ValueError, match="PSF"):
            parse_psf(str(p))


class TestPDB:
    def test_round_trip(self, tmp_path, top, coords):
        dims = np.array([25.0, 25.0, 25.0, 90.0, 90.0, 90.0])
        path = str(tmp_path / "x.pdb")
        write_pdb(path, top, coords, dimensions=dims)
        t2 = parse_pdb(path)
        assert t2.n_atoms == top.n_atoms
        np.testing.assert_array_equal(t2.names, top.names)
        np.testing.assert_allclose(t2._coordinates[0], coords, atol=2e-3)
        np.testing.assert_allclose(t2._dimensions, dims, atol=1e-2)

    def test_multi_model_trajectory(self, tmp_path, top):
        frames = RNG.normal(scale=5.0, size=(3, top.n_atoms, 3)).astype(np.float32)
        path = str(tmp_path / "m.pdb")
        write_pdb(path, top, frames)
        u = Universe(path)
        assert u.trajectory.n_frames == 3
        np.testing.assert_allclose(u.trajectory[2].positions, frames[2],
                                   atol=2e-3)

    def test_empty(self, tmp_path):
        p = tmp_path / "e.pdb"
        p.write_text("END\n")
        with pytest.raises(ValueError, match="no ATOM"):
            parse_pdb(str(p))


def test_tpr_conversion_path_documented(tmp_path):
    """TPR (RMSF.py:8) resolves to an actionable conversion message, not
    an unknown-format error."""
    from mdanalysis_mpi_tpu_torch.io import topology_files

    p = tmp_path / "topol.tpr"
    p.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="gmx editconf"):
        topology_files.parse(str(p))


def test_gro_velocities_roundtrip(tmp_path):
    """GRO velocity columns (nm/ps in-file) surface as A/ps on the
    single-frame universe; files without them read velocities=None."""
    import numpy as np

    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.gro import write_gro

    top = Topology(names=np.array(["CA", "CB"]),
                   resnames=np.array(["ALA", "ALA"]),
                   resids=np.array([1, 1]))
    x = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
    v = np.array([[0.5, -0.25, 0.0], [1.25, 0.0, -2.0]], np.float32)
    path = str(tmp_path / "v.gro")
    write_gro(path, top, x, velocities=v)
    u = Universe(path)
    ts = u.trajectory[0]
    np.testing.assert_allclose(ts.velocities, v, atol=2e-3)
    np.testing.assert_allclose(u.atoms.velocities, v, atol=2e-3)
    # velocity-free file: None (and the AtomGroup accessor raises)
    path2 = str(tmp_path / "nov.gro")
    write_gro(path2, top, x)
    u2 = Universe(path2)
    assert u2.trajectory[0].velocities is None


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


def _topology_arrays(top):
    return {k: (list(v) if v.dtype.kind in "OUS" else v)
            for k, v in sorted(vars(top).items())
            if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("fmt", ["gro", "pdb", "psf"])
def test_topology_files_match_jax_package(tmp_path, fmt):
    """One package writes the file, both parse it: equal topologies
    (every array attribute); the written files are byte-identical."""
    rng = np.random.default_rng(3)

    def write(mod):
        top = mod("core.topology").make_protein_topology(6)
        xyz = (rng.uniform(0, 20, size=(top.n_atoms, 3))
               .astype(np.float32))
        path = str(tmp_path / f"{mod().__name__}.{fmt}")
        w = getattr(mod(f"io.{fmt}"), f"write_{fmt}")
        if fmt == "psf":
            w(path, top)
        else:
            w(path, top, xyz)
        return path
    rng = np.random.default_rng(3)
    ref_path = write(lambda sub="": __import__("importlib").import_module(
        "mdanalysis_mpi_tpu" + ("." + sub if sub else "")))
    rng = np.random.default_rng(3)
    port_path = write(lambda sub="": __import__("importlib").import_module(
        "mdanalysis_mpi_tpu_torch" + ("." + sub if sub else "")))
    assert open(ref_path, "rb").read() == open(port_path, "rb").read()
    assert_same(*both(lambda mod: _topology_arrays(
        getattr(mod(f"io.{fmt}"), f"parse_{fmt}")(port_path))))
