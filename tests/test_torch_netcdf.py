"""The port's AMBER NetCDF reader and writer (``io/netcdf.py``): the
JAX package's tests/test_netcdf.py case by case (``backend="torch",
device="cpu"`` for its ``'jax'``), then parity with the JAX package on
the same inputs: the written bytes equal (one-shot, and chunk-appended
through ``TrajectoryWriter``), each package's reader giving equal
arrays on the same file (boxes, times, velocities under the AMBER
``scale_factor``, a streaming ``numrecs``), and tests/test_chain.py's
XTC + NetCDF + XYZ chain read the same by both."""

import struct

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.netcdf import (NCDFReader, _NC3Header,
                                                write_ncdf)
from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

from mdanalysis_mpi_tpu.io import netcdf as jnetcdf
from mdanalysis_mpi_tpu.io.writer import TrajectoryWriter as JTrajectoryWriter


def _frames(f=5, n=17, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=8.0, size=(f, n, 3)).astype(np.float32)


def test_golden_header_layout(tmp_path):
    """Pin the writer's bytes against the NetCDF-3 classic spec, field
    by field — so reader and writer cannot drift into a private
    dialect that only round-trips with itself."""
    p = str(tmp_path / "g.nc")
    write_ncdf(p, _frames(f=2, n=3),
               dimensions=np.array([10.0, 11, 12, 90, 90, 90]))
    raw = open(p, "rb").read()
    assert raw[:4] == b"CDF\x01"                     # magic + classic
    assert struct.unpack(">i", raw[4:8])[0] == 2     # numrecs
    # NC_DIMENSION tag then 5 dims; first dim 'frame' with length 0
    # (the unlimited dimension per spec)
    assert struct.unpack(">ii", raw[8:16]) == (0x0A, 5)
    namelen = struct.unpack(">i", raw[16:20])[0]
    assert raw[20:20 + namelen] == b"frame"
    off = 20 + namelen + (-namelen % 4)
    assert struct.unpack(">i", raw[off:off + 4])[0] == 0
    # the header parses back to the same structure
    hdr = _NC3Header(raw, p)
    assert dict(hdr.dims)["atom"] == 3
    assert dict(hdr.dims)["spatial"] == 3
    assert hdr.gatts["Conventions"] == "AMBER"
    v = hdr.vars["coordinates"]
    assert v["record"] and v["dims"] == ["frame", "atom", "spatial"]
    assert v["dtype"] == np.dtype(">f4") and v["vsize"] == 3 * 12
    # record data lives where the header says: frame 0's first coord
    first = np.frombuffer(raw[v["begin"]:v["begin"] + 4], ">f4")[0]
    assert first == _frames(f=2, n=3)[0, 0, 0]


def test_round_trip_and_random_access(tmp_path):
    p = str(tmp_path / "t.ncdf")
    fr = _frames()
    dims = np.array([20.0, 21.0, 22.0, 90.0, 90.0, 90.0])
    times = np.arange(5, dtype=np.float32) * 2.0
    write_ncdf(p, fr, dimensions=dims, times=times)
    r = NCDFReader(p)
    assert r.n_frames == 5 and r.n_atoms == 17
    np.testing.assert_array_equal(r[3].positions, fr[3])   # exact f32
    np.testing.assert_allclose(r[3].dimensions, dims, atol=1e-6)
    assert r[3].time == 6.0
    np.testing.assert_array_equal(r[0].positions, fr[0])   # seek back
    np.testing.assert_allclose(r.frame_times([0, 4]), [0.0, 8.0])
    block, boxes = r.read_block(1, 4)
    np.testing.assert_array_equal(block, fr[1:4])
    np.testing.assert_allclose(boxes[0], dims, atol=1e-6)
    # boxless file: dimensions None
    p2 = str(tmp_path / "nobox.nc")
    write_ncdf(p2, fr)
    assert NCDFReader(p2)[0].dimensions is None


def test_universe_integration_and_analysis(tmp_path):
    """The .nc extension dispatches through Universe, and the staged
    batch path agrees with the serial oracle over a NetCDF file."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF

    u0 = make_protein_universe(n_residues=10, n_frames=12, noise=0.3,
                               seed=5)
    fr, _ = u0.trajectory.read_block(0, 12)
    p = str(tmp_path / "traj.nc")
    write_ncdf(p, fr)
    u = Universe(u0.topology, p)
    assert u.trajectory.n_frames == 12
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    j = AlignedRMSF(u, select="name CA").run(backend="torch", device="cpu",
                                             batch_size=4)
    np.testing.assert_allclose(np.asarray(j.results.rmsf),
                               s.results.rmsf, atol=1e-4)
    u2 = u.copy()                                 # independent cursor
    u2.trajectory[5]
    assert u.trajectory.ts.frame != 5 or u2.trajectory.ts.frame == 5


def test_loud_failures(tmp_path):
    bad = tmp_path / "bad.nc"
    bad.write_bytes(b"not netcdf at all")
    with pytest.raises(ValueError, match="magic"):
        NCDFReader(str(bad))
    h5 = tmp_path / "v4.nc"
    h5.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 64)
    with pytest.raises(ValueError, match="magic|NetCDF"):
        NCDFReader(str(h5))
    cdf5 = tmp_path / "v5.nc"
    cdf5.write_bytes(b"CDF\x05" + b"\0" * 64)
    with pytest.raises(ValueError, match="version"):
        NCDFReader(str(cdf5))
    # a NetCDF file without AMBER coordinates refuses clearly
    p = str(tmp_path / "ok.nc")
    write_ncdf(p, _frames(f=1, n=2))
    raw = bytearray(open(p, "rb").read())
    raw = raw.replace(b"coordinates", b"velocitiesXX"[:11])
    (tmp_path / "nocoord.nc").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="coordinates"):
        NCDFReader(str(tmp_path / "nocoord.nc"))
    with pytest.raises(ValueError, match="atoms"):
        NCDFReader(p, n_atoms=99)
    with pytest.raises(ValueError, match="frames"):
        write_ncdf(str(tmp_path / "x.nc"), np.zeros((2, 3)))
    with pytest.raises(ValueError, match="times"):
        write_ncdf(str(tmp_path / "x.nc"), _frames(f=3, n=2),
                   times=[0.0])


def test_streaming_numrecs(tmp_path):
    """numrecs = -1 (STREAMING) derives the frame count from the file
    size (the spec's live-append convention)."""
    p = str(tmp_path / "s.nc")
    write_ncdf(p, _frames(f=4, n=6))
    raw = bytearray(open(p, "rb").read())
    raw[4:8] = struct.pack(">i", -1)
    open(p, "wb").write(bytes(raw))
    r = NCDFReader(p)
    assert r.n_frames == 4
    np.testing.assert_array_equal(r[2].positions, _frames(f=4, n=6)[2])


def test_velocities_and_scale_factor(tmp_path):
    p = str(tmp_path / "vel.nc")
    fr = _frames(f=3, n=5)
    vel = _frames(f=3, n=5, seed=9) * 0.1
    write_ncdf(p, fr, velocities=vel, vel_scale_factor=20.455)
    r = NCDFReader(p)
    ts = r[1]
    np.testing.assert_allclose(ts.velocities, vel[1], rtol=1e-5)
    # without a scale factor values store as-is
    p2 = str(tmp_path / "vel2.nc")
    write_ncdf(p2, fr, velocities=vel)
    np.testing.assert_array_equal(NCDFReader(p2)[2].velocities, vel[2])
    with pytest.raises(ValueError, match="velocities"):
        write_ncdf(p2, fr, velocities=vel[:2])


def test_per_frame_cells(tmp_path):
    p = str(tmp_path / "cells.nc")
    fr = _frames(f=3, n=4)
    dims = np.stack([[10.0 + i, 11, 12, 90, 90, 90] for i in range(3)])
    write_ncdf(p, fr, dimensions=dims)
    r = NCDFReader(p)
    for i in range(3):
        np.testing.assert_allclose(r[i].dimensions, dims[i], atol=1e-6)
    with pytest.raises(ValueError, match="dimensions"):
        write_ncdf(p, fr, dimensions=np.zeros((2, 6)))


def test_streaming_writer_ncdf(tmp_path):
    """TrajectoryWriter chunk-appends NetCDF: spliced chunks + the
    numrecs patch equal a one-shot write."""
    from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter

    fr = _frames(f=7, n=6, seed=3)
    dims = np.array([15.0, 16, 17, 90, 90, 90])
    ref = str(tmp_path / "oneshot.nc")
    write_ncdf(ref, fr, dimensions=dims)
    out = str(tmp_path / "streamed.nc")
    w = TrajectoryWriter(out, n_atoms=6)
    w.write(fr[:3], dimensions=dims)
    w.write(fr[3:5], dimensions=dims)
    w.write(fr[5:], dimensions=dims)
    w.close()
    a, b = NCDFReader(ref), NCDFReader(out)
    assert b.n_frames == 7
    for i in range(7):
        np.testing.assert_array_equal(b[i].positions, a[i].positions)
        np.testing.assert_allclose(b[i].dimensions, a[i].dimensions,
                                   atol=1e-6)
    # structural consistency is enforced across chunks
    w2 = TrajectoryWriter(str(tmp_path / "mix.nc"), n_atoms=6)
    w2.write(fr[:2], dimensions=dims)
    with pytest.raises(ValueError, match="unit cells"):
        w2.write(fr[2:4])
    w2.close()
    w3 = TrajectoryWriter(str(tmp_path / "mixv.nc"), n_atoms=6)
    w3.write(fr[:2], velocities=fr[:2])
    with pytest.raises(ValueError, match="velocities"):
        w3.write(fr[2:4])
    w3.close()


def test_scale_factor_on_any_variable(tmp_path):
    """AMBER allows scale_factor on ANY variable; _rec_field applies it
    uniformly (the parsed-attribute path itself is covered by the
    velocities round trip)."""
    p = str(tmp_path / "sf.nc")
    fr = _frames(f=2, n=3)
    write_ncdf(p, fr)
    r = NCDFReader(p)
    r._hdr.vars["coordinates"]["atts"]["scale_factor"] = np.array([2.0])
    np.testing.assert_allclose(r[1].positions, 2.0 * fr[1], rtol=1e-6)


def test_writer_empty_chunk_and_steps_refusal(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter

    fr = _frames(f=3, n=4, seed=11)
    out = str(tmp_path / "e.nc")
    w = TrajectoryWriter(out, n_atoms=4)
    assert w.write(np.empty((0, 4, 3), np.float32)) == 0   # no header
    w.write(fr)
    w.close()
    r = NCDFReader(out)
    assert r.n_frames == 3
    np.testing.assert_array_equal(r[0].positions, fr[0])
    w2 = TrajectoryWriter(str(tmp_path / "s.nc"), n_atoms=4)
    with pytest.raises(ValueError, match="step"):
        w2.write(fr, steps=np.arange(3))
    # single-frame (N, 3) velocities promote with the coords
    w2.write(fr[0], velocities=fr[0])
    w2.close()
    assert NCDFReader(str(tmp_path / "s.nc"))[0].velocities is not None


def test_format_round_trip_fuzz(tmp_path):
    """Property fuzz across the round-5 formats: arbitrary shapes,
    optional boxes/velocities/times — write→read is exact (NetCDF f32)
    or within text precision (XYZ/LAMMPS 1e-4)."""
    hyp = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    from mdanalysis_mpi_tpu_torch.io.lammps import (LAMMPSDumpReader,
                                                    write_lammpsdump)
    from mdanalysis_mpi_tpu_torch.io.xyz import XYZReader, write_xyz

    counter = [0]

    @settings(max_examples=25, deadline=None)
    @given(
        f=st.integers(min_value=1, max_value=5),
        n=st.integers(min_value=1, max_value=9),
        box=st.booleans(),
        vel=st.booleans(),
        seed=st.integers(min_value=0, max_value=2**31 - 1),
    )
    def check(f, n, box, vel, seed):
        rng = np.random.default_rng(seed)
        fr = rng.normal(scale=50.0, size=(f, n, 3)).astype(np.float32)
        counter[0] += 1
        tag = counter[0]
        dims = (np.abs(rng.normal(scale=30.0, size=3)) + 1.0)
        dims6 = np.concatenate([dims, [90.0, 90.0, 90.0]])
        p = str(tmp_path / f"fz{tag}.nc")
        write_ncdf(p, fr, dimensions=dims6 if box else None,
                   velocities=fr * 0.1 if vel else None)
        r = NCDFReader(p)
        assert r.n_frames == f and r.n_atoms == n
        i = int(rng.integers(0, f))
        np.testing.assert_array_equal(r[i].positions, fr[i])
        if box:
            np.testing.assert_allclose(r[i].dimensions, dims6,
                                       atol=1e-5)
        if vel:
            np.testing.assert_allclose(r[i].velocities, fr[i] * 0.1,
                                       atol=1e-6)
        p2 = str(tmp_path / f"fz{tag}.xyz")
        write_xyz(p2, fr)
        np.testing.assert_allclose(XYZReader(p2)[i].positions, fr[i],
                                   atol=1e-4)
        p3 = str(tmp_path / f"fz{tag}.dump")
        write_lammpsdump(p3, fr,
                         dimensions=dims6 if box else None)
        np.testing.assert_allclose(LAMMPSDumpReader(p3)[i].positions,
                                   fr[i], atol=1e-4)

    check()


# ---------------- parity with the JAX package ----------------

def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_reads(path):
    """Both packages' readers on one file: equal frames, boxes, times
    and velocities."""
    r, j = NCDFReader(path), jnetcdf.NCDFReader(path)
    assert (r.n_frames, r.n_atoms) == (j.n_frames, j.n_atoms)
    block, boxes = r.read_block(0, r.n_frames)
    jblock, jboxes = j.read_block(0, j.n_frames)
    np.testing.assert_array_equal(block, jblock)
    assert (boxes is None) == (jboxes is None)
    if boxes is not None:
        np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_array_equal(r.frame_times(range(r.n_frames)),
                                  j.frame_times(range(j.n_frames)))
    for i in range(r.n_frames):
        v, jv = r[i].velocities, j[i].velocities
        assert (v is None) == (jv is None)
        if v is not None:
            np.testing.assert_array_equal(v, jv)
    return r


@pytest.mark.parametrize("case", ["plain", "box", "cells", "velocities",
                                  "amber_scale"])
def test_write_ncdf_bytes_and_reads_equal_jax(tmp_path, case):
    fr = _frames(f=4, n=9, seed=21)
    kw = {"times": np.arange(4, dtype=np.float32) * 0.5}
    if case == "box":
        kw["dimensions"] = np.array([20.0, 21, 22, 90, 90, 90])
    if case == "cells":
        kw["dimensions"] = np.stack([[20.0 + i, 21, 22, 80, 90, 100]
                                     for i in range(4)])
    if case in ("velocities", "amber_scale"):
        kw["velocities"] = _frames(f=4, n=9, seed=22) * 3.0
    if case == "amber_scale":
        kw["vel_scale_factor"] = 20.455
    p, jp = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    write_ncdf(p, fr, **kw)
    jnetcdf.write_ncdf(jp, fr, **kw)
    assert _bytes(p) == _bytes(jp)
    r = _same_reads(p)
    np.testing.assert_array_equal(r.read_block(0, 4)[0], fr)


def test_trajectory_writer_ncdf_bytes_equal_jax(tmp_path):
    """Chunk-appended NetCDF with cells and velocities: the stripped
    headers and the patched ``numrecs`` give the JAX writer's bytes."""
    fr = _frames(f=9, n=7, seed=23)
    vel = _frames(f=9, n=7, seed=24)
    dims = np.array([15.0, 16, 17, 90, 90, 90], np.float32)
    paths = {}
    for name, cls in (("port", TrajectoryWriter),
                      ("jax", JTrajectoryWriter)):
        paths[name] = str(tmp_path / f"{name}.nc")
        with cls(paths[name]) as w:
            for lo, hi in ((0, 4), (4, 5), (5, 9)):
                w.write(fr[lo:hi], dimensions=dims, velocities=vel[lo:hi],
                        times=np.arange(lo, hi, dtype=np.float32))
    assert _bytes(paths["port"]) == _bytes(paths["jax"])
    r = _same_reads(paths["port"])
    assert r.n_frames == 9
    np.testing.assert_array_equal(r[8].velocities, vel[8])


def test_streaming_numrecs_reads_equal_jax(tmp_path):
    p = str(tmp_path / "s.nc")
    write_ncdf(p, _frames(f=5, n=6, seed=25),
               dimensions=np.array([9.0, 9, 9, 90, 90, 90]))
    raw = bytearray(_bytes(p))
    raw[4:8] = struct.pack(">i", -1)
    with open(p, "wb") as f:
        f.write(bytes(raw))
    assert _same_reads(p).n_frames == 5


def test_amber_scale_factor_file_reads_equal_jax(tmp_path):
    """A file whose coordinates and velocities both carry a
    ``scale_factor`` attribute (AMBER allows it on any variable): the
    header is patched in place, and both readers apply both factors."""
    fr = _frames(f=3, n=4, seed=26)
    p = str(tmp_path / "sf.nc")
    write_ncdf(p, fr, velocities=fr, vel_scale_factor=20.455)
    r, j = NCDFReader(p), jnetcdf.NCDFReader(p)
    for rd in (r, j):
        rd._hdr.vars["coordinates"]["atts"]["scale_factor"] = np.array(
            [0.5], ">f4")
    for i in range(3):
        np.testing.assert_array_equal(r[i].positions, j[i].positions)
        np.testing.assert_array_equal(r[i].velocities, j[i].velocities)
    np.testing.assert_allclose(r[1].positions, 0.5 * fr[1], rtol=1e-6)
    np.testing.assert_allclose(r[1].velocities, fr[1], rtol=1e-5)


def test_mixed_format_chain_netcdf_xyz(tmp_path):
    """tests/test_chain.py's chain of XTC + NetCDF + XYZ segments: the
    chain dispatches each child by extension, block reads cross the
    format boundaries, and the JAX package reads the same arrays."""
    from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse
    from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc
    from mdanalysis_mpi_tpu_torch.io.xyz import write_xyz

    u0 = make_protein_universe(n_residues=5, n_frames=9, noise=0.3,
                               seed=8)
    fr, _ = u0.trajectory.read_block(0, 9)
    p1 = str(tmp_path / "a.xtc")
    p2 = str(tmp_path / "b.nc")
    p3 = str(tmp_path / "c.xyz")
    write_xtc(p1, fr[:3])
    write_ncdf(p2, fr[3:6])
    write_xyz(p3, fr[6:])
    u = Universe(u0.topology, [p1, p2, p3])
    assert u.trajectory.n_frames == 9
    # frames renumber globally; positions match the source (XTC is
    # 0.001-A quantized, XYZ 1e-6 text)
    np.testing.assert_allclose(u.trajectory[4].positions, fr[4],
                               atol=1e-5)
    np.testing.assert_allclose(u.trajectory[8].positions, fr[8],
                               atol=1e-4)
    block, _ = u.trajectory.read_block(2, 7)      # spans two boundaries
    np.testing.assert_allclose(block, fr[2:7], atol=1e-2)
    ju = JUniverse(_jax_topology(u0), [p1, p2, p3])
    np.testing.assert_array_equal(block, ju.trajectory.read_block(2, 7)[0])
    np.testing.assert_array_equal(u.trajectory.read_block(0, 9)[0],
                                  ju.trajectory.read_block(0, 9)[0])


def _jax_topology(u):
    """The JAX package's Topology with the port topology's arrays."""
    from mdanalysis_mpi_tpu.core.topology import Topology as JTopology

    t = u.topology
    return JTopology(names=t.names, resnames=t.resnames, resids=t.resids,
                     segids=t.segids, masses=t.masses)
