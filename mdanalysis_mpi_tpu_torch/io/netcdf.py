"""Amber NetCDF trajectory format (upstream ``coordinates.TRJ`` /
``NCDFReader``; the AMBER ``.nc``/``.ncdf`` convention).

A from-scratch NetCDF-3 implementation — no netCDF4/scipy dependency:
the classic (magic ``CDF\\x01``) and 64-bit-offset (``CDF\\x02``)
container is a small, fully specified binary header (dimension list,
global attributes, variable list with per-variable type/shape/offset)
followed by fixed-size data; record variables interleave per record
(frame) with a constant record stride.  The parser below reads ANY
conforming NetCDF-3 header; the reader then applies the AMBER
convention on top (dimensions ``frame``/``atom``/``spatial``;
variables ``coordinates`` (frame, atom, spatial) float32 Å, ``time``
(frame) float32 ps, optional ``cell_lengths``/``cell_angles`` (frame,
cell_spatial) double).

Writer: :func:`write_ncdf` emits the same convention (classic format,
``frame`` unlimited), so round-trips are exact at float32; the header
layout is additionally pinned against the NetCDF spec byte-for-byte in
``tests/test_netcdf.py`` (golden-offset checks), so reader and writer
cannot drift into a private dialect.

Random access: frame i's coordinates live at
``begin + i · recsize`` — O(1) seeks, and ``read_block`` slices whole
frame runs with one contiguous read per frame (the staging-primitive
contract, SURVEY.md §7 layer 2).
"""

from __future__ import annotations

import struct

import numpy as np

from mdanalysis_mpi_tpu_torch.core.timestep import Timestep
from mdanalysis_mpi_tpu_torch.io import trajectory_files
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

#: NetCDF external types → (numpy dtype, size)
_NC_TYPES = {
    1: (np.dtype(">i1"), 1),   # byte
    2: (np.dtype("S1"), 1),    # char
    3: (np.dtype(">i2"), 2),   # short
    4: (np.dtype(">i4"), 4),   # int
    5: (np.dtype(">f4"), 4),   # float
    6: (np.dtype(">f8"), 8),   # double
}


def _pad4(n: int) -> int:
    return (n + 3) & ~3


class _NC3Header:
    """Parsed NetCDF-3 header: ``dims`` [(name, length)], ``gatts``
    {name: value}, ``vars`` {name: dict(dims, dtype, vsize, begin,
    record)}, plus ``numrecs`` and ``recsize``."""

    def __init__(self, raw: bytes, path: str):
        self._b = raw
        self._o = 0
        self._path = path
        magic = self._take(3)
        if magic != b"CDF":
            raise ValueError(f"{path!r} is not a NetCDF file "
                             f"(magic {magic!r})")
        version = self._take(1)[0]
        if version not in (1, 2):
            raise ValueError(
                f"{path!r}: unsupported NetCDF version byte {version} "
                "(classic and 64-bit-offset only; NetCDF-4/HDF5 files "
                "need conversion, e.g. `nccopy -k classic`)")
        self._offsets64 = version == 2
        self.numrecs = self._int()           # 0xFFFFFFFF = streaming
        self.dims = self._dim_list()
        self.gatts = self._att_list()
        self.vars = self._var_list()
        rec_vars = [v for v in self.vars.values() if v["record"]]
        self.recsize = sum(_pad4(v["vsize"]) if len(rec_vars) > 1
                           else v["vsize"] for v in rec_vars)

    # -- primitive readers --
    def _take(self, n: int) -> bytes:
        b = self._b[self._o:self._o + n]
        if len(b) != n:
            raise ValueError(f"{self._path!r}: truncated NetCDF header")
        self._o += n
        return b

    def _int(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def _uint(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def _name(self) -> str:
        n = self._int()
        s = self._take(n).decode("ascii")
        self._take(_pad4(n) - n)
        return s

    def _dim_list(self):
        tag, n = self._int(), self._int()
        if tag not in (0, _NC_DIMENSION):
            raise ValueError(f"{self._path!r}: bad dim_list tag {tag}")
        return [(self._name(), self._int()) for _ in range(n)]

    def _att_list(self):
        tag, n = self._int(), self._int()
        if tag not in (0, _NC_ATTRIBUTE):
            raise ValueError(f"{self._path!r}: bad att_list tag {tag}")
        out = {}
        for _ in range(n):
            name = self._name()
            xtype = self._int()
            count = self._int()
            dt, size = _NC_TYPES[xtype]
            raw = self._take(count * size)
            self._take(_pad4(count * size) - count * size)
            if xtype == 2:
                out[name] = raw.decode("ascii", errors="replace")
            else:
                out[name] = np.frombuffer(raw, dt)
        return out

    def _var_list(self):
        tag, n = self._int(), self._int()
        if tag not in (0, _NC_VARIABLE):
            raise ValueError(f"{self._path!r}: bad var_list tag {tag}")
        out = {}
        for _ in range(n):
            name = self._name()
            ndims = self._int()
            dimids = [self._int() for _ in range(ndims)]
            atts = self._att_list()
            xtype = self._int()
            vsize = self._uint()
            begin = (struct.unpack(">Q", self._take(8))[0]
                     if self._offsets64 else self._uint())
            record = bool(dimids) and self.dims[dimids[0]][1] == 0
            shape = tuple(self.dims[d][1] for d in dimids)
            out[name] = {"dims": [self.dims[d][0] for d in dimids],
                         "shape": shape, "dtype": _NC_TYPES[xtype][0],
                         "vsize": vsize, "begin": begin,
                         "record": record, "atts": atts}
        return out


class NCDFReader(ReaderBase):
    """Random-access AMBER NetCDF trajectory reader (Å, ps)."""

    def __init__(self, path: str, n_atoms: int | None = None):
        self._path = path
        with open(path, "rb") as f:
            head = f.read(65536)
            hdr = _NC3Header(head, path)
            coords = hdr.vars.get("coordinates")
            if coords is None or not coords["record"] \
                    or coords["dims"][1:] != ["atom", "spatial"]:
                raise ValueError(
                    f"{path!r}: no (frame, atom, spatial) coordinates "
                    "variable — not an AMBER trajectory NetCDF")
            self._hdr = hdr
            self._natoms = coords["shape"][1]
            nrec = hdr.numrecs
            if nrec < 0:                     # streaming count: derive
                # the record region starts at the FIRST record
                # variable's begin (coordinates sit after time within
                # each record)
                rec_start = min(v["begin"] for v in hdr.vars.values()
                                if v["record"])
                f.seek(0, 2)
                data = f.tell() - rec_start
                nrec = data // hdr.recsize if hdr.recsize else 0
            self._nframes = int(nrec)
        if n_atoms is not None and n_atoms != self._natoms:
            raise ValueError(
                f"NetCDF {path!r} has {self._natoms} atoms, expected "
                f"{n_atoms}")
        self._file = open(path, "rb")

    @property
    def n_frames(self) -> int:
        return self._nframes

    @property
    def n_atoms(self) -> int:
        return self._natoms

    def reopen(self) -> "NCDFReader":
        return NCDFReader(self._path)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def _rec_field(self, var: str, i: int):
        v = self._hdr.vars[var]
        self._file.seek(v["begin"] + i * self._hdr.recsize)
        raw = self._file.read(v["vsize"])
        arr = np.frombuffer(raw, v["dtype"]).reshape(v["shape"][1:])
        # the AMBER convention allows a scale_factor attribute on ANY
        # variable (coordinates/velocities/cells/time) — apply it
        # uniformly, as upstream does
        sf = v["atts"].get("scale_factor")
        if sf is not None:
            arr = arr * np.asarray(sf).reshape(())[()]
        return arr

    def _read_frame(self, i: int) -> Timestep:
        if not 0 <= i < self._nframes:
            raise IndexError(
                f"frame {i} out of range [0, {self._nframes})")
        pos = self._rec_field("coordinates", i).astype(np.float32)
        time = 0.0
        if "time" in self._hdr.vars and self._hdr.vars["time"]["record"]:
            time = float(self._rec_field("time", i).reshape(()))
        dims = None
        if "cell_lengths" in self._hdr.vars \
                and "cell_angles" in self._hdr.vars:
            lengths = self._rec_field("cell_lengths", i).astype(
                np.float64)
            angles = self._rec_field("cell_angles", i).astype(np.float64)
            if np.all(lengths > 0):
                dims = np.concatenate([lengths, angles]).astype(
                    np.float32)
        vels = None
        vvar = self._hdr.vars.get("velocities")
        if vvar is not None and vvar["record"]:
            # scale_factor (AMBER 20.455 Å/ps convention) applied in
            # _rec_field like every variable's
            vels = self._rec_field("velocities", i).astype(np.float32)
        return Timestep(pos, frame=i, time=time, dimensions=dims,
                        velocities=vels)

    def frame_times(self, frames) -> np.ndarray | None:
        if "time" not in self._hdr.vars:
            return None
        return np.asarray([float(self._rec_field("time", int(i))
                                 .reshape(())) for i in frames])


def write_ncdf(path: str, frames: np.ndarray, dimensions=None,
               times=None, velocities=None,
               vel_scale_factor: float | None = None,
               # the JAX package's name: the same bytes from both
               title: str = "mdanalysis_mpi_tpu") -> None:
    """Write (F, N, 3) Å coordinates as an AMBER-convention NetCDF-3
    classic file (``frame`` unlimited; ``time`` ps; optional box as
    ``cell_lengths``/``cell_angles`` — one (6,) vector or per-frame
    (F, 6); optional ``velocities`` (F, N, 3) in Å/ps, stored divided
    by ``vel_scale_factor`` with the matching ``scale_factor``
    attribute when given — the AMBER 20.455 convention)."""
    frames = np.asarray(frames, np.float32)
    if frames.ndim != 3 or frames.shape[2] != 3:
        raise ValueError(f"frames must be (F, N, 3), got {frames.shape}")
    f_count, n_atoms, _ = frames.shape
    if times is None:
        times = np.arange(f_count, dtype=np.float32)
    times = np.asarray(times, np.float32)
    if len(times) != f_count:
        raise ValueError(
            f"{len(times)} times for {f_count} frames")
    has_box = dimensions is not None
    if has_box:
        dimensions = np.asarray(dimensions, np.float64)
        if dimensions.size == 6:
            dimensions = np.broadcast_to(dimensions.reshape(6),
                                         (f_count, 6))
        elif dimensions.shape != (f_count, 6):
            raise ValueError(
                f"dimensions must be (6,) or (F, 6), got "
                f"{dimensions.shape}")
    has_vel = velocities is not None
    if has_vel:
        velocities = np.asarray(velocities, np.float32)
        if velocities.shape != frames.shape:
            raise ValueError(
                f"velocities must match frames shape {frames.shape}, "
                f"got {velocities.shape}")
        if vel_scale_factor is not None:
            velocities = velocities / np.float32(vel_scale_factor)

    def name(s: str) -> bytes:
        b = s.encode("ascii")
        return struct.pack(">i", len(b)) + b + b"\0" * (_pad4(len(b))
                                                        - len(b))

    def att(k: str, v) -> bytes:
        if isinstance(v, str):
            b = v.encode("ascii")
            return (name(k) + struct.pack(">ii", 2, len(b)) + b
                    + b"\0" * (_pad4(len(b)) - len(b)))
        # numeric attributes are NC_FLOAT: the AMBER convention
        # specifies scale_factor as type float
        return (name(k) + struct.pack(">ii", 5, 1)
                + struct.pack(">f", float(v)))

    def att_list(pairs) -> bytes:
        if not pairs:
            return struct.pack(">ii", 0, 0)
        return (struct.pack(">ii", _NC_ATTRIBUTE, len(pairs))
                + b"".join(att(k, v) for k, v in pairs))

    dims = [("frame", 0), ("spatial", 3), ("atom", n_atoms)]
    if has_box:
        dims += [("cell_spatial", 3), ("cell_angular", 3)]
    dim_block = (struct.pack(">ii", _NC_DIMENSION, len(dims))
                 + b"".join(name(n) + struct.pack(">i", ln)
                            for n, ln in dims))
    gatts = att_list([("Conventions", "AMBER"),
                      ("ConventionVersion", "1.0"),
                      # the JAX package's name: the same bytes from both
                      ("program", "mdanalysis_mpi_tpu"),
                      ("programVersion", "1.0"),
                      ("title", title)])

    # record variables, in record order
    specs = [("time", [0], 5, 4, [("units", "picosecond")])]
    specs.append(("coordinates", [0, 2, 1], 5, n_atoms * 12,
                  [("units", "angstrom")]))
    if has_vel:
        vel_atts = [("units", "angstrom/picosecond")]
        if vel_scale_factor is not None:
            vel_atts.append(("scale_factor", float(vel_scale_factor)))
        specs.append(("velocities", [0, 2, 1], 5, n_atoms * 12,
                      vel_atts))
    if has_box:
        specs.append(("cell_lengths", [0, 3], 6, 24,
                      [("units", "angstrom")]))
        specs.append(("cell_angles", [0, 4], 6, 24,
                      [("units", "degree")]))
    n_rec_vars = len(specs)

    def var_header(nm, dimids, xtype, vsize, atts, begin):
        return (name(nm) + struct.pack(">i", len(dimids))
                + b"".join(struct.pack(">i", d) for d in dimids)
                + att_list(atts)
                + struct.pack(">iiI", xtype, vsize, begin))

    def build(begins):
        var_block = (struct.pack(">ii", _NC_VARIABLE, len(specs))
                     + b"".join(var_header(nm, dimids, xt, vs, atts,
                                           begins[j])
                                for j, (nm, dimids, xt, vs, atts)
                                in enumerate(specs)))
        return (b"CDF\x01" + struct.pack(">i", f_count)
                + dim_block + gatts + var_block)

    header_len = len(build([0] * n_rec_vars))
    aligned = [_pad4(vs) if n_rec_vars > 1 else vs
               for (_, _, _, vs, _) in specs]
    begins, off = [], header_len
    for a in aligned:
        begins.append(off)
        off += a
    header = build(begins)
    assert len(header) == header_len

    with open(path, "wb") as out:
        out.write(header)
        for i in range(f_count):
            rec = bytearray()
            rec += struct.pack(">f", float(times[i]))
            rec += b"\0" * (aligned[0] - 4)
            coord = frames[i].astype(">f4").tobytes()
            rec += coord + b"\0" * (aligned[1] - len(coord))
            if has_vel:
                rec += velocities[i].astype(">f4").tobytes()
            if has_box:
                rec += np.asarray(dimensions[i, :3], ">f8").tobytes()
                rec += np.asarray(dimensions[i, 3:], ">f8").tobytes()
            out.write(bytes(rec))


trajectory_files.register("nc", NCDFReader)
trajectory_files.register("ncdf", NCDFReader)
