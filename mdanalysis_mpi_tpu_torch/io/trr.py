"""TRR (GROMACS full-precision) trajectory reader/writer.

Completes the GROMACS trajectory pair next to XTC (SURVEY.md §2.2 "and
TRR if cheap" — it is: TRR is plain big-endian XDR with no bit-packed
compression, so NumPy ``frombuffer`` decodes at memcpy speed and no C++
codec is needed).  Layout per frame (libxdrfile ``t_trnheader``
semantics, reimplemented from the on-disk format):

- magic ``1993`` (i4), version-string length ``13`` (i4), XDR string
  ``"GMX_trn_file"`` (i4 length + 12 bytes),
- 13 i4 fields: ir/e/box/vir/pres/top/sym sizes, x/v/f sizes, natoms,
  step, nre,
- time + lambda in the frame's float width (4 or 8 bytes, inferred
  from box_size/x_size as upstream does),
- payload: box (3×3), virial, pressure, positions, velocities, forces
  — each present iff its size field is nonzero.

Frame byte size is fully determined by the header, so the offset index
is a cheap header-hop scan (cached to disk like the XTC index).
Single-frame reads expose velocities/forces on the Timestep when the
frame carries them (upstream units: Å/ps, kJ/(mol·Å)); the bulk
``read_block`` staging path reads positions+box only (the analysis
kernels consume coordinates).  Coordinates convert nm→Å at the
boundary, matching the rest of the io layer.

``read_block`` decodes one contiguous file read via vectorized
``np.frombuffer``/``astype``: no bit-unpacking as in XTC, so no native
codec is needed; the cost is the big-endian→native byteswap at memory
bandwidth.  TRR files are ~2.1× larger than XTC for the same data.
"""

from __future__ import annotations

import os

import numpy as np

from mdanalysis_mpi_tpu_torch.core.box import box_to_vectors, vectors_to_box
from mdanalysis_mpi_tpu_torch.core.timestep import Timestep
from mdanalysis_mpi_tpu_torch.io import trajectory_files
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase

_NM_TO_A = 10.0
_MAGIC = 1993
_TAG = b"GMX_trn_file"
# magic + slen + (strlen + 12 tag bytes) + 13 i4 header fields
_HEAD_INTS = 13
_HEAD_BYTES = 4 + 4 + (4 + len(_TAG)) + 4 * _HEAD_INTS


class _Header:
    __slots__ = ("sizes", "natoms", "step", "flsize", "payload_start",
                 "frame_bytes", "x_off")

    # order of the 13 i4 fields after the version tag
    _FIELDS = ("ir_size", "e_size", "box_size", "vir_size", "pres_size",
               "top_size", "sym_size", "x_size", "v_size", "f_size",
               "natoms", "step", "nre")


def _parse_header(buf: bytes, offset: int, path: str) -> _Header:
    if len(buf) - offset < _HEAD_BYTES:
        raise IOError(f"truncated TRR header in {path!r} at byte {offset}")
    ints = np.frombuffer(buf, dtype=">i4", count=2, offset=offset)
    if ints[0] != _MAGIC:
        raise IOError(
            f"bad TRR magic {int(ints[0])} in {path!r} at byte {offset}")
    if ints[1] != len(_TAG) + 1:
        raise IOError(f"bad TRR version-string length in {path!r}")
    strlen = int(np.frombuffer(buf, ">i4", 1, offset + 8)[0])
    if strlen != len(_TAG) or buf[offset + 12:offset + 12 + strlen] != _TAG:
        raise IOError(f"bad TRR version tag in {path!r}")
    fields = np.frombuffer(buf, ">i4", _HEAD_INTS,
                           offset + 12 + len(_TAG))
    h = _Header()
    h.sizes = dict(zip(_Header._FIELDS, (int(v) for v in fields)))
    h.natoms = h.sizes["natoms"]
    h.step = h.sizes["step"]
    # float width inferred exactly as upstream nFloatSize()
    if h.sizes["box_size"]:
        h.flsize = h.sizes["box_size"] // 9
    elif h.sizes["x_size"]:
        h.flsize = h.sizes["x_size"] // (3 * h.natoms)
    elif h.sizes["v_size"]:
        h.flsize = h.sizes["v_size"] // (3 * h.natoms)
    elif h.sizes["f_size"]:
        h.flsize = h.sizes["f_size"] // (3 * h.natoms)
    else:
        h.flsize = 4
    if h.flsize not in (4, 8):
        raise IOError(f"unsupported TRR float width {h.flsize} in {path!r}")
    s = h.sizes
    h.payload_start = offset + _HEAD_BYTES + 2 * h.flsize   # after t, lambda
    h.x_off = (h.payload_start + s["box_size"] + s["vir_size"]
               + s["pres_size"])
    h.frame_bytes = (h.x_off - offset + s["x_size"] + s["v_size"]
                     + s["f_size"])
    return h


from mdanalysis_mpi_tpu_torch.io import _offsets

_offset_cache_path = _offsets.cache_path    # shared scheme with XTC


def _scan(path: str):
    """Header-hop offset scan: seek+read ~90 bytes per frame (never the
    payload — a full-precision TRR can be tens of GB), with the shared
    mtime-validated cache (SURVEY.md §2.2 random-access requirement)."""
    cached = _offsets.load(path)
    if cached is not None:
        return cached
    mtime = os.path.getmtime(path)     # BEFORE the scan (_offsets.save)
    size = os.path.getsize(path)
    offsets = []
    natoms = -1
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            f.seek(pos)
            # header + t/lambda at their widest (2×f8): enough to size
            # the whole frame without touching its payload
            head = f.read(_HEAD_BYTES + 16)
            h = _parse_header(head, 0, path)
            if natoms == -1:
                natoms = h.natoms
            elif h.natoms != natoms:
                raise IOError(
                    f"TRR {path!r}: frame {len(offsets)} has {h.natoms} "
                    f"atoms, expected {natoms}")
            offsets.append(pos)
            pos += h.frame_bytes
    offsets = np.asarray(offsets, dtype=np.int64)
    _offsets.save(path, offsets, natoms, mtime)
    return offsets, natoms


class TRRReader(ReaderBase):
    """Random-access TRR reader (positions in Å, box as dimensions).

    Frames without positions (``x_size == 0`` — TRR interleaves
    energy-only frames in some workflows) raise on access rather than
    returning garbage.
    """

    def __init__(self, path: str, n_atoms: int | None = None):
        self._path = path
        self._offsets, self._natoms = _scan(path)
        if n_atoms is not None and n_atoms != self._natoms:
            raise ValueError(
                f"TRR {path!r} has {self._natoms} atoms, expected {n_atoms}")
        self._file = open(path, "rb")

    @property
    def n_frames(self) -> int:
        return len(self._offsets)

    @property
    def n_atoms(self) -> int:
        return self._natoms

    def reopen(self) -> "TRRReader":
        return TRRReader(self._path)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def _read_frame(self, i: int) -> Timestep:
        off = int(self._offsets[i])
        # read just this frame's bytes (header declares the exact size)
        self._file.seek(off)
        head = self._file.read(_HEAD_BYTES + 16)
        h = _parse_header(head, 0, self._path)
        self._file.seek(off)
        buf = self._file.read(h.frame_bytes)
        if h.sizes["x_size"] == 0:
            raise IOError(
                f"TRR {self._path!r} frame {i} carries no positions")
        fl = ">f4" if h.flsize == 4 else ">f8"
        x = np.frombuffer(buf, fl, 3 * h.natoms, h.x_off)
        coords = np.ascontiguousarray(
            x.astype(np.float32).reshape(h.natoms, 3)) * _NM_TO_A
        dims = None
        if h.sizes["box_size"]:
            vecs = np.frombuffer(buf, fl, 9, h.payload_start)
            dims = vectors_to_box(vecs.astype(np.float64).reshape(3, 3)
                                  * _NM_TO_A)
            if not dims[:3].any():
                dims = None
        # velocities (nm/ps → Å/ps) and forces (kJ/mol/nm → kJ/mol/Å)
        # when the frame carries them — upstream Timestep units
        vel = frc = None
        if h.sizes["v_size"]:
            v = np.frombuffer(buf, fl, 3 * h.natoms,
                              h.x_off + h.sizes["x_size"])
            vel = v.astype(np.float32).reshape(h.natoms, 3) * _NM_TO_A
        if h.sizes["f_size"]:
            fo = np.frombuffer(buf, fl, 3 * h.natoms,
                               h.x_off + h.sizes["x_size"]
                               + h.sizes["v_size"])
            frc = fo.astype(np.float32).reshape(h.natoms, 3) / _NM_TO_A
        t = float(np.frombuffer(buf, fl, 1, _HEAD_BYTES)[0])
        return Timestep(coords, frame=i, time=t, dimensions=dims,
                        velocities=vel, forces=frc)

    def frame_times(self, frames) -> np.ndarray:
        idx = np.asarray(list(frames), dtype=np.int64)
        times = np.empty(len(idx), dtype=np.float64)
        for j, i in enumerate(idx):
            self._file.seek(int(self._offsets[i]))
            head = self._file.read(_HEAD_BYTES + 16)
            h = _parse_header(head, 0, self._path)
            fl = ">f4" if h.flsize == 4 else ">f8"
            times[j] = np.frombuffer(head, fl, 1, _HEAD_BYTES)[0]
        return times

    def read_block(self, start: int, stop: int, sel=None, step: int = 1):
        if self.transformations:
            # transformed reads must go through the generic
            # read-transform-gather loop (ReaderBase)
            return ReaderBase.read_block(self, start, stop, sel=sel,
                                         step=step)
        if not 0 <= start <= stop <= self.n_frames:
            raise IndexError(
                f"block [{start},{stop}) out of range [0,{self.n_frames}]")
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        n_out = self._natoms if sel is None else len(sel)
        if start == stop:
            return np.empty((0, n_out, 3), np.float32), None
        # one contiguous file read for the whole block, then per-frame
        # frombuffer views (the bulk staging path, SURVEY.md §7 layer 2)
        first = int(self._offsets[start])
        self._file.seek(first)
        if stop < self.n_frames:
            nbytes = int(self._offsets[stop]) - first
            buf = self._file.read(nbytes)
        else:
            buf = self._file.read()
        frames = range(start, stop, step)
        out = np.empty((len(frames), n_out, 3), dtype=np.float32)
        boxes = None
        for j, i in enumerate(frames):
            base = int(self._offsets[i]) - first
            # header fields parsed at `base` yield offsets relative to buf
            h = _parse_header(buf, base, self._path)
            if h.sizes["x_size"] == 0:
                raise IOError(
                    f"TRR {self._path!r} frame {i} carries no positions")
            fl = ">f4" if h.flsize == 4 else ">f8"
            x = np.frombuffer(buf, fl, 3 * h.natoms, h.x_off)
            frame = x.astype(np.float32).reshape(h.natoms, 3)
            out[j] = (frame if sel is None else frame[sel])
            if h.sizes["box_size"]:
                if boxes is None:
                    boxes = np.zeros((len(frames), 6), dtype=np.float32)
                vecs = np.frombuffer(buf, fl, 9, h.payload_start)
                boxes[j] = vectors_to_box(
                    vecs.astype(np.float64).reshape(3, 3) * _NM_TO_A)
        out *= _NM_TO_A
        return out, boxes


def write_trr(path: str, coordinates: np.ndarray,
              dimensions: np.ndarray | None = None,
              times: np.ndarray | None = None,
              steps: np.ndarray | None = None,
              velocities: np.ndarray | None = None,
              forces: np.ndarray | None = None) -> None:
    """Write (n_frames, n_atoms, 3) Å coordinates as a float32 TRR
    (positions + optional box/velocities/forces) — the fixture writer
    counterpart of :func:`TRRReader` (SURVEY.md §4).  ``velocities`` in
    Å/ps and ``forces`` in kJ/(mol·Å), the upstream Timestep units."""
    coords = np.asarray(coordinates, dtype=np.float32) / _NM_TO_A
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError(f"coordinates must be (F, N, 3), got {coords.shape}")
    nframes, natoms = coords.shape[:2]
    # validate ALL per-frame metadata up front: a length mismatch
    # surfacing as an IndexError mid-loop would leave a partial file
    if times is not None and len(times) != nframes:
        raise ValueError(
            f"times has {len(times)} entries for {nframes} frames")
    if steps is not None and len(steps) != nframes:
        raise ValueError(
            f"steps has {len(steps)} entries for {nframes} frames")
    def _per_atom(name, arr, scale):
        """Shape-check + unit-convert in one place (the only copy of
        the Å↔nm scale factors)."""
        if arr is None:
            return None
        arr = np.asarray(arr, np.float32)
        if arr.shape != coords.shape:
            raise ValueError(
                f"{name} must be shaped like coordinates {coords.shape}, "
                f"got {arr.shape}")
        return arr * np.float32(scale)

    vel = _per_atom("velocities", velocities, 1.0 / _NM_TO_A)  # Å/ps→nm/ps
    frc = _per_atom("forces", forces, _NM_TO_A)                # /Å → /nm
    if dimensions is not None:
        dimensions = np.asarray(dimensions)
        if dimensions.ndim == 1:
            if dimensions.shape != (6,):
                raise ValueError(
                    f"dimensions must be (6,) or ({nframes}, 6), got "
                    f"{dimensions.shape}")
            dimensions = np.broadcast_to(dimensions, (nframes, 6))
        elif dimensions.shape != (nframes, 6):
            raise ValueError(
                f"dimensions must be (6,) or ({nframes}, 6), got "
                f"{dimensions.shape}")
    with open(path, "wb") as f:
        for i in range(nframes):
            box_size = 36 if dimensions is not None else 0
            x_size = 12 * natoms
            v_size = x_size if vel is not None else 0
            f_size = x_size if frc is not None else 0
            head = np.array([_MAGIC, len(_TAG) + 1], dtype=">i4").tobytes()
            head += np.array([len(_TAG)], dtype=">i4").tobytes() + _TAG
            fields = [0, 0, box_size, 0, 0, 0, 0, x_size, v_size, f_size,
                      natoms, int(steps[i]) if steps is not None else i, 0]
            head += np.asarray(fields, dtype=">i4").tobytes()
            t = float(times[i]) if times is not None else 0.0
            head += np.asarray([t, 0.0], dtype=">f4").tobytes()
            f.write(head)
            if dimensions is not None:
                vecs = box_to_vectors(dimensions[i]) / _NM_TO_A
                f.write(np.asarray(vecs, dtype=">f4").tobytes())
            f.write(np.ascontiguousarray(coords[i], np.float32)
                    .astype(">f4").tobytes())
            if vel is not None:
                f.write(np.ascontiguousarray(vel[i], np.float32)
                        .astype(">f4").tobytes())
            if frc is not None:
                f.write(np.ascontiguousarray(frc[i], np.float32)
                        .astype(">f4").tobytes())


trajectory_files.register("trr", TRRReader)
