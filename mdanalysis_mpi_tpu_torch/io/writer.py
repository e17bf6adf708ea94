"""Streaming multi-frame trajectory writer (upstream ``mda.Writer``).

The reference's oracle workflow writes aligned trajectories to disk when
``in_memory=False`` (the default of upstream ``align.AlignTraj``, whose
in-memory variant the reference docstring pins at RMSF.py:12).  The
one-shot writers (:func:`~mdanalysis_mpi_tpu_torch.io.xtc.write_xtc`
et al.) need the full ``(F, N, 3)`` array in memory; this class streams
frames in chunks of any size, so a 10k-frame alignment never
materializes more than one batch on the host.

Append strategy, per format:

- **XTC/TRR**: frames are self-delimiting XDR records at arbitrary
  offsets, so chunk files concatenate byte-wise into one valid
  trajectory (the same property the frame-parallel decoder and the
  bench fixture generator exploit).
- **DCD**: the header is a fixed 196-byte prefix (record markers + 84-
  byte icntrl + 92-byte title record + 12-byte natoms record — see
  ``dcd_write`` in ``io/native/trajio.cpp``); frames are fixed-size
  records.  Chunks after the first are appended with the header
  stripped, and the two frame-count fields (icntrl[0] at byte 8,
  icntrl[3] at byte 20, little-endian u32) are patched on ``close()``.
- **NetCDF**: chunks after the first are appended without their header
  (its length, measured once from the first chunk, is fixed by the
  atom count and the box and velocity flags, which may not change),
  and ``numrecs`` (bytes 4:8, big-endian) is patched on ``close()``.
- **XYZ**: text frames concatenate as they are.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_DCD_HEADER_BYTES = 196
_DCD_NFRAMES_OFFSETS = (8, 20)   # icntrl[0], icntrl[3]
_CHUNK_SUFFIX = ".mdtpu_chunk"


class TrajectoryWriter:
    """Write a trajectory file frame-by-frame or chunk-by-chunk.

    ``format`` defaults to the file extension (xtc | trr | dcd |
    nc/ncdf | xyz).
    ``write()`` accepts a single ``(N, 3)`` frame, an ``(F, N, 3)``
    chunk, an :class:`~mdanalysis_mpi_tpu_torch.core.groups.AtomGroup`,
    a :class:`~mdanalysis_mpi_tpu_torch.core.universe.Universe`
    (current frame, upstream ``W.write(ag)`` idiom), or a Timestep.
    Times/steps default to the running frame index.  Context-manager
    friendly::

        with TrajectoryWriter("out.xtc") as w:
            for block, boxes in blocks:
                w.write(block, dimensions=boxes)
    """

    def __init__(self, path: str, n_atoms: int | None = None,
                 format: str | None = None, precision: float = 1000.0,
                 dt: float = 1.0):
        fmt = (format or os.path.splitext(path)[1].lstrip(".")).lower()
        if fmt == "nc":
            fmt = "ncdf"
        if fmt not in ("xtc", "trr", "dcd", "ncdf", "xyz"):
            raise ValueError(
                f"unsupported trajectory format {fmt!r} for {path!r} "
                "(xtc, trr, dcd, nc/ncdf, xyz)")
        self.path = path
        self.format = fmt
        self.n_atoms = n_atoms
        self.frames_written = 0
        self._precision = precision
        self._dt = dt
        self._box_flag: bool | None = None   # DCD/NetCDF: cells all-or-none
        self._vel_flag: bool | None = None   # NetCDF: velocities likewise
        self._ncdf_strip: int | None = None  # later chunks' header length
        self._file = open(path, "wb")
        # per-instance temp name: two writers targeting the same output
        # path (or a crashed run's leftover) must not clobber each
        # other's in-flight chunk file
        self._chunk_path = (f"{path}{_CHUNK_SUFFIX}"
                            f".{os.getpid()}.{id(self):x}")
        self._reap_orphans(path)
        self._closed = False

    @staticmethod
    def _reap_orphans(path: str) -> None:
        """Best-effort removal of chunk temp files a hard-killed run
        left behind for THIS output path — only when the embedded pid is
        verifiably dead (a live pid may still be mid-write)."""
        import glob

        for p in glob.glob(glob.escape(path + _CHUNK_SUFFIX) + ".*"):
            try:
                pid = int(p[len(path + _CHUNK_SUFFIX) + 1:].split(".")[0])
                os.kill(pid, 0)          # raises if no such process
            except ProcessLookupError:
                try:
                    os.remove(p)
                except OSError:
                    pass
            except (ValueError, OSError, PermissionError):
                pass

    # -- input normalization --

    def _coerce(self, obj):
        """obj → (coords (F,N,3) f32 view, dims (F,6) or None)."""
        from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
        from mdanalysis_mpi_tpu_torch.core.timestep import Timestep
        from mdanalysis_mpi_tpu_torch.core.universe import Universe

        dims = None
        if isinstance(obj, Universe):
            obj = obj.atoms
        if isinstance(obj, AtomGroup):
            ts = obj.universe.trajectory.ts
            coords = obj.positions
            dims = ts.dimensions
        elif isinstance(obj, Timestep):
            coords = obj.positions
            dims = obj.dimensions
        else:
            coords = np.asarray(obj, dtype=np.float32)
        coords = np.asarray(coords, dtype=np.float32)
        if coords.ndim == 2:
            coords = coords[None]
        if coords.ndim != 3 or coords.shape[2] != 3:
            raise ValueError(
                f"expected (N, 3) or (F, N, 3) coordinates, got "
                f"{coords.shape}")
        if dims is not None:
            dims = np.broadcast_to(np.asarray(dims, np.float32),
                                   (len(coords), 6))
        return coords, dims

    def write(self, obj, dimensions=None, times=None, steps=None,
              velocities=None, forces=None) -> int:
        """Append one frame or a chunk of frames; returns frames written
        so far."""
        if self._closed:
            raise ValueError(f"writer for {self.path!r} is closed")
        coords, auto_dims = self._coerce(obj)
        if dimensions is not None and self.format == "xyz":
            # EXPLICIT dimensions are refused like every unstorable
            # field; a Universe/AtomGroup's auto-dims stay droppable so
            # W.write(u) keeps working for box-carrying sources
            raise ValueError(
                "xyz stores no unit cell; drop dimensions= (the text "
                "format carries coordinates only)")
        if dimensions is None and self.format != "xyz":
            dimensions = auto_dims
        elif np.ndim(dimensions) == 1:
            dimensions = np.broadcast_to(
                np.asarray(dimensions, np.float32), (len(coords), 6))
        nf, na = coords.shape[:2]
        if nf == 0:
            # header-only chunks must not splice (a second chunk would
            # then keep its own header and corrupt dcd/ncdf record data)
            return self.frames_written
        if self.n_atoms is None:
            self.n_atoms = na
        elif na != self.n_atoms:
            raise ValueError(
                f"frame has {na} atoms, writer opened for {self.n_atoms}")
        has_box = dimensions is not None
        # ALL refusals precede any state latching: a rejected write must
        # not leave _box_flag/_vel_flag poisoned for the retry
        if (times is not None or steps is not None) \
                and self.format == "xyz":
            raise ValueError(
                "xyz stores no per-frame times/steps (text frames only)")
        if velocities is not None and self.format not in ("trr", "ncdf"):
            raise ValueError(
                f"{self.format} cannot store velocities (use trr/ncdf)")
        if forces is not None and self.format != "trr":
            raise ValueError(
                f"{self.format} cannot store forces (use trr)")
        if (times is not None or steps is not None) and self.format == "dcd":
            raise ValueError(
                "dcd stores no per-frame times/steps (only a fixed dt in "
                "the header — pass dt= to the writer instead)")
        if steps is not None and self.format == "ncdf":
            raise ValueError(
                "ncdf stores no integer step variable (AMBER convention "
                "keeps time only) — pass times= instead")
        if self.format in ("dcd", "ncdf"):
            # cell blocks are all-or-none: they change the fixed record
            # structure (DCD block layout; NetCDF record stride)
            if self._box_flag is not None and self._box_flag != has_box:
                raise ValueError(
                    f"{self.format} cannot mix frames with and without "
                    "unit cells")
        if self.format == "ncdf" and self._vel_flag is not None \
                and self._vel_flag != (velocities is not None):
            raise ValueError(
                "ncdf cannot mix frames with and without velocities "
                "(the record structure is fixed at the first chunk)")
        if self.format in ("dcd", "ncdf") and self._box_flag is None:
            self._box_flag = has_box
        if self.format == "ncdf" and self._vel_flag is None:
            self._vel_flag = velocities is not None
        if velocities is not None:
            velocities = np.asarray(velocities, np.float32)
            if velocities.ndim == 2:
                velocities = velocities[None]   # single-frame form,
                #                                 like the coords coerce
        lo = self.frames_written
        if times is None:
            times = np.arange(lo, lo + nf, dtype=np.float32) * self._dt
        if steps is None:
            steps = np.arange(lo, lo + nf, dtype=np.int32)

        # one-shot-write the chunk, then splice its bytes (the whole
        # sequence under one cleanup so a failed chunk write does not
        # leak the temp file)
        try:
            if self.format == "xtc":
                from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc

                write_xtc(self._chunk_path, coords, dimensions=dimensions,
                          times=np.asarray(times, np.float32),
                          steps=np.asarray(steps, np.int32),
                          precision=self._precision)
                strip = 0
            elif self.format == "trr":
                from mdanalysis_mpi_tpu_torch.io.trr import write_trr

                write_trr(self._chunk_path, coords, dimensions=dimensions,
                          times=np.asarray(times, np.float32),
                          steps=np.asarray(steps, np.int32),
                          velocities=velocities, forces=forces)
                strip = 0
            elif self.format == "xyz":
                from mdanalysis_mpi_tpu_torch.io.xyz import write_xyz

                write_xyz(self._chunk_path, coords,
                          start=self.frames_written)
                strip = 0
            elif self.format == "ncdf":
                from mdanalysis_mpi_tpu_torch.io.netcdf import write_ncdf

                write_ncdf(self._chunk_path, coords,
                           dimensions=dimensions,
                           times=np.asarray(times, np.float32),
                           velocities=velocities)
                if self.frames_written == 0:
                    strip = 0
                else:
                    if self._ncdf_strip is None:   # pragma: no cover
                        raise AssertionError("ncdf strip unset")
                    strip = self._ncdf_strip
                if self._ncdf_strip is None:
                    # header length is constant across chunks (same
                    # n_atoms/box/velocity structure — enforced above),
                    # measured once from the first chunk
                    from mdanalysis_mpi_tpu_torch.io.netcdf import (
                        _NC3Header)

                    with open(self._chunk_path, "rb") as cf:
                        hdr = _NC3Header(cf.read(65536),
                                         self._chunk_path)
                    self._ncdf_strip = min(
                        v["begin"] for v in hdr.vars.values()
                        if v["record"])
            else:
                from mdanalysis_mpi_tpu_torch.io.dcd import write_dcd

                write_dcd(self._chunk_path, coords, dimensions=dimensions,
                          dt=self._dt)
                strip = 0 if self.frames_written == 0 else _DCD_HEADER_BYTES
            with open(self._chunk_path, "rb") as f:
                if strip:
                    f.seek(strip)
                while True:
                    buf = f.read(1 << 24)
                    if not buf:
                        break
                    self._file.write(buf)
        finally:
            if os.path.exists(self._chunk_path):
                os.remove(self._chunk_path)
        self.frames_written += nf
        return self.frames_written

    def close(self) -> None:
        if self._closed:
            return
        self._file.close()
        self._closed = True
        if self.format == "ncdf" and self.frames_written:
            # patch numrecs (bytes 4:8, big-endian) — each chunk's
            # header recorded only its own frame count
            with open(self.path, "r+b") as f:
                f.seek(4)
                f.write(struct.pack(">i", self.frames_written))
        if self.format == "dcd" and self.frames_written:
            # patch the two frame-count fields the first chunk's header
            # recorded for only its own frames
            with open(self.path, "r+b") as f:
                for off in _DCD_NFRAMES_OFFSETS:
                    f.seek(off)
                    f.write(struct.pack("<I", self.frames_written))

    def __del__(self):
        # a never-closed DCD writer would otherwise leave the header's
        # frame count claiming only the first chunk's frames
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "TrajectoryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def Writer(path: str, n_atoms: int | None = None, **kwargs):
    """Upstream-style factory: ``mda.Writer(filename, n_atoms)``."""
    return TrajectoryWriter(path, n_atoms=n_atoms, **kwargs)
