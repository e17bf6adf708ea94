"""XTC trajectory reader/writer over the native codec.

The reference's trajectory layer is MDAnalysis' Cython/C XTC stack
(random access via a frame-offset index, RMSF.py:56,92,124 — SURVEY.md
§2.2); here the decode core is C++ (io/native/trajio.cpp) and this
module adds the offset index with on-disk caching, the ``ReaderBase``
interface, bulk ``read_block`` staging, and Å↔nm unit conversion
(XTC stores nm; the framework's coordinate unit is Å).
"""

from __future__ import annotations

import ctypes
import functools
import os
from contextlib import contextmanager

import numpy as np

from mdanalysis_mpi_tpu_torch.core.box import box_to_vectors, vectors_to_box
from mdanalysis_mpi_tpu_torch.core.timestep import Timestep
from mdanalysis_mpi_tpu_torch.io import native, trajectory_files
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase, sel_fingerprint
from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

_NM_TO_A = 10.0


from mdanalysis_mpi_tpu_torch.io import _offsets

_offset_cache_path = _offsets.cache_path    # shared scheme with TRR


def _scan(path: str):
    """Frame offsets + natoms, with the shared mtime-validated on-disk
    cache (upstream builds and caches the same index — SURVEY.md §2.2)."""
    cached = _offsets.load(path)
    if cached is not None:
        return cached
    mtime = os.path.getmtime(path)     # BEFORE the scan (_offsets.save)
    lib = native.load()
    natoms = ctypes.c_int(-1)
    n = lib.xtc_scan(path.encode(), ctypes.byref(natoms), None, 0)
    if n < 0:
        raise IOError(f"cannot scan XTC file {path!r} (error {n})")
    offsets = np.zeros(n, dtype=np.int64)
    n2 = lib.xtc_scan(path.encode(), ctypes.byref(natoms),
                      offsets.ctypes.data_as(ctypes.c_void_p), n)
    if n2 != n:
        raise IOError(f"inconsistent XTC scan of {path!r}")
    _offsets.save(path, offsets, natoms.value, mtime)
    return offsets, natoms.value


class XTCReader(ReaderBase):
    """Random-access XTC reader (coordinates in Å, box as dimensions)."""

    def __init__(self, path: str, n_atoms: int | None = None):
        self._path = path
        self._offsets, self._natoms = _scan(path)
        self._size = os.path.getsize(path)
        if n_atoms is not None and n_atoms != self._natoms:
            raise ValueError(
                f"XTC {path!r} has {self._natoms} atoms, expected {n_atoms}")
        self._lib = native.load()

    @property
    def n_frames(self) -> int:
        return len(self._offsets)

    @contextmanager
    def _decoding(self, start: int, stop: int):
        """The ``decode`` phase around one native decode of frames
        ``[start, stop)`` made while staging; their compressed bytes,
        from the frame offsets, count in
        ``mdtpu_xtc_decoded_bytes_total``."""
        with TIMERS.phase("decode"):
            yield
        end = self._offsets[stop] if stop < self.n_frames else self._size
        METRICS.inc("mdtpu_xtc_decoded_bytes_total",
                    int(end - self._offsets[start]))

    @property
    def n_atoms(self) -> int:
        return self._natoms

    def reopen(self) -> "XTCReader":
        return XTCReader(self._path)

    def _read_range(self, idx: np.ndarray):
        n = len(idx)
        coords = np.empty((n, self._natoms, 3), dtype=np.float32)
        box = np.empty((n, 9), dtype=np.float32)
        times = np.empty(n, dtype=np.float32)
        steps = np.empty(n, dtype=np.int32)
        rc = self._lib.xtc_read_frames(
            self._path.encode(), self._offsets[idx], n, self._natoms,
            coords, box.ctypes.data_as(ctypes.c_void_p),
            times.ctypes.data_as(ctypes.c_void_p),
            steps.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IOError(f"XTC decode failed for {self._path!r} (error {rc})")
        coords *= _NM_TO_A
        return coords, box, times, steps

    def _read_frame(self, i: int) -> Timestep:
        coords, box, times, steps = self._read_range(np.array([i]))
        dims = vectors_to_box(box[0].reshape(3, 3) * _NM_TO_A)
        if not dims[:3].any():
            dims = None
        return Timestep(coords[0], frame=i, time=float(times[0]),
                        dimensions=dims)

    def frame_times(self, frames) -> np.ndarray:
        # XTC frame layout: magic, natoms, step, time (XDR big-endian) —
        # time sits 12 bytes into each frame, readable without decoding
        idx = np.asarray(list(frames), dtype=np.int64)
        times = np.empty(len(idx), dtype=np.float64)
        with open(self._path, "rb") as f:
            for j, i in enumerate(idx):
                f.seek(int(self._offsets[i]) + 12)
                times[j] = np.frombuffer(f.read(4), ">f4")[0]
        return times

    def _dims_from_raw(self, box: np.ndarray):
        """(F, 9) nm box vectors → (F, 6) Å dimensions, or None when the
        whole block is boxless (all-zero), matching read_block's
        contract."""
        boxes = np.stack([
            vectors_to_box(b.reshape(3, 3) * _NM_TO_A) for b in box])
        if not boxes[:, :3].any():
            return None
        return boxes

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
        if start == stop:
            n = self._natoms if sel is None else len(sel)
            return np.empty((0, n, 3), np.float32), None
        idx = np.arange(start, stop, step)
        if sel is not None:
            # fused decode→gather→Å: the full-system float32 block is
            # never materialized (cold-path staging; see trajio.cpp
            # xtc_stage_f32)
            coords, box = native.xtc_stage_f32(
                self._path, self._offsets[idx], self._natoms, sel)
            return coords, self._dims_from_raw(box)
        coords, box, _, _ = self._read_range(idx)
        return coords, self._dims_from_raw(box)

    def stage_block(self, start: int, stop: int, sel=None,
                    quantize: bool = False, layout: str = "interleaved"):
        """Staging primitive with the decode fused in (overrides the
        read-then-quantize base path): on the int16 leg each frame goes
        XDR bits → scratch → selection int16 in one native call, cutting
        the cold path's DRAM traffic by the full-system float32 block
        (~3.6 MB/frame at the flagship config).  Scale-hint mechanics
        mirror ``ReaderBase._quantize_staged`` (adaptive one-pass with
        exact re-run on overflow, hints scoped per selection content).

        The interleaved block's frames split over
        ``MDTPU_DECODE_THREADS`` threads (``path="native"``).  A planar
        int16 request is the same native pass writing the ``(3, B, S)``
        planes itself, its frames split over ``native.stage_threads``
        host threads, with no ``planar_repack``: counted as
        ``path="xtc_planar"``, the count set as the
        ``mdtpu_stage_threads`` gauge.  A fresh reader's first block
        (no scale hint yet) is a float32 decode of the selection over
        the same threads, then ``_quantize_staged``'s exact kernel,
        which counts it.

        Each native decode (the fused call, its re-run on overflow, the
        float32 read that seeds a fresh reader's hint) runs in a
        ``decode`` phase inside ``gather`` and counts its compressed
        bytes in ``mdtpu_xtc_decoded_bytes_total``; a re-run also counts
        in ``mdtpu_xtc_redecodes_total``.
        """
        if not 0 <= start <= stop <= self.n_frames:
            raise IndexError(
                f"block [{start},{stop}) out of range [0,{self.n_frames}]")
        from mdanalysis_mpi_tpu_torch.io.base import norm_quantize

        qmode = norm_quantize(quantize)
        if layout == "planar" and qmode is None:
            raise ValueError(
                "layout='planar' requires quantized staging "
                "(int16/int8); float32 blocks stay interleaved")
        if self.transformations or qmode == "int8":
            # int8 has no fused native kernel (opt-in coarse path);
            # the base read-then-quantize handles it
            return ReaderBase.stage_block(self, start, stop, sel=sel,
                                          quantize=quantize, layout=layout)
        with TIMERS.phase("gather"):
            if qmode is None:
                with self._decoding(start, stop):
                    block, boxes = self.read_block(start, stop, sel=sel)
                METRICS.inc("mdtpu_stage_blocks_total", path="generic")
                return block, boxes, None
            if start == stop:
                block, boxes = self.read_block(start, stop, sel=sel)
                from mdanalysis_mpi_tpu_torch.staging import quantize_block

                q, inv_scale = quantize_block(block, layout=layout)
                METRICS.inc("mdtpu_stage_blocks_total", path="numpy")
                return q, boxes, inv_scale
            threads = None
            stage = native.xtc_stage_i16
            if layout == "planar":
                threads = native.stage_threads(stop - start)
                stage = functools.partial(native.xtc_stage_i16_planar,
                                          threads=threads)
            hints = self._quant_hints()
            key = sel_fingerprint(sel)
            hint = hints.get(key, 0.0)
            offs = self._offsets[start:stop]
            if hint > 0.0:
                # float64 scale arithmetic, shared policy constants —
                # must stay bit-identical to ReaderBase._quantize_staged
                scale = self.QUANT_TARGET / (hint * self.QUANT_MARGIN)
                with self._decoding(start, stop):
                    q, box, vmax, overflowed = stage(
                        self._path, offs, self._natoms, sel, scale)
                if vmax > hint:
                    hints[key] = vmax
                inv_scale = np.float32(1.0 / scale)
                if overflowed:
                    scale = self.QUANT_TARGET / max(vmax, 1e-30)
                    with self._decoding(start, stop):
                        q, box, vmax, _ = stage(
                            self._path, offs, self._natoms, sel, scale)
                    METRICS.inc("mdtpu_xtc_redecodes_total")
                    inv_scale = np.float32(1.0 / scale)
                    # as _quantize_staged's exact re-run: the exact
                    # scale encodes the block max
                    hints[key] = max(hints[key],
                                     float(inv_scale) * self.QUANT_TARGET)
                if threads is None:
                    METRICS.inc("mdtpu_stage_blocks_total", path="native")
                else:
                    METRICS.inc("mdtpu_stage_blocks_total",
                                path="xtc_planar")
                    METRICS.set_gauge("mdtpu_stage_threads", threads)
                return q, self._dims_from_raw(box), inv_scale
            # first block for this selection: fused f32 decode,
            # exact-scale quantize (bit-identical to the NumPy
            # reference), seed the hint
            with self._decoding(start, stop):
                block, box = native.xtc_stage_f32(
                    self._path, offs, self._natoms, sel, threads=threads)
            q, inv_scale = self._quantize_staged(block, None, sel_fp=key,
                                                 threads=threads)
            return q, self._dims_from_raw(box), inv_scale


def write_xtc(path: str, coordinates: np.ndarray,
              dimensions: np.ndarray | None = None,
              times: np.ndarray | None = None,
              steps: np.ndarray | None = None,
              precision: float = 1000.0) -> None:
    """Write (n_frames, n_atoms, 3) Å coordinates as a compressed XTC.

    ``precision`` is in the XTC convention (positions quantized to
    1/precision nm; 1000 ≈ 0.001 nm = 0.01 Å resolution).  This is the
    fixture *writer* SURVEY.md §4 requires (no MDAnalysisTests data
    offline).
    """
    coords = np.ascontiguousarray(
        np.asarray(coordinates, dtype=np.float32) / _NM_TO_A)
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError(f"coordinates must be (F, N, 3), got {coords.shape}")
    nframes, natoms = coords.shape[:2]
    boxp = None
    if dimensions is not None:
        dimensions = np.asarray(dimensions)
        if dimensions.ndim == 1:
            dimensions = np.broadcast_to(dimensions, (nframes, 6))
        box = np.stack([
            box_to_vectors(d) / _NM_TO_A for d in dimensions]
        ).astype(np.float32).reshape(nframes, 9)
        box = np.ascontiguousarray(box)
        boxp = box.ctypes.data_as(ctypes.c_void_p)
    timesp = stepsp = None
    if times is not None:
        times = np.ascontiguousarray(times, dtype=np.float32)
        timesp = times.ctypes.data_as(ctypes.c_void_p)
    if steps is not None:
        steps = np.ascontiguousarray(steps, dtype=np.int32)
        stepsp = steps.ctypes.data_as(ctypes.c_void_p)
    rc = native.load().xtc_write(path.encode(), natoms, nframes, coords,
                                 boxp, timesp, stepsp,
                                 ctypes.c_float(precision))
    if rc != 0:
        raise IOError(f"XTC write failed for {path!r} (error {rc})")


trajectory_files.register("xtc", XTCReader)
