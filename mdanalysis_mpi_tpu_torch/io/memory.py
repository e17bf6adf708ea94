"""In-memory ndarray-backed trajectory.

The reference builds one of these implicitly at RMSF.py:113:
``mda.Universe(GRO, positions.reshape((1, -1, 3)))`` wraps a raw ndarray
as a single-frame trajectory.  Here it is also the staging format for
TPU frame blocks and the backbone of synthetic test fixtures.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.timestep import Timestep
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase, note_numpy_fallback
from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS


class MemoryReader(ReaderBase):
    """Trajectory over a coordinate array of shape (n_frames, n_atoms, 3).

    Reads *copy* the stored frame so in-place Timestep edits do not
    persist across reads — matching the file-backed semantics the
    reference relies on (pass 2 re-reads pristine frames after pass 1's
    in-place rotations, RMSF.py:124; SURVEY.md §2.1 "Pass 2").
    """

    def __init__(self, coordinates: np.ndarray,
                 dimensions: np.ndarray | None = None,
                 dt: float = 1.0, times: np.ndarray | None = None,
                 velocities: np.ndarray | None = None):
        coords = np.asarray(coordinates, dtype=np.float32)
        if coords.ndim == 2:
            coords = coords[None]
        if coords.ndim != 3 or coords.shape[2] != 3:
            raise ValueError(
                f"coordinates must be (n_frames, n_atoms, 3), got {coords.shape}")
        self._coords = coords
        if velocities is not None:
            velocities = np.asarray(velocities, dtype=np.float32)
            if velocities.ndim == 2:
                velocities = velocities[None]
            if velocities.shape != coords.shape:
                raise ValueError(
                    f"velocities must match coordinates {coords.shape}, "
                    f"got {velocities.shape}")
        self._vels = velocities
        if dimensions is not None:
            dimensions = np.asarray(dimensions, dtype=np.float32)
            if dimensions.ndim == 1:
                dimensions = np.broadcast_to(
                    dimensions, (coords.shape[0], 6)).copy()
            if dimensions.shape != (coords.shape[0], 6):
                raise ValueError(
                    f"dimensions must be (n_frames, 6), got {dimensions.shape}")
        self._dims = dimensions
        self._dt = float(dt)
        if times is not None:
            times = np.asarray(times, dtype=np.float64)
            if times.shape != (coords.shape[0],):
                raise ValueError(
                    f"times must be ({coords.shape[0]},), got {times.shape}")
        self._times = times

    @property
    def n_frames(self) -> int:
        return self._coords.shape[0]

    @property
    def n_atoms(self) -> int:
        return self._coords.shape[1]

    @property
    def coordinates(self) -> np.ndarray:
        """The full backing array (n_frames, n_atoms, 3) — zero-copy."""
        return self._coords

    def _read_frame(self, i: int) -> Timestep:
        t = (i * self._dt) if self._times is None else float(self._times[i])
        return Timestep(
            self._coords[i].copy(), frame=i, time=t,
            dimensions=None if self._dims is None else self._dims[i].copy(),
            velocities=None if self._vels is None else self._vels[i].copy())

    def reopen(self) -> "MemoryReader":
        """Independent cursor over the same backing array (zero-copy),
        supporting ``Universe.copy()`` (RMSF.py:57 semantics)."""
        return MemoryReader(self._coords, self._dims, self._dt,
                            times=self._times, velocities=self._vels)

    def frame_times(self, frames) -> np.ndarray:
        idx = np.asarray(list(frames), dtype=np.int64)
        if self._times is not None:
            return self._times[idx]
        return idx.astype(np.float64) * self._dt

    def read_block(self, start: int, stop: int, sel=None, step: int = 1):
        if self.transformations:
            # transformed reads must go through the generic
            # read-transform-gather loop (ReaderBase)
            return ReaderBase.read_block(self, start, stop, sel=sel,
                                         step=step)
        if not 0 <= start <= stop <= self.n_frames:
            raise IndexError(f"block [{start},{stop}) out of range [0,{self.n_frames}]")
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        boxes = (None if self._dims is None
                 else self._dims[start:stop:step].copy())
        if sel is None:
            return self._coords[start:stop:step].copy(), boxes
        # slice + advanced index = a single gather copy
        return self._coords[start:stop:step, sel], boxes

    def stage_block(self, start: int, stop: int, sel=None,
                    quantize: bool = False, layout: str = "interleaved"):
        """Gather (+quantize) straight from the backing array in C++ —
        no intermediate ``read_block`` copy.  In-memory trajectories are
        the staging fast path (the reference's RMSF.py:113 in-memory
        universe generalized to the TPU feed), so this one fused pass is
        where the staging cycles go.  A planar int16 request is one
        native pass that writes the ``(3, B, S)`` planes itself, its
        frames split over host threads (``native.stage_threads``); the
        NumPy fallback and int8 stage interleaved, then one
        ``planar_repack``."""
        if not 0 <= start <= stop <= self.n_frames:
            raise IndexError(
                f"block [{start},{stop}) out of range [0,{self.n_frames}]")
        from mdanalysis_mpi_tpu_torch.io.base import norm_quantize, planar_repack

        qmode = norm_quantize(quantize)
        if layout == "planar":
            if qmode is None:
                raise ValueError(
                    "layout='planar' requires quantized staging "
                    "(int16/int8); float32 blocks stay interleaved")
            if qmode == "int16" and not self.transformations:
                return self._stage_planar_int16(start, stop, sel)
            q, boxes, inv_scale = self.stage_block(start, stop, sel=sel,
                                                   quantize=quantize)
            return planar_repack(q), boxes, inv_scale

        if self.transformations:
            return ReaderBase.stage_block(self, start, stop, sel=sel,
                                          quantize=quantize)
        boxes = None if self._dims is None else self._dims[start:stop].copy()
        view = self._coords[start:stop]
        with TIMERS.phase("gather"):
            if qmode == "int8":
                # no fused native int8 kernel; quantize straight off the
                # backing view (no intermediate read_block copy)
                from mdanalysis_mpi_tpu_torch.staging import quantize_block

                q, inv_scale = quantize_block(
                    view if sel is None else view[:, sel], "int8")
                METRICS.inc("mdtpu_stage_blocks_total", path="numpy")
                return q, boxes, inv_scale
            if qmode is not None:
                # adaptive one-pass gather+quantize (ReaderBase helper)
                q, inv_scale = self._quantize_staged(view, sel)
                return q, boxes, inv_scale
            try:
                from mdanalysis_mpi_tpu_torch.io import native

                block = native.stage_gather(view, sel)
            except Exception as exc:
                block = view[:, sel] if sel is not None else view.copy()
                note_numpy_fallback(exc)
                return block, boxes, None
            METRICS.inc("mdtpu_stage_blocks_total", path="native")
            return block, boxes, None

    def _stage_planar_int16(self, start: int, stop: int, sel):
        """The planar int16 block of frames ``[start, stop)``: gather,
        quantize and planar write in one native pass over
        ``native.stage_threads`` host threads, all inside ``gather``."""
        from mdanalysis_mpi_tpu_torch.io import native

        boxes = None if self._dims is None else self._dims[start:stop].copy()
        view = self._coords[start:stop]
        with TIMERS.phase("gather"):
            q, inv_scale = self._quantize_staged(
                view, sel, threads=native.stage_threads(stop - start))
        return q, boxes, inv_scale
