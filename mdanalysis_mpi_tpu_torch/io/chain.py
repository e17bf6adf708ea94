"""ChainReader: several trajectory files presented as one.

Upstream-API mirror (``MDAnalysis.coordinates.chain.ChainReader``,
reached as ``Universe(top, [part1.xtc, part2.xtc])``): simulation
output commonly arrives in restart segments; the chain concatenates
them virtually — global frame i dispatches to the owning child reader
by cumulative offset.  ``read_block`` splits a window at child
boundaries and concatenates, so every piece rides its child's fused
native fast path (e.g. the XTC decode→gather f32 kernel).  For int16
staging, windows contained in ONE child pass straight through to that
child's fused decode→quantize kernel (the common case: batch windows
rarely straddle a segment boundary); boundary-straddling windows fall
back to read-then-quantize, since a single block carries a single
scale.  Transformations attach to the CHAIN, not to its parts (one
semantics for per-frame and block reads alike; enforced)."""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.io.base import ReaderBase
from mdanalysis_mpi_tpu_torch.core.timestep import Timestep


class ChainReader(ReaderBase):
    def __init__(self, sources, n_atoms: int | None = None):
        from mdanalysis_mpi_tpu_torch.io import trajectory_files

        readers = []
        for src in sources:
            if isinstance(src, ReaderBase):
                readers.append(src)
            elif isinstance(src, np.ndarray):
                from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

                readers.append(MemoryReader(src))
            else:
                readers.append(trajectory_files.open(src, n_atoms=n_atoms))
        if not readers:
            raise ValueError("ChainReader needs at least one trajectory")
        na = readers[0].n_atoms
        for j, r in enumerate(readers[1:], 1):
            if r.n_atoms != na:
                raise ValueError(
                    f"chained trajectory {j} has {r.n_atoms} atoms, "
                    f"the first has {na}")
        self._check_children(readers)
        self._readers = readers
        self._starts = np.concatenate(
            [[0], np.cumsum([r.n_frames for r in readers])])

    @property
    def n_frames(self) -> int:
        return int(self._starts[-1])

    @property
    def n_atoms(self) -> int:
        return self._readers[0].n_atoms

    @property
    def filename(self):
        return None          # many files; parts expose their own

    @property
    def filenames(self) -> list:
        return [r.filename for r in self._readers]

    def reopen(self) -> "ChainReader":
        return ChainReader([r.reopen() for r in self._readers])

    @staticmethod
    def _check_children(readers) -> None:
        """No child may carry transformations — per-frame reads go
        through the raw child ``_read_frame`` while block reads go
        through the child's ``read_block`` (which applies them), so a
        transformed child would make the two paths disagree.  Checked at
        construction AND on every dispatch: ``add_transformations`` on a
        child AFTER chaining must fail loudly, not skew results."""
        for j, r in enumerate(readers):
            if r.transformations:
                raise ValueError(
                    f"chained trajectory {j} has transformations attached; "
                    "add them to the ChainReader itself so per-frame and "
                    "block reads agree")

    def _locate(self, i: int) -> tuple[int, int]:
        k = int(np.searchsorted(self._starts, i, side="right")) - 1
        return k, i - int(self._starts[k])

    def _read_frame(self, i: int) -> Timestep:
        k, local = self._locate(i)
        # per-frame hot path: only the serving child can skew this read
        if self._readers[k].transformations:
            raise ValueError(
                f"chained trajectory {k} has transformations attached; "
                "add them to the ChainReader itself so per-frame and "
                "block reads agree")
        if self._readers[k].auxiliaries:
            # same loud contract as transformations: the chain bypasses
            # child cursor paths, so a child-attached auxiliary would
            # silently vanish from every chained frame
            raise ValueError(
                f"chained trajectory {k} has auxiliaries attached; "
                "attach them to the ChainReader itself "
                "(add_auxiliary on the chain)")
        ts = self._readers[k]._read_frame(local)
        ts.frame = i                     # global numbering
        return ts

    def _split(self, start: int, stop: int, step: int):
        """Yield (reader, local_start, local_stop, local_step) pieces
        covering [start:stop:step] in order."""
        i = start
        while i < stop:
            k, local = self._locate(i)
            child_end = int(self._starts[k + 1])
            seg_stop = min(stop, child_end)
            n = -(-(seg_stop - i) // step)          # frames in this piece
            yield (self._readers[k], local,
                   local + (n - 1) * step + 1, step)
            i += n * step

    def read_block(self, start: int, stop: int, sel=None, step: int = 1):
        self._check_children(self._readers)
        if not 0 <= start <= stop <= self.n_frames:
            raise IndexError(
                f"block [{start},{stop}) out of range [0,{self.n_frames}]")
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        if self.transformations:
            return ReaderBase.read_block(self, start, stop, sel=sel,
                                         step=step)
        blocks, boxes_list, any_box = [], [], False
        for r, a, b, st in self._split(start, stop, step):
            blk, boxes = r.read_block(a, b, sel=sel, step=st)
            blocks.append(blk)
            boxes_list.append(boxes)
            any_box = any_box or boxes is not None
        if not blocks:
            n = self.n_atoms if sel is None else len(sel)
            return np.empty((0, n, 3), np.float32), None
        out = np.concatenate(blocks)
        if not any_box:
            return out, None
        full = np.zeros((len(out), 6), dtype=np.float32)
        lo = 0
        for blk, boxes in zip(blocks, boxes_list):
            if boxes is not None:
                full[lo:lo + len(blk)] = boxes
            lo += len(blk)
        return out, full

    def stage_block(self, start: int, stop: int, sel=None,
                    quantize: bool = False, layout: str = "interleaved"):
        self._check_children(self._readers)
        if not 0 <= start <= stop <= self.n_frames:
            raise IndexError(
                f"block [{start},{stop}) out of range [0,{self.n_frames}]")
        if not self.transformations and start < stop:
            k0, a = self._locate(start)
            k1, _ = self._locate(stop - 1)
            if k0 == k1:
                # window inside one child: its fused decode(+quantize)
                # fast path applies unchanged
                return self._readers[k0].stage_block(
                    a, a + (stop - start), sel=sel, quantize=quantize,
                    layout=layout)
        return ReaderBase.stage_block(self, start, stop, sel=sel,
                                      quantize=quantize, layout=layout)

    def add_auxiliary(self, name, aux, cutoff=None):
        """Auxiliaries align by ``ts.time``, and a chain's child files
        commonly RESTART their embedded clocks — which would silently
        hand segment-2 frames the aux records of segment 1's times.
        Attach only when the chained time axis is globally
        non-decreasing; otherwise fail with the remedy."""
        t = self.frame_times(range(self.n_frames))
        if t is None or np.any(np.diff(t) < 0):
            raise ValueError(
                "chained trajectory times are not globally "
                "non-decreasing (segment clocks restart, or no time "
                "metadata); time-aligned auxiliaries would silently "
                "misalign — write the segment files with continuous "
                "times, or transfer_to_memory() with explicit times")
        super().add_auxiliary(name, aux, cutoff)

    def frame_times(self, frames):
        idx = np.asarray(list(frames), dtype=np.int64)
        times = np.empty(len(idx), dtype=np.float64)
        owners = np.searchsorted(self._starts, idx, side="right") - 1
        # one child call (one file open) per owning segment
        for k in np.unique(owners):
            where = owners == k
            t = self._readers[int(k)].frame_times(
                (idx[where] - int(self._starts[int(k)])).tolist())
            if t is None:
                return None
            times[where] = t
        return times

    def close(self):
        for r in self._readers:
            r.close()
