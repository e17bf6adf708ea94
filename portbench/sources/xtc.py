"""The frames written at set-up as one XTC under ``TMPDIR``
(``io.xtc.write_xtc`` at the configuration's ``xtc_precision``); every
analysis opens ``Universe(topology, path)`` afresh, as each run of
RMSF.py opens ``mda.Universe(GRO, XTC)``, so no reader-level state
carries between analyses.  The frame-offset index is cached beside the
file at the first open, as upstream caches it, and the OS page cache
holds the file.  The directory is removed at :meth:`close`."""

from __future__ import annotations

import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: frames a part of the file is written in (see :func:`write`)
PART_FRAMES = 256


def write(path, frames, dimensions, precision) -> None:
    """``frames`` as one XTC at ``path``, byte for byte what one
    ``write_xtc`` call writes (steps and times the frame indices): parts
    of :data:`PART_FRAMES` frames are written at once on the host's
    cores, since the native writer releases the interpreter lock and
    XTC frames stand alone, then joined in order."""
    from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc

    n = len(frames)
    if dimensions is not None:
        dimensions = np.broadcast_to(np.asarray(dimensions), (n, 6))
    starts = range(0, n, PART_FRAMES)

    def part(lo):
        hi = min(lo + PART_FRAMES, n)
        idx = np.arange(lo, hi)
        write_xtc(f"{path}.{lo}", frames[lo:hi],
                  dimensions=None if dimensions is None
                  else dimensions[lo:hi],
                  times=idx.astype(np.float32),
                  steps=idx.astype(np.int32), precision=precision)

    threads = max(1, min(len(os.sched_getaffinity(0)), len(starts)))
    with ThreadPoolExecutor(threads) as pool:
        for _ in pool.map(part, starts):
            pass
    with open(path, "wb") as out:
        for lo in starts:
            with open(f"{path}.{lo}", "rb") as f:
                shutil.copyfileobj(f, out, 1 << 24)
            os.remove(f"{path}.{lo}")


class Source:
    def __init__(self, cfg, traffic, frames, topology, dimensions):
        self._top = topology
        self._dir = tempfile.mkdtemp(prefix="portbench_xtc_")
        self.path = os.path.join(self._dir, "traj.xtc")
        try:
            write(self.path, frames, dimensions, cfg["xtc_precision"])
        except BaseException:
            self.close()
            raise

    def universe(self):
        from mdanalysis_mpi_tpu_torch import Universe

        return Universe(self._top, self.path)

    def release(self, u):
        u.trajectory.close()

    def close(self):
        shutil.rmtree(self._dir, ignore_errors=True)
