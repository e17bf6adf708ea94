"""The frames ingested at set-up into a block store under ``TMPDIR``
(``io.store.ingest``: ``chunk_frames`` a chunk, ``quant`` on disk);
every analysis opens ``Universe(topology, store_dir)`` afresh, so no
reader-level cache carries between analyses (the OS page cache does).
The store is removed at :meth:`close`."""

from __future__ import annotations

import os
import shutil
import tempfile


class Source:
    def __init__(self, cfg, traffic, frames, topology, dimensions):
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
        from mdanalysis_mpi_tpu_torch.io.store import ingest

        self._top = topology
        self._dir = tempfile.mkdtemp(prefix="portbench_store_")
        self.path = os.path.join(self._dir, "store")
        try:
            self.summary = ingest(
                MemoryReader(frames, dimensions=dimensions), self.path,
                chunk_frames=traffic["chunk_frames"],
                quant=traffic["quant"])
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
