"""Every analysis reads one ``Universe`` over a ``MemoryReader`` of all
the frames, as the ``memory`` source does, and is handed one
``DeviceBlockCache`` of ``cache_bytes`` (the traffic's) through
``AlignedRMSF.run(block_cache=...)``: the staged blocks, and the CUDA
graphs captured over them, stay on the card from one analysis to the
next, as a ``Scheduler`` keeps a tenant's trajectory.  Set-up fills the
cache (:func:`portbench.harness.fill`); a window analysis that stages is
refused."""

from __future__ import annotations


class Source:
    resident = True

    def __init__(self, cfg, traffic, frames, topology, dimensions):
        from mdanalysis_mpi_tpu_torch import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
        from mdanalysis_mpi_tpu_torch.parallel.executors import (
            DeviceBlockCache)

        self._u = Universe(topology, MemoryReader(frames,
                                                  dimensions=dimensions))
        self._cache = DeviceBlockCache(int(traffic["cache_bytes"]))
        self.analysis_kwargs = {"block_cache": self._cache}

    def universe(self):
        return self._u

    def release(self, u):
        pass

    def close(self):
        self._cache.drop()
        self.analysis_kwargs = {}
        self._u = None
