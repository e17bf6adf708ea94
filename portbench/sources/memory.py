"""Every analysis reads one ``Universe`` over a ``MemoryReader`` of all
the frames, as MDAnalysis's ``in_memory=True`` holds them."""

from __future__ import annotations


class Source:
    def __init__(self, cfg, traffic, frames, topology, dimensions):
        from mdanalysis_mpi_tpu_torch import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        self._u = Universe(topology, MemoryReader(frames,
                                                  dimensions=dimensions))

    def universe(self):
        return self._u

    def release(self, u):
        pass

    def close(self):
        self._u = None
