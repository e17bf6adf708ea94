"""Trajectory and topology I/O of the port: the in-memory reader, XTC
and DCD (with the native C++ codec, built from this package's own
``native/trajio.cpp``), multi-file chains (:mod:`.chain`), the
streaming writer (:mod:`.writer`), and GRO, PSF and PDB topologies.
The other formats of the JAX package are ported in later slices.
"""

from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase

__all__ = ["MemoryReader", "ReaderBase"]
