"""Trajectory and topology I/O of the port, with the JAX package's
format roster (each module self-registers with the topology_files /
trajectory_files registries):

- topology (+coordinates where the format carries them): GRO, PSF,
  PDB, PQR, MOL2, CRD, PDBQT, TXYZ/ARC, Desmond DMS, AMBER
  PRMTOP/parm7, GROMACS ITP/TOP (``.top`` sniffs AMBER vs GROMACS by
  content), DL_POLY CONFIG/REVCON (bare-filename dispatch); TPR is a
  documented conversion path.
- trajectories: XTC + DCD (the native C++ codec, built from this
  package's own ``native/trajio.cpp``), TRR, AMBER NetCDF (.nc/.ncdf,
  from-scratch NetCDF-3), AMBER ASCII mdcrd/crdbox/trj, AMBER
  INPCRD/restrt/rst7 restarts, XYZ, LAMMPS dump, Tinker ARC, DL_POLY
  HISTORY, in-memory arrays, ingested block stores (:mod:`.store`) and
  multi-file chains (:mod:`.chain`).  H5MD/GSD/TNG/TRZ are documented
  conversion paths (per-format guidance in trajectory_files.py).
- writing: the streaming :class:`~.writer.TrajectoryWriter` (XTC, TRR,
  DCD, NetCDF, XYZ) and each format module's one-shot writer.
"""

from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase
from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter, Writer

__all__ = ["MemoryReader", "ReaderBase", "TrajectoryWriter", "Writer"]
