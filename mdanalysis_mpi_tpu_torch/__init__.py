"""mdanalysis_mpi_tpu_torch — the PyTorch/CUDA port of
``mdanalysis_mpi_tpu``, the molecular-dynamics trajectory-analysis
framework.

The JAX package stays in the repository as the reference; this package
imports neither it nor JAX.  Layers, as in the JAX package:

- :mod:`.core` — topology, selections, ``Universe``/``AtomGroup``
  (host side, copied from the JAX package).
- :mod:`.io` — the JAX package's readers and writers: in-memory, XTC
  and DCD (the native C++ codec), TRR, AMBER NetCDF, XYZ, the AMBER
  ASCII and restart files, LAMMPS dumps and DL_POLY histories, block
  stores and multi-file chains; GRO, PSF, PDB, PRMTOP, ITP/TOP, PQR,
  MOL2, CRD, PDBQT, DMS, TXYZ and DL_POLY CONFIG topologies; the
  streaming trajectory writer (``Writer``: XTC, TRR, DCD, NetCDF, XYZ);
  and the staging primitives that cut frame blocks into
  int16/int8/delta wire formats (:mod:`.staging`).
- :mod:`.ops` — superposition, RMSD and streaming-moment ops as
  PyTorch code, the serial float64 NumPy oracle (:mod:`.ops.host`), and the
  fused aligned-moments path whose hand-written CUDA kernel lives in
  ``csrc/fused_rmsf.cu`` (:mod:`.ops.fused_planar`).
- :mod:`.parallel` — the serial oracle executor, the single-device
  torch executor with its device block cache, the multi-device
  ``MeshExecutor`` (lists of devices and ``torch.distributed`` ranks)
  and the mpi4py ``MPIExecutor``.
- :mod:`.analysis` — ``AverageStructure``, ``AlignTraj``, ``RMSF``,
  ``RMSD``, ``AlignedRMSF``, the RDF and distance analyses,
  ``Contacts``, ``NucPairDist``/``WatsonCrickDist``,
  ``AtomicDistances``, ``HydrogenBondAnalysis`` and ``LeafletFinder``.
- :mod:`.lib` — distances and the capped-distance engines (the torch
  cell list in :mod:`.ops.neighbors`), neighbour search, correlations;
  :mod:`.transformations` — on-the-fly trajectory transformations.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:mod:`.device`).
"""

from mdanalysis_mpi_tpu_torch.core.universe import Merge, Universe
from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup, UpdatingAtomGroup
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch import units

__version__ = "0.1.0"

__all__ = ["Universe", "Merge", "AtomGroup", "UpdatingAtomGroup",
           "Topology", "units", "__version__"]


def __getattr__(name):
    if name == "Writer":
        # upstream `mda.Writer(filename, n_atoms)` factory, loaded lazily
        from mdanalysis_mpi_tpu_torch.io.writer import Writer

        return Writer
    raise AttributeError(
        f"module 'mdanalysis_mpi_tpu_torch' has no attribute {name!r}")
