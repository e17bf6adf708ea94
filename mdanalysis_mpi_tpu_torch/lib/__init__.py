"""Library helpers mirroring the upstream ``MDAnalysis.lib`` surface:
``lib.distances`` (the capped-distance engines, among them the torch
cell list), ``lib.nsgrid``, ``lib.neighborsearch``,
``lib.correlations``, ``lib.transformations`` and ``lib.mdamath``."""

from mdanalysis_mpi_tpu_torch.lib import (correlations, distances, mdamath,
                                          neighborsearch, transformations)
from mdanalysis_mpi_tpu_torch.lib.neighborsearch import AtomNeighborSearch

__all__ = ["correlations", "distances", "mdamath", "neighborsearch",
           "transformations", "AtomNeighborSearch"]
