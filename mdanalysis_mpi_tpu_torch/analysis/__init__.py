"""Analyses of the port: ``AverageStructure``, ``AlignTraj``,
``alignto``, ``rotation_matrix`` and ``sequence_alignment`` (align),
``RMSF``, ``RMSD``, ``rmsd`` and ``AlignedRMSF`` (rms), ``InterRDF``
and ``InterRDF_s`` (rdf), ``ContactMap`` and ``PairwiseDistances``
(distances), ``Contacts`` (contacts), ``NucPairDist`` and
``WatsonCrickDist`` (nucleicacids), ``AtomicDistances``
(atomicdistances), ``HydrogenBondAnalysis`` (hbonds), ``LeafletFinder``
and ``optimize_cutoff`` (leaflet), on the ``AnalysisBase`` template
(base)."""

from mdanalysis_mpi_tpu_torch.analysis.align import (AlignTraj,
                                                     AverageStructure,
                                                     alignto,
                                                     rotation_matrix,
                                                     sequence_alignment)
from mdanalysis_mpi_tpu_torch.analysis.atomicdistances import AtomicDistances
from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisBase, Results
from mdanalysis_mpi_tpu_torch.analysis.contacts import Contacts
from mdanalysis_mpi_tpu_torch.analysis.distances import (ContactMap,
                                                         PairwiseDistances)
from mdanalysis_mpi_tpu_torch.analysis.hbonds import HydrogenBondAnalysis
from mdanalysis_mpi_tpu_torch.analysis.leaflet import (LeafletFinder,
                                                       optimize_cutoff)
from mdanalysis_mpi_tpu_torch.analysis.nucleicacids import (NucPairDist,
                                                            WatsonCrickDist)
from mdanalysis_mpi_tpu_torch.analysis.rdf import InterRDF, InterRDF_s
from mdanalysis_mpi_tpu_torch.analysis.rms import RMSD, RMSF, AlignedRMSF, rmsd

__all__ = ["AnalysisBase", "Results", "AverageStructure", "AlignTraj",
           "alignto", "rotation_matrix", "sequence_alignment", "RMSF",
           "RMSD", "rmsd", "AlignedRMSF", "InterRDF", "InterRDF_s",
           "ContactMap", "PairwiseDistances", "Contacts", "NucPairDist",
           "WatsonCrickDist", "AtomicDistances", "HydrogenBondAnalysis",
           "LeafletFinder", "optimize_cutoff"]
