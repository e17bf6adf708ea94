"""Analyses of the port: ``AverageStructure`` (align), ``RMSF`` and
``AlignedRMSF`` (rms), ``InterRDF`` and ``InterRDF_s`` (rdf),
``ContactMap`` and ``PairwiseDistances`` (distances), on the
``AnalysisBase`` template (base)."""

from mdanalysis_mpi_tpu_torch.analysis.align import AverageStructure
from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisBase, Results
from mdanalysis_mpi_tpu_torch.analysis.distances import (ContactMap,
                                                         PairwiseDistances)
from mdanalysis_mpi_tpu_torch.analysis.rdf import InterRDF, InterRDF_s
from mdanalysis_mpi_tpu_torch.analysis.rms import RMSF, AlignedRMSF

__all__ = ["AnalysisBase", "Results", "AverageStructure", "RMSF",
           "AlignedRMSF", "InterRDF", "InterRDF_s", "ContactMap",
           "PairwiseDistances"]
