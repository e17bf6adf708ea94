"""Analyses of the port: ``AverageStructure``, ``AlignTraj``,
``alignto``, ``rotation_matrix`` and ``sequence_alignment`` (align),
``RMSF``, ``RMSD``, ``rmsd`` and ``AlignedRMSF`` (rms), ``InterRDF``
and ``InterRDF_s`` (rdf), ``ContactMap`` and ``PairwiseDistances``
(distances), ``Contacts`` (contacts), ``NucPairDist`` and
``WatsonCrickDist`` (nucleicacids), ``AtomicDistances``
(atomicdistances), ``HydrogenBondAnalysis`` (hbonds), ``LeafletFinder``
and ``optimize_cutoff`` (leaflet), ``RadiusOfGyration`` (rgyr),
``PCA`` and ``cosine_content`` (pca), ``EinsteinMSD`` (msd),
``Dihedral``, ``Ramachandran`` and ``Janin`` (dihedrals), ``BAT``
(bat), ``GNMAnalysis`` (gnm), ``PersistenceLength`` (polymer),
``HELANAL`` and ``helix_analysis`` (helix), ``DSSP`` (dssp),
``Density`` and ``DensityAnalysis`` (density), ``LinearDensity``
(lineardensity), ``DistanceMatrix`` and ``DiffusionMap``
(diffusionmap), ``PSAnalysis``, ``hausdorff`` and ``discrete_frechet``
(psa), ``hes``, ``ces`` and ``dres`` (encore), ``SurvivalProbability``,
``WaterOrientationalRelaxation``, ``AngularDistribution`` and
``MeanSquareDisplacement`` (waterdynamics), ``DielectricConstant``
(dielectric), ``VelocityAutocorr`` (vacf), ``WaterBridgeAnalysis``
(waterbridge) and the ``nuclinfo`` functions, on the ``AnalysisBase``
template with the generic ``AnalysisFromFunction``, ``analysis_class``
and ``AnalysisCollection`` (N analyses over one staged trajectory pass)
(base): every analysis the JAX package exports."""

from mdanalysis_mpi_tpu_torch.analysis.align import (AlignTraj,
                                                     AverageStructure,
                                                     alignto,
                                                     rotation_matrix,
                                                     sequence_alignment)
from mdanalysis_mpi_tpu_torch.analysis.atomicdistances import AtomicDistances
from mdanalysis_mpi_tpu_torch.analysis.base import (
    AnalysisBase, AnalysisCollection, AnalysisFromFunction, Results,
    UncoalescableAnalysisError, analysis_class)
from mdanalysis_mpi_tpu_torch.analysis.bat import BAT
from mdanalysis_mpi_tpu_torch.analysis.contacts import Contacts
from mdanalysis_mpi_tpu_torch.analysis.density import Density, DensityAnalysis
from mdanalysis_mpi_tpu_torch.analysis.dielectric import DielectricConstant
from mdanalysis_mpi_tpu_torch.analysis.diffusionmap import (DiffusionMap,
                                                            DistanceMatrix)
from mdanalysis_mpi_tpu_torch.analysis.dihedrals import (Dihedral, Janin,
                                                         Ramachandran)
from mdanalysis_mpi_tpu_torch.analysis.distances import (ContactMap,
                                                         PairwiseDistances)
from mdanalysis_mpi_tpu_torch.analysis.dssp import DSSP
from mdanalysis_mpi_tpu_torch.analysis.encore import ces, dres, hes
from mdanalysis_mpi_tpu_torch.analysis.gnm import GNMAnalysis
from mdanalysis_mpi_tpu_torch.analysis.hbonds import HydrogenBondAnalysis
from mdanalysis_mpi_tpu_torch.analysis.helix import HELANAL, helix_analysis
from mdanalysis_mpi_tpu_torch.analysis.leaflet import (LeafletFinder,
                                                       optimize_cutoff)
from mdanalysis_mpi_tpu_torch.analysis.lineardensity import LinearDensity
from mdanalysis_mpi_tpu_torch.analysis.msd import EinsteinMSD
from mdanalysis_mpi_tpu_torch.analysis.nucleicacids import (NucPairDist,
                                                            WatsonCrickDist)
from mdanalysis_mpi_tpu_torch.analysis.pca import PCA, cosine_content
from mdanalysis_mpi_tpu_torch.analysis.polymer import PersistenceLength
from mdanalysis_mpi_tpu_torch.analysis.psa import (PSAnalysis,
                                                   discrete_frechet,
                                                   hausdorff)
from mdanalysis_mpi_tpu_torch.analysis.rdf import InterRDF, InterRDF_s
from mdanalysis_mpi_tpu_torch.analysis.rgyr import RadiusOfGyration
from mdanalysis_mpi_tpu_torch.analysis.rms import RMSD, RMSF, AlignedRMSF, rmsd
from mdanalysis_mpi_tpu_torch.analysis.vacf import VelocityAutocorr
from mdanalysis_mpi_tpu_torch.analysis.waterbridge import WaterBridgeAnalysis
from mdanalysis_mpi_tpu_torch.analysis.waterdynamics import (
    AngularDistribution, MeanSquareDisplacement, SurvivalProbability,
    WaterOrientationalRelaxation)

__all__ = ["AnalysisBase", "AnalysisCollection", "AnalysisFromFunction",
           "Results", "UncoalescableAnalysisError", "analysis_class",
           "AverageStructure", "AlignTraj", "alignto", "rotation_matrix",
           "sequence_alignment", "RMSF", "RMSD", "rmsd", "AlignedRMSF",
           "InterRDF", "InterRDF_s", "ContactMap", "PairwiseDistances",
           "Contacts", "NucPairDist", "WatsonCrickDist", "AtomicDistances",
           "HydrogenBondAnalysis", "LeafletFinder", "optimize_cutoff",
           "RadiusOfGyration", "PCA", "cosine_content", "EinsteinMSD",
           "Dihedral", "Ramachandran", "Janin", "BAT", "GNMAnalysis",
           "PersistenceLength", "HELANAL", "helix_analysis", "DSSP",
           "Density", "DensityAnalysis", "LinearDensity", "DistanceMatrix",
           "DiffusionMap", "PSAnalysis", "hausdorff", "discrete_frechet",
           "hes", "ces", "dres", "SurvivalProbability",
           "WaterOrientationalRelaxation", "AngularDistribution",
           "MeanSquareDisplacement", "DielectricConstant",
           "VelocityAutocorr", "WaterBridgeAnalysis"]
