"""Deterministic fault injection at named sites (``read`` / ``stage``
/ ...), which the readers consult, and the per-(backend, mesh) circuit
breakers the remote store consults (:mod:`.breaker`).  The retry and
degradation policy of the JAX package is ported in a later slice
(ROADMAP A9)."""

from mdanalysis_mpi_tpu_torch.reliability import faults  # noqa: F401

__all__ = ["faults"]
