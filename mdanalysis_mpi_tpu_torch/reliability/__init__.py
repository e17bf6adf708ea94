"""Fault injection, retry/deadline policy, and graceful degradation
(the JAX package's ``reliability`` package; the serving supervision
that consults the breakers lives in ``service/``).  Three cooperating
modules:

- :mod:`~mdanalysis_mpi_tpu_torch.reliability.faults` — deterministic fault
  injection at named sites (``read`` / ``stage`` / ``put`` /
  ``kernel`` / ``worker`` / ``probe``) so every recovery path is
  testable on CPU.
- :mod:`~mdanalysis_mpi_tpu_torch.reliability.policy` — retry with
  exponential backoff, soft per-op deadlines, corrupt-frame
  retry→skip→abort semantics, the Mesh→Torch→Serial
  :class:`~mdanalysis_mpi_tpu_torch.reliability.policy.FallbackChain`
  (Mesh→Torch on a CUDA device, which never leaves the kernels), and
  :func:`~mdanalysis_mpi_tpu_torch.reliability.policy.run_resilient` (the
  engine behind ``AnalysisBase.run(resilient=...)``).
- :mod:`~mdanalysis_mpi_tpu_torch.reliability.breaker` — per-(backend, mesh)
  circuit breakers: the cross-job memory of a failing backend that the
  serving scheduler consults before dispatching, so an outage is paid
  once instead of per job (closed → open after K consecutive faults →
  half-open probe → closed).

This ``__init__`` stays lazy for the policy layer: ``io.base`` and the
executors import :mod:`.faults` (dependency-free) from their module
scope, while :mod:`.policy` imports the executors — eager package
imports here would complete that cycle.
"""

from mdanalysis_mpi_tpu_torch.reliability import faults  # noqa: F401

_LAZY = ("ReliabilityPolicy", "ReliabilityReport", "ReliabilityRuntime",
         "FallbackChain", "run_resilient", "is_degradable",
         "degradation_chain",
         "merge_reliability_results", "DeadlineExceeded",
         "CorruptFrameError")

#: breaker.py is dependency-light (stdlib + obs) but kept lazy for
#: symmetry — nothing below the service layer needs it at import time.
_LAZY_BREAKER = ("CircuitBreaker", "BreakerBoard")


def __getattr__(name):
    import importlib

    if name in _LAZY or name == "policy":
        # import_module, NOT `from ... import policy`: the from-form
        # consults this package's attributes first, which re-enters
        # this __getattr__ and recurses forever
        policy = importlib.import_module(
            "mdanalysis_mpi_tpu_torch.reliability.policy")
        return policy if name == "policy" else getattr(policy, name)
    if name in _LAZY_BREAKER or name == "breaker":
        breaker = importlib.import_module(
            "mdanalysis_mpi_tpu_torch.reliability.breaker")
        return breaker if name == "breaker" else getattr(breaker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["faults", "policy", "breaker", *_LAZY, *_LAZY_BREAKER]
