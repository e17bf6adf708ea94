"""Utilities: integrity (CRC framing, fingerprints, atomic writes,
typed corruption errors), structured logging, the phase timers, the
checkpoints of reduction analyses (``checkpoint``) and the registry of
prepared programs (``compile_cache``).

The JAX package's ``utils/config.py`` and its CLI come with the
analyses its table names (ROADMAP A8); its ``utils/platform.py`` (a
JAX platform workaround) has no counterpart here.
"""

from mdanalysis_mpi_tpu_torch.utils.log import get_logger, log_event

__all__ = ["get_logger", "log_event"]
