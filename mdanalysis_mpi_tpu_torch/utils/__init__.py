"""Utilities: integrity (CRC framing, fingerprints, atomic writes,
typed corruption errors), structured logging, the phase timers, the
checkpoints of reduction analyses (``checkpoint``), the registry of
prepared programs (``compile_cache``) and the config dataclass behind
the command line, ``python -m mdanalysis_mpi_tpu_torch`` (``config``).

The JAX package's ``utils/platform.py`` (a JAX platform workaround) has
no counterpart here.
"""

from mdanalysis_mpi_tpu_torch.utils.config import (AnalysisConfig,
                                                   build_analysis,
                                                   run_config)
from mdanalysis_mpi_tpu_torch.utils.log import get_logger, log_event

__all__ = ["get_logger", "log_event", "AnalysisConfig", "build_analysis",
           "run_config"]
