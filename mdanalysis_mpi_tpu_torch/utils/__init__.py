"""Utilities: integrity (CRC framing, fingerprints, atomic writes,
typed corruption errors), structured logging and the phase timers.

The configuration and the checkpoint and compile caches of the JAX
package's ``utils`` come with ROADMAP A4 and A9.
"""

from mdanalysis_mpi_tpu_torch.utils.log import get_logger, log_event

__all__ = ["get_logger", "log_event"]
