"""Frame partitioning (:mod:`.partition`) and the execution backends:
:mod:`.executors` (the serial float64 oracle, the single-device torch
executor and the multi-device ``MeshExecutor``), :mod:`.mpi` (the
reference's mpi4py ranks), :mod:`.distributed` (``torch.distributed``
bring-up and collectives) and :mod:`.dryrun` (one data-parallel
AlignedRMSF step checked against the oracle)."""

from mdanalysis_mpi_tpu_torch.parallel.mpi import MPIExecutor, ThreadComm
from mdanalysis_mpi_tpu_torch.parallel.partition import (iter_batches,
                                                         static_blocks)

__all__ = [
    "static_blocks", "iter_batches",
    "SerialExecutor", "TorchExecutor", "MeshExecutor", "MPIExecutor",
    "ThreadComm", "get_executor",
]

_EXECUTORS = ("SerialExecutor", "TorchExecutor", "MeshExecutor",
              "get_executor")


def __getattr__(name):
    # the executors import torch; load them on first use so that the
    # partitioner and the MPI executor stay importable without it
    if name in _EXECUTORS:
        from mdanalysis_mpi_tpu_torch.parallel import executors

        return getattr(executors, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
