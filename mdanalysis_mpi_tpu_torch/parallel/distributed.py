"""Multi-process bring-up for the mesh executor.

The reference scales across nodes with ``mpirun`` + MPI collectives
(RMSF.py:59-61,110,143 — SURVEY.md §5.8).  The port's image is one
Python process per rank joined by ``torch.distributed``: NCCL between
CUDA devices, gloo between CPU processes (the tier-1 tests).

Division of labor (SURVEY.md §5.8 "host-side staging uses no
collectives"):

- every process calls :func:`initialize` once, before its first run;
- every process opens the SAME trajectory files (the reference's
  pattern: N ranks, N independent reader handles, RMSF.py:56);
- :func:`process_frame_shard` tells each process which contiguous frame
  block is its own;
- :class:`Collectives` carries the process group and the device its
  collectives move tensors on; the
  :class:`~mdanalysis_mpi_tpu_torch.parallel.executors.MeshExecutor`
  merges per-rank partials through it (``all_reduce`` of the moment
  sums, ``all_gather`` of time series, ring ``send``/``recv``).

The JAX package's ``global_from_local``, ``local_host_copy`` and
``global_batch_from_local`` assemble per-process blocks into one jax
global array and fetch a process's shard back.  Here each rank keeps
its own shard as ordinary tensors on its own devices and only partial
results cross processes, so those three have no torch counterpart.
"""

from __future__ import annotations

import datetime
import os

import torch

from mdanalysis_mpi_tpu_torch.parallel.partition import static_blocks


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device=None, backend: str | None = None,
               timeout_s: float = 300.0) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous
    (``tcp://``; nothing on a machine tells a program of its cluster, so
    the launcher passes it with ``num_processes`` and ``process_id``).
    With ``num_processes == 1``, or with no arguments and no
    ``WORLD_SIZE`` above 1 in the environment (a ``torchrun`` launch),
    this is a no-op.  ``device`` is this rank's device (default the
    port's default device, ``cuda``); a CUDA device with an index
    becomes the current one, so NCCL binds the rank to its card.  ``backend``: ``'nccl'`` for
    a CUDA device, else ``'gloo'``; pass it to choose, e.g. ``'gloo'``
    for two ranks that share one card (NCCL refuses two ranks on one
    GPU).
    """
    import torch.distributed as dist

    if num_processes is not None and num_processes == 1:
        return
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        init = {"init_method": "env://"}
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "pass coordinator_address, num_processes and process_id "
                "together")
        init = {"init_method": f"tcp://{coordinator_address}",
                "world_size": int(num_processes),
                "rank": int(process_id)}
    from mdanalysis_mpi_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend=backend, timeout=datetime.timedelta(seconds=timeout_s),
        **init)
    global _RANKS_ON_HOST
    _RANKS_ON_HOST = _count_ranks_on_host(coordinator_address,
                                          num_processes)


#: Ranks of the default process group on this process's host, counted
#: when ``initialize`` joins it (``ranks_on_host``).
_RANKS_ON_HOST = 1

_LOOPBACK = ("localhost", "127.", "::1", "[::1]")


def _count_ranks_on_host(coordinator_address: str | None,
                         num_processes: int | None) -> int:
    """Ranks of the just-joined group on this host: all
    ``num_processes``, when they meet at a loopback address (only
    processes of this host can reach it); else the ranks whose host
    name is this one's, gathered once over the group."""
    import socket

    import torch.distributed as dist

    if coordinator_address is not None:
        host = coordinator_address.rpartition(":")[0]
        if host.startswith(_LOOPBACK):
            return int(num_processes)
    names = [None] * dist.get_world_size()
    me = socket.gethostname()
    dist.all_gather_object(names, me)
    return names.count(me)


def ranks_on_host() -> int:
    """How many ranks of the default process group share this host (1
    when none is initialised): the staging passes divide the host's
    cores by it (``io.native.stage_threads``)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return _RANKS_ON_HOST


def world() -> tuple[int, int]:
    """``(rank, size)`` of the default process group; ``(0, 1)`` when
    none is initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def process_frame_shard(n_frames: int, process_id: int | None = None,
                        num_processes: int | None = None) -> range:
    """The contiguous frame block this process owns.

    Balanced static decomposition (the reference's RMSF.py:65-69 block
    partition, one level up: hosts instead of ranks).  Defaults to the
    live rank and world size of the default process group.
    """
    rank, size = world()
    pid = rank if process_id is None else process_id
    n = size if num_processes is None else num_processes
    return static_blocks(n_frames, n)[pid]


class Collectives:
    """The default process group and the device its collectives move
    tensors on.

    NCCL takes CUDA tensors.  Gloo takes CPU tensors for every
    collective the executor uses (``all_reduce``, ``all_gather``,
    ``send``/``recv``), but its TCP transport cannot send a CUDA
    tensor: a ``send`` of one aborts the process
    (``scripts/gloo_cuda_probe.py`` runs each case on a card).  So the
    transport is chosen explicitly, never by catching a failure:
    ``transport_device`` (default: ``'cpu'`` for a gloo group, the
    tensors' own device otherwise) is where a tensor goes for the
    collective; the result comes back to the tensor's device.
    """

    def __init__(self, transport_device=None):
        import torch.distributed as dist

        self.rank, self.size = world()
        self.backend = str(dist.get_backend())
        if transport_device is None and self.backend == "gloo":
            transport_device = "cpu"
        self.transport_device = (None if transport_device is None
                                 else torch.device(transport_device))

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of ``t`` on the transport device."""
        dev = self.transport_device or t.device
        return t.detach().to(dev, copy=True).contiguous()

    def all_reduce(self, t) -> torch.Tensor:
        """SUM of ``t`` over the group's ranks, on ``t``'s device."""
        import torch.distributed as dist

        t = torch.as_tensor(t)
        x = self._wire(t.reshape(-1))
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x.to(t.device).reshape(t.shape)

    def all_reduce_tree(self, tree):
        """:meth:`all_reduce` of every leaf of a tuple/list tree."""
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.all_reduce_tree(x) for x in tree)
        return self.all_reduce(tree)

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape on every rank) concatenated
        along axis 0 in rank order, on ``t``'s device."""
        import torch.distributed as dist

        x = self._wire(t)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x)
        return torch.cat(out, dim=0).to(t.device)

    def all_gather_tree(self, tree):
        """:meth:`all_gather_cat` of every leaf of a tuple/list tree."""
        if isinstance(tree, (tuple, list)):
            return type(tree)(self.all_gather_tree(x) for x in tree)
        return self.all_gather_cat(tree)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to rank ``rank + 1`` and receive rank ``rank − 1``'s
        (both modulo the size) in one ``batch_isend_irecv``; the
        received tensor lands on ``t``'s device."""
        import torch.distributed as dist

        if self.size == 1:
            return t
        x = self._wire(t)
        recv = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, (self.rank + 1) % self.size),
            dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.size)])
        for r in reqs:
            r.wait()
        return recv.to(t.device)
