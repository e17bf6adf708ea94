"""MPI host executor: the reference's SPMD pattern behind AnalysisBase
(the port's copy of the JAX package's ``parallel/mpi.py``; its two
pytree maps are the small tuple-tree helpers below).

BASELINE.json's north_star keeps "the existing mpi4py+NumPy path" as one
executor next to the JAX/TPU ones.  This module is that path, rebuilt on
the framework's dispatch boundary: each rank runs the serial per-frame
loop over its static frame block (the reference's per-rank body,
RMSF.py:91-103/123-138), and per-rank partials merge through the
communicator — the image of the reference's two collectives:

- additive partials (``tree_add`` folds, e.g. AverageStructure sums)
  correspond to ``comm.Allreduce(MPI.SUM)`` (RMSF.py:109-110);
- algebraic merges (the Chan moment merge, RMSF.py:36-41) correspond to
  ``comm.reduce(S, op=second_order_moments)`` (RMSF.py:143) — here an
  ``allreduce`` with the analysis' fold function so every rank finishes
  with the full result (the reference leaves ranks != 0 with garbage
  and a dead ``MPI.Op`` handle, quirk Q1; we use the fold directly).

Failure semantics (SURVEY.md §5.3): like the reference, a rank that
dies before its collective leaves the others blocked in
``allreduce``/``allgather`` — MPI offers no cheap liveness detection,
so this path fails fast only on *raising* ranks (the exception
propagates before the collective).  Crash-durable long runs need the
checkpointed single-controller runs, which the port does not have yet
(ROADMAP A4).

mpi4py is an *optional* dependency: :class:`MPIExecutor` accepts any
object with the tiny communicator surface it uses (``Get_rank``,
``Get_size``, ``allreduce(obj, op)``, ``allgather(obj)``), so tests
drive it with an in-process communicator and no MPI runtime; under
``mpirun`` it defaults to ``mpi4py.MPI.COMM_WORLD``.

Why object-path collectives only: per-rank partials are small (a moment
summary is ``(1 + 2·S·3)`` doubles), so the pickle path costs nothing
next to the per-frame compute — the reference's zero-copy buffer
``Allreduce`` mattered only because it reduced 3·n_atoms doubles every
run (RMSF.py:110); our wide-average path ships the same bytes once.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.parallel.partition import static_blocks


def _world_comm():
    try:
        from mpi4py import MPI
    except ImportError:
        raise RuntimeError(
            "MPIExecutor needs mpi4py (not installed) unless an explicit "
            "communicator object is passed; run under mpirun with mpi4py "
            "available, or pass comm=<object with Get_rank/Get_size/"
            "allreduce/allgather>") from None
    return MPI.COMM_WORLD


class MPIExecutor:
    """Frame-parallel host execution over an MPI-style communicator.

    ``MPIExecutor()`` under ``mpirun -np N`` reproduces the reference
    program's topology: N single-threaded NumPy ranks, static block
    decomposition (balanced variant of RMSF.py:65-69 — block sizes
    differ by at most 1 instead of rank N-1 absorbing the whole
    remainder), collective merge, every rank left holding the final
    partials.  Empty blocks (size > n_frames, quirk Q2) contribute the
    analysis' identity partials instead of crashing.
    """

    name = "mpi"

    def __init__(self, comm=None):
        self.comm = comm if comm is not None else _world_comm()

    def execute(self, analysis, reader, frames, batch_size=None):
        del batch_size  # host path is per-frame, like the reference
        comm = self.comm
        rank, size = comm.Get_rank(), comm.Get_size()
        frames = list(frames)
        block = static_blocks(len(frames), size)[rank]
        for i in block:
            analysis._single_frame(reader[frames[i]])
        partial = (analysis._serial_summary() if len(block)
                   else analysis._identity_partials())
        fold = analysis._device_fold_fn
        if fold is not None:
            # allreduce with the analysis' merge (host-safe on NumPy:
            # merge_moments / tree_add dispatch on array type) — the
            # RMSF.py:143 reduction without the discarded-Op quirk
            return comm.allreduce(partial, op=fold)
        # time-series analyses: concatenate per-rank partials in rank
        # (= frame) order
        parts = [p for p in comm.allgather(partial) if _n_rows(p)]
        if not parts:
            return analysis._identity_partials()
        if len(parts) == 1:
            return parts[0]
        return _tree_concat(parts)


def _tree_concat(parts):
    """Concatenate matching tuple/list trees of arrays leaf by leaf
    along axis 0 (the JAX package maps ``np.concatenate`` over the
    leaves with ``jax.tree.map``)."""
    first = parts[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_concat([p[i] for p in parts])
                           for i in range(len(first)))
    return np.concatenate([np.asarray(x) for x in parts], axis=0)


def _tree_leaves(tree):
    """The leaves of a tuple/list tree in order (``jax.tree.leaves``)."""
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _tree_leaves(x)]
    return [tree]


def _n_rows(partial):
    leaves = _tree_leaves(partial)
    return np.shape(leaves[0])[0] if leaves else 0


class ThreadComm:
    """In-process communicator: N threads, barrier-synchronized
    collectives over shared memory.

    The subset MPIExecutor needs (``Get_rank``/``Get_size``/
    ``allreduce``/``allgather``), implemented with a
    ``threading.Barrier`` double-handshake.  Exists so the MPI code
    path is exercised (tests, single-host smoke runs) without an MPI
    runtime — build one per rank via :meth:`make`.
    """

    def __init__(self, rank: int, size: int, shared: dict):
        self._rank = rank
        self._size = size
        self._shared = shared

    @classmethod
    def make(cls, size: int):
        """Return ``size`` communicators sharing one collective state."""
        import threading

        shared = {"slots": [None] * size,
                  "barrier": threading.Barrier(size)}
        return [cls(r, size, shared) for r in range(size)]

    def Get_rank(self) -> int:
        return self._rank

    def Get_size(self) -> int:
        return self._size

    def allgather(self, obj):
        slots, barrier = self._shared["slots"], self._shared["barrier"]
        slots[self._rank] = obj
        barrier.wait()          # all contributions visible
        out = list(slots)
        barrier.wait()          # all reads done before slots are reused
        return out

    def allreduce(self, obj, op):
        parts = self.allgather(obj)
        acc = parts[0]
        for p in parts[1:]:
            acc = op(acc, p)    # every rank folds identically, in order
        return acc
