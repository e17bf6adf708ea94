"""The port's counts of prepared programs (the JAX package's
``utils/compile_cache.py``).

Two kinds of program are prepared before they run, and this module
counts both:

- **kernel builds** — ``csrc/*.cu`` compiled by ``nvcc`` into one
  library and loaded (:func:`mdanalysis_mpi_tpu_torch._build.load`),
  once per process;
- **captured CUDA graphs** — a scan group's kernel sequence, captured
  at the group's second cache hit and replayed from then on
  (:mod:`mdanalysis_mpi_tpu_torch.parallel.executors`).  A graph is
  kept with the cache entry it was captured over, under a tag like the
  JAX package's ``_op_label`` (``_Setup.program_tag``: the batch
  function, its wrapper, the fold, the role, the shard and the params'
  signature, from :func:`signature`), and released with that entry.

Preparing a program is a miss, finding it prepared a hit; both land on
the ``COMPILE_METRICS`` counters of :mod:`mdanalysis_mpi_tpu_torch.obs.
metrics` (``mdtpu_compile_cache_misses_total`` and ``_hits_total``,
labelled ``kind="build"`` or ``kind="graph"``; ``mdtpu_compile_total``
and ``mdtpu_compile_seconds`` for the preparations;
``mdtpu_aot_compiled_total`` for programs a warmup ran;
``mdtpu_aot_dispatches_total`` for graph replays).

What a warmup prepares in the port is the kernel library (a process
that warmed up builds and loads nothing more: ``counters()
["build_misses"]`` does not move in its runs) and one eager run of each
dispatch shape.  It cannot prepare a graph: a graph holds the device
pointers of the one cache entry it was captured over, and warmup runs
on zero blocks of its own.

The JAX package's persistent tier (JAX's on-disk XLA compilation cache)
and its AOT tier (``jit(...).lower().compile()``, ``jax.export``) have
no counterpart here: PyTorch runs eagerly, a CUDA graph holds one
process's device pointers and cannot be written to disk, and the kernel
library is already the on-disk artifact (``build/``, keyed by a hash of
the sources).  This module persists nothing.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counts = {"build_hits": 0, "build_misses": 0, "graph_hits": 0,
           "graph_misses": 0, "replays": 0, "warmed": 0}


def signature(tree) -> tuple:
    """Shapes and dtypes of a staged tuple or params tree (tensors),
    values of its host scalars, structure kept."""
    if tree is None:
        return (None,)
    if isinstance(tree, (tuple, list)):
        return tuple(signature(x) for x in tree)
    shape = getattr(tree, "shape", None)
    if shape is not None and getattr(tree, "ndim", 0) > 0:
        return (tuple(shape), str(tree.dtype), str(getattr(tree, "device",
                                                           "host")))
    return ("scalar", float(tree))


def _inc(name: str, value: float = 1, **labels) -> None:
    from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS

    METRICS.inc(name, value, **labels)


def note_build(built: bool, seconds: float = 0.0) -> None:
    """One request for the kernel library: ``built`` when this process
    had to build or load it (a miss), else served (a hit)."""
    with _lock:
        _counts["build_misses" if built else "build_hits"] += 1
    if built:
        _inc("mdtpu_compile_cache_misses_total", kind="build")
        _inc("mdtpu_compile_total", kind="build")
        _inc("mdtpu_compile_seconds", seconds, kind="build")
    else:
        _inc("mdtpu_compile_cache_hits_total", kind="build")


def note_graph(captured: bool, seconds: float = 0.0) -> None:
    """One scan-group dispatch on the card: ``captured`` when its graph
    was captured now (a miss), else an existing graph (a hit); both
    replay."""
    with _lock:
        _counts["graph_misses" if captured else "graph_hits"] += 1
        _counts["replays"] += 1
    if captured:
        _inc("mdtpu_compile_cache_misses_total", kind="graph")
        _inc("mdtpu_compile_total", kind="graph")
        _inc("mdtpu_compile_seconds", seconds, kind="graph")
    else:
        _inc("mdtpu_compile_cache_hits_total", kind="graph")
    _inc("mdtpu_aot_dispatches_total")


def note_warmup() -> None:
    """A program a warmup ran once ahead of the run."""
    with _lock:
        _counts["warmed"] += 1
    _inc("mdtpu_aot_compiled_total")


def counters() -> dict:
    """This process's counts: builds, graphs (hits and misses), graph
    replays and programs warmed."""
    with _lock:
        return dict(_counts)
