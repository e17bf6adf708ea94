"""Chunk-level checkpoint/resume for reduction analyses (the JAX
package's ``utils/checkpoint.py``, ported: the partials are torch
tensors here).

The file layout is the JAX package's, leaf for leaf: ``frames_done``,
``fingerprint``, ``dropped`` and ``leaf_i`` for the partials' leaves in
depth-first order (a None is no leaf, as in a JAX pytree), stamped with
a content digest by :func:`~mdanalysis_mpi_tpu_torch.utils.integrity.
write_npz_atomic`, with the same spill twin and the same fingerprint
(class name, trajectory, frames, selection: no package name).  So a
checkpoint written by either package resumes in the other.

The reference has none (SURVEY.md §5.4): a crash at frame 9,999 of
10,000 loses everything, and any rank failure deadlocks the collectives
(RMSF.py:110,143).  The framework's partials make recovery nearly free:
every reduction analysis' per-chunk summary (e.g. the moment triple
``[T, mean, M2]``, RMSF.py:140) is mergeable and idempotent to
regenerate, so a checkpoint is just "frames processed so far + folded
partials", and resume is "fold saved partials with the rest".

Scope: batch backends (``torch``/``mesh``) and analyses with a
``_device_fold_fn`` (RMSF, AverageStructure, InterRDF, ContactMap — the
map-reduce family).  Serial streaming state lives inside the analysis
object and is not checkpointable from outside; time-series analyses
(RMSD) have order-dependent concatenation partials — both raise.

Cost note: each checkpoint copies the partials to the host, a wait on
the device between executor calls (never inside a scan group's graph),
so chunk size trades durability against throughput — the default chunk
is 4096 frames.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.parallel.executors import _tree_to, get_executor
from mdanalysis_mpi_tpu_torch.parallel.partition import iter_batches
from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity
from mdanalysis_mpi_tpu_torch.utils.integrity import (
    ArtifactWriteError, CheckpointCorruptError,
)


def _fingerprint(analysis, frames) -> str:
    """Stable identity of (analysis class, trajectory, frame window,
    selection): a checkpoint written for anything else must refuse to
    resume — same-shaped partials from a different run would merge
    silently into wrong results.  sha256, not hash(): Python's string
    hashing is salted per process and resume is by definition a new
    process."""
    reader = analysis._universe.trajectory
    path = getattr(reader, "_path", None)
    if path:
        traj = f"{path}:{os.path.getmtime(path)}"
    else:
        traj = f"mem:{reader.n_frames}x{reader.n_atoms}"
    h = hashlib.sha256()
    h.update(type(analysis).__name__.encode())
    h.update(traj.encode())
    h.update(np.asarray(list(frames), dtype=np.int64).tobytes())
    sel = analysis._batch_select()
    if sel is not None:
        h.update(np.ascontiguousarray(sel, dtype=np.int64).tobytes())
    return h.hexdigest()


def _spill_twin(path: str) -> str:
    """The spill-dir twin of checkpoint ``path``: basename prefixed
    with a digest of the PRIMARY path, so two runs whose checkpoints
    merely share a basename (`c.npz` in different dirs) can never
    collide in — or wrongly adopt from — the shared spill dir."""
    tag = hashlib.sha256(
        os.path.abspath(path).encode()).hexdigest()[:10]
    return os.path.join(_integrity.spill_dir(),
                        f"{tag}-{os.path.basename(path)}")


def _save(path: str, frames_done: int, partials, fingerprint: str,
          dropped=()) -> str:
    """Atomically persist one checkpoint (tmp → fsync → rename), with
    a content digest stamped in so :func:`_load` can refuse corrupt
    bytes instead of merging them into wrong numbers.

    Returns the path actually written: on an exhausted primary
    directory (ENOSPC/EIO-class :class:`ArtifactWriteError`) the write
    RETRIES in the spill dir (``MDTPU_SPILL_DIR``, else the system
    temp dir) — the degradation ladder of docs/RELIABILITY.md §5 —
    and only raises when the spill dir is exhausted too.
    """
    leaves = [_host_leaf(x) for x in _leaves(partials)]
    arrays = {"frames_done": np.int64(frames_done),
              "fingerprint": np.str_(fingerprint),
              # frames the resilient policy dropped from the durable
              # chunks: a resumed process never re-stages those chunks,
              # so its reliability report must inherit the record
              "dropped": np.asarray(sorted(dropped), dtype=np.int64),
              **{f"leaf_{i}": v for i, v in enumerate(leaves)}}
    try:
        _integrity.write_npz_atomic(path, arrays, artifact="checkpoint")
        return path
    except ArtifactWriteError:
        spill = _spill_twin(path)
        if os.path.abspath(spill) == os.path.abspath(path):
            raise              # no distinct spill target: nothing to try
        from mdanalysis_mpi_tpu_torch.utils.log import get_logger

        get_logger("mdtpu").warning(
            "checkpoint write to %s failed; retrying in spill dir %s",
            path, os.path.dirname(spill))
        _integrity.write_npz_atomic(spill, arrays, artifact="checkpoint")
        return spill


def _leaves(tree) -> list:
    """Depth-first leaves of a partials tree (tuples and lists nest; a
    None is no leaf) — ``jax.tree.leaves``' order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _unflatten(structure, leaves):
    """``leaves`` (depth-first) back into ``structure``'s shape."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(structure)


def _host_leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _load(path: str, structure, fingerprint: str):
    # typed integrity gate FIRST (docs/RELIABILITY.md §5): an
    # unreadable container, a missing digest stamp (legacy or
    # truncated file), or a content-digest mismatch raises
    # CheckpointCorruptError — resume-from-corrupt must refuse, never
    # fold flipped bits into the partials and report wrong numbers
    z = _integrity.verify_npz(path, artifact="checkpoint")
    saved_fp = str(z["fingerprint"]) if "fingerprint" in z else None
    if saved_fp != fingerprint:
        raise ValueError(
            f"checkpoint {path!r} was written for a different "
            "analysis/trajectory/frame window/selection — refusing "
            "to resume (delete it to start over)")
    frames_done = int(z["frames_done"])
    n_leaves = sum(1 for name in z if name.startswith("leaf_"))
    leaves = [z[f"leaf_{i}"] for i in range(n_leaves)]
    dropped = (z["dropped"] if "dropped" in z
               else np.empty(0, dtype=np.int64))
    n_struct = len(_leaves(structure))
    if n_struct != len(leaves):
        raise ValueError(
            f"checkpoint {path!r} has {len(leaves)} leaves but the "
            f"analysis' partials have {n_struct} — wrong "
            "checkpoint for this analysis/selection?")
    return frames_done, _unflatten(structure, leaves), dropped


def _executor_device(executor):
    """The device an executor (or the first member of a fallback
    chain) folds its partials on."""
    dev = getattr(executor, "device", None)
    if dev is None:
        chain = getattr(executor, "_chain", None) or [None]
        dev = getattr(chain[0], "device", None)
    return dev if dev is not None else torch.device("cpu")


def checkpoint_path(analysis, frames, checkpoint_dir: str | None = None
                    ) -> str:
    """The derived default checkpoint file for this exact run: stable
    across processes (sha256 fingerprint, not salted ``hash()``), so a
    resumed process lands on the same file without the caller threading
    a path through.  Directory: ``checkpoint_dir`` argument, else
    ``$MDTPU_CHECKPOINT_DIR``, else the system temp dir."""
    fp = _fingerprint(analysis, frames)
    d = (checkpoint_dir or os.environ.get("MDTPU_CHECKPOINT_DIR")
         or tempfile.gettempdir())
    return os.path.join(d, f"mdtpu-ckpt-{fp[:24]}.npz")


def run_checkpointed(analysis, path: str | None = None,
                     chunk_frames: int = 4096,
                     start=None, stop=None, step=None, frames=None,
                     backend: str = "torch", batch_size: int | None = None,
                     checkpoint_dir: str | None = None,
                     delete_on_success: bool = True,
                     **executor_kwargs):
    """``analysis.run(...)`` with durable progress in ``path``.

    Processes frames in ``chunk_frames`` chunks; after each, folds the
    chunk's partials into the running total and atomically rewrites the
    checkpoint.  If ``path`` exists, already-covered frames are skipped
    and the saved partials seed the total — re-running the same call
    after a crash (or a job scheduler killing the process) continues where
    it stopped.  ``path=None`` derives a stable per-run default (see
    :func:`checkpoint_path`) — what ``run(resilient=True)`` uses.
    Deletes the checkpoint on successful completion
    (``delete_on_success=False`` keeps it — what a multi-pass
    orchestrator needs so a crash in a LATER pass resumes an earlier
    pass from its completed summary instead of recomputing it) and
    returns the analysis (``.results`` populated as usual).

    Multi-pass analyses (the two-pass flagship ``AlignedRMSF``) declare
    ``_run_checkpointed_multipass`` and orchestrate their own per-pass
    checkpoints — each pass is a reduction with mergeable partials
    (pass-1 coordinate sums, pass-2 moment triples) and its own
    fingerprinted file, and chunk boundaries compose with scan-folded
    dispatch (a checkpoint lands between executor calls, never
    mid-scan).
    """
    multi = getattr(analysis, "_run_checkpointed_multipass", None)
    if multi is not None:
        return multi(path=path, chunk_frames=chunk_frames, start=start,
                     stop=stop, step=step, frames=frames,
                     backend=backend, batch_size=batch_size,
                     checkpoint_dir=checkpoint_dir,
                     delete_on_success=delete_on_success,
                     **executor_kwargs)
    fold = analysis._device_fold_fn
    if fold is None:
        raise ValueError(
            f"{type(analysis).__name__} has no mergeable partials "
            "(_device_fold_fn is None); checkpointing applies to "
            "reduction analyses only")
    executor = get_executor(backend, **executor_kwargs)
    if not getattr(executor, "per_call_partials", False):
        # whitelist, not blacklist: only the batch executors (and
        # batch-only fallback chains) declare per_call_partials.
        # Serial AND MPI executors accumulate inside the analysis
        # (each chunk's "partials" would contain all prior chunks,
        # double-counting on fold).
        raise ValueError(
            "checkpointing needs an executor whose execute() returns "
            "per-call partials — backend='torch' or 'mesh' (serial/mpi "
            "backends accumulate inside the analysis)")

    frames = list(analysis._frames(start, stop, step, frames))
    analysis.n_frames = len(frames)
    # same contract as AnalysisBase.run: the resolved frame list is
    # readable from _prepare/_conclude
    analysis._frame_indices = frames
    analysis._run_device = _executor_device(executor)
    analysis._prepare()
    fp = _fingerprint(analysis, frames)
    if path is None:
        path = checkpoint_path(analysis, frames,
                               checkpoint_dir=checkpoint_dir)

    # the resilient runtime (if any) behind this executor: its report
    # inherits dropped-frame records from resumed checkpoints and
    # contributes new ones to each saved chunk
    rt = (getattr(executor, "_runtime", None)
          or getattr(executor, "reliability", None))

    if not os.path.exists(path):
        # a previous attempt may have spilled when the primary dir was
        # exhausted (_save's degradation ladder): resume from the
        # path-namespaced spill twin rather than silently recomputing
        # from frame 0
        spill_twin = _spill_twin(path)
        if (os.path.abspath(spill_twin) != os.path.abspath(path)
                and os.path.exists(spill_twin)):
            path = spill_twin

    total = None
    done = 0
    if os.path.exists(path):
        done, total, prev_dropped = _load(
            path, analysis._identity_partials(), fp)
        # the saved partials seed the fold on the run's device
        total = _tree_to(total, _executor_device(executor))
        if done > len(frames):
            raise ValueError(
                f"checkpoint {path!r} covers {done} frames but this run "
                f"has {len(frames)} — frame window mismatch")
        if rt is not None:
            # inherit (dedup'd) — these frames were dropped by the
            # crashed process; this one never re-stages their chunks
            for f in prev_dropped.tolist():
                if int(f) not in rt.report.dropped_frames:
                    rt.report.dropped_frames.append(int(f))

    for a, b in iter_batches(done, len(frames), chunk_frames):
        partials = executor.execute(analysis, analysis._universe.trajectory,
                                    frames[a:b], batch_size=batch_size)
        total = partials if total is None else fold(total, partials)
        if rt is None:
            # 4-arg form kept for external wrappers around _save
            saved = _save(path, b, total, fp)
        else:
            saved = _save(path, b, total, fp, rt.report.dropped_frames)
        # _save returns the path actually written (the spill twin when
        # the primary dir was exhausted); wrappers that predate the
        # return value yield None — keep the primary path then
        path = saved or path

    if total is None:
        total = analysis._identity_partials()
    analysis._conclude(total)
    if delete_on_success and os.path.exists(path):
        os.remove(path)
    return analysis
