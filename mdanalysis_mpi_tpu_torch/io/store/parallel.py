"""Parallel ensemble ingest: N trajectories → N member stores, one
content-addressed chunk pool (docs/ENSEMBLE.md "Ingest pre-stage").

The single-trajectory :func:`~mdanalysis_mpi_tpu_torch.io.store.ingest.
ingest` already dedups content-addressed chunks *within one backend*;
an ensemble needs the dedup to span MEMBERS — a replica/restart
ensemble re-ingesting the same coordinates N times must write the
chunk bytes once.  Two pieces:

- :class:`PooledCasBackend` — a :class:`~mdanalysis_mpi_tpu_torch.io.store.
  backend.LocalDirBackend` over one member's store directory whose
  ``cas-*`` objects are also HARDLINKED into a shared pool directory
  under the ensemble root.  ``exists`` consults the pool: a chunk any
  sibling already ingested links into this member for free (same
  inode, zero new bytes) and the ingester's dedup ledger counts it.
  Each member directory stays a complete, independently-readable
  store — ``StoreReader(member_dir)`` works with no knowledge of the
  pool — while identical chunk payloads occupy the disk once.
- :func:`ingest_many` — the fan-out entry point: N ingests on a thread
  pool (``--jobs``; ingest is I/O + XDR decode, it releases the GIL
  in numpy/zlib for useful overlap), per-member idempotence (an
  existing verified member store short-circuits, like the ``ingest``
  CLI), per-member summaries plus the aggregate cross-member
  ``dedup_ratio`` the ensemble bench leg discloses.

The fleet's ensemble pre-stage runs ONE member ingest per ingest
child (fanned across hosts); this module is the within-host fan-out
the ``mdtpu ingest --jobs N`` CLI and those children share.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

from mdanalysis_mpi_tpu_torch.io.store.backend import LocalDirBackend

#: Shared chunk-pool directory name under the ensemble ``out_root``.
POOL_DIR = "cas"


def member_dir(out_root: str, index: int) -> str:
    """Canonical per-member store directory under an ensemble root:
    deterministic across re-runs, so idempotence and placement both
    key off it."""
    return os.path.join(os.fspath(out_root), f"m{index:04d}")


class PooledCasBackend(LocalDirBackend):
    """Member-store backend whose content-addressed chunks ride a
    shared hardlink pool (see module docstring).  ``content_addressed``
    is True so :func:`~mdanalysis_mpi_tpu_torch.io.store.ingest.ingest`
    keys chunks by payload digest without being told to."""

    content_addressed = True

    def __init__(self, root: str, pool: str):
        super().__init__(root)
        self.pool = os.fspath(pool)

    def _link(self, src: str, dst: str) -> bool:
        """Hardlink ``src`` → ``dst``; False when the filesystem
        refuses links (cross-device, FAT, ...) — the caller falls back
        to plain bytes, trading the dedup for correctness.  A
        concurrent sibling winning the race (EEXIST) counts as
        success: the object is there."""
        try:
            os.link(src, dst)
            return True
        except FileExistsError:
            return True
        except OSError:
            return False

    def exists(self, name: str) -> bool:
        if super().exists(name):
            return True
        if not name.startswith("cas-"):
            return False
        pooled = os.path.join(self.pool, name)
        if not os.path.exists(pooled):
            return False
        # a sibling already ingested this payload: adopt it by link so
        # THIS member directory stays a complete store on its own —
        # the ingester sees "exists", skips the put, counts the dedup
        os.makedirs(self.root, exist_ok=True)
        if self._link(pooled, os.path.join(self.root, name)):
            return True
        # link refused (e.g. pool on another device): let the
        # ingester write real bytes instead of claiming a chunk this
        # member cannot serve
        return False

    def put_bytes(self, name: str, data: bytes) -> None:
        super().put_bytes(name, data)
        if name.startswith("cas-"):
            os.makedirs(self.pool, exist_ok=True)
            # publish into the pool for the NEXT member; losing the
            # race to a concurrent sibling is fine (same payload,
            # same digest)
            self._link(os.path.join(self.root, name),
                       os.path.join(self.pool, name))


def _count(metric: str, value: int = 1, **labels) -> None:
    from mdanalysis_mpi_tpu_torch.obs import METRICS

    METRICS.inc(metric, value, **labels)


def _ingest_member(index: int, trajectory, out_root: str,
                   chunk_frames, quant, stop, force: bool) -> dict:
    from mdanalysis_mpi_tpu_torch.io.store import store_meta
    from mdanalysis_mpi_tpu_torch.io.store.ingest import ingest

    dest = member_dir(out_root, index)
    summary: dict = {"member": index,
                     "trajectory": os.fspath(trajectory)
                     if not hasattr(trajectory, "read_block")
                     else getattr(trajectory, "filename", "<reader>"),
                     "store": dest}
    try:
        existing = None if force else store_meta(dest)
    except Exception:
        existing = None        # a torn half-store re-ingests cleanly
    if existing is not None:
        # idempotent per member, like the single-trajectory CLI: an
        # existing verified store IS the answer
        summary.update(already_ingested=True,
                       n_frames=existing["n_frames"],
                       n_chunks=len(existing["chunks"]),
                       quant=existing["quant"],
                       chunk_frames=existing["chunk_frames"])
        return summary
    backend = PooledCasBackend(dest,
                               os.path.join(os.fspath(out_root),
                                            POOL_DIR))
    summary.update(ingest(trajectory, backend=backend,
                          chunk_frames=chunk_frames, quant=quant,
                          stop=stop))
    summary["store"] = dest    # describe() returns the dir already,
    #                            but keep the key stable either way
    return summary


def ingest_many(trajectories, out_root: str, jobs: int | None = None,
                chunk_frames: int | None = None, quant="int16",
                stop: int | None = None, force: bool = False) -> dict:
    """Ingest N trajectories into member stores under ``out_root`` on
    a thread pool, content-addressed through the shared chunk pool.

    Returns the aggregate summary: ``members`` (per-trajectory
    summaries, member order), ``dedup_ratio`` — deduped bytes over
    total chunk bytes ACROSS members (a replica pair's second copy
    dedups to ~1.0 against the first), ``members_already`` (members
    short-circuited by idempotence — their bytes are unknown and
    excluded from the ratio, disclosed rather than guessed), and
    ``ok`` (False when any member failed; failures carry ``error`` in
    their member summary instead of killing the siblings).
    """
    trajectories = list(trajectories)
    if not trajectories:
        raise ValueError("ingest_many needs at least one trajectory")
    n_jobs = max(1, int(jobs) if jobs else
                 min(len(trajectories), os.cpu_count() or 4))
    t0 = time.perf_counter()
    members: list[dict] = [{} for _ in trajectories]

    def run(i: int) -> None:
        try:
            members[i] = _ingest_member(i, trajectories[i], out_root,
                                        chunk_frames, quant, stop,
                                        force)
            _count("mdtpu_ensemble_ingest_members_total")
        except Exception as exc:
            members[i] = {"member": i,
                          "trajectory": os.fspath(trajectories[i])
                          if not hasattr(trajectories[i], "read_block")
                          else "<reader>",
                          "error": f"{type(exc).__name__}: {exc}"}
            _count("mdtpu_ensemble_ingest_failures_total")

    with ThreadPoolExecutor(max_workers=n_jobs) as pool:
        list(pool.map(run, range(len(trajectories))))
    wall = time.perf_counter() - t0
    total_bytes = sum(m.get("bytes", 0) for m in members)
    dedup_bytes = sum(m.get("dedup_bytes", 0) for m in members)
    dedup_chunks = sum(m.get("dedup_chunks", 0) for m in members)
    already = sum(1 for m in members if m.get("already_ingested"))
    failed = [m for m in members if "error" in m]
    out = {
        "out_root": os.fspath(out_root), "jobs": n_jobs,
        "n_members": len(members), "members": members,
        "members_already": already, "members_failed": len(failed),
        "bytes": total_bytes, "dedup_chunks": dedup_chunks,
        "dedup_bytes": dedup_bytes,
        "dedup_ratio": (round(dedup_bytes / total_bytes, 4)
                        if total_bytes else 0.0),
        "wall_s": round(wall, 4),
        "ok": not failed,
    }
    from mdanalysis_mpi_tpu_torch.obs import METRICS

    METRICS.set_gauge("mdtpu_ensemble_dedup_ratio",
                      out["dedup_ratio"])
    return out
