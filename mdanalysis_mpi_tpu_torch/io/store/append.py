"""Append-able store ingest: the live tier (docs/STREAMING.md).

:func:`~mdanalysis_mpi_tpu_torch.io.store.ingest.ingest` closes over a
finished trajectory; this module ingests one that is STILL BEING
WRITTEN.  :class:`LiveIngest` accepts frames as they arrive — pushed
by the producer (over any :class:`~mdanalysis_mpi_tpu_torch.io.store.
backend.StoreBackend`, the remote chunk service included, which is
the remote push path) or pulled by :func:`follow` tailing a growing
source file — seals a chunk the moment it fills, and rewrites a
CRC-sealed *tail manifest* (``manifest.tail.json``) beside the sealed
chunks after every seal.

Crash contract: the tail manifest only ever references fully-written
chunks and is replaced atomically, so killing the writer at ANY point
— mid-chunk, mid-manifest — leaves a valid shorter store described by
the last tail epoch, never a corrupt one.  :meth:`LiveIngest.seal`
flushes the final partial chunk, writes the closed ``manifest.json``
(promoting the store to a normal ingested one), then deletes the
tail; a reader racing the promotion sees the closed manifest first
(:func:`~mdanalysis_mpi_tpu_torch.io.store.manifest.load_any_manifest`).
"""

from __future__ import annotations

import os
import time

import numpy as np

from mdanalysis_mpi_tpu_torch.io.store import ingest as _ingest_mod
from mdanalysis_mpi_tpu_torch.io.store.backend import LocalDirBackend
from mdanalysis_mpi_tpu_torch.io.store.ingest import (
    DEFAULT_CHUNK_FRAMES, norm_store_quant,
)
from mdanalysis_mpi_tpu_torch.io.store.manifest import (
    MANIFEST_NAME, TAIL_MANIFEST_NAME, dump_manifest,
)


def _count(metric: str, value: int = 1, **labels) -> None:
    from mdanalysis_mpi_tpu_torch.obs import METRICS

    METRICS.inc(metric, value, **labels)


class LiveIngest:
    """Append frames into a growing store, chunk seal by chunk seal.

    ``append()`` buffers pushed frames and seals every full chunk
    immediately (chunk put first, then the tail manifest — epoch
    ``N+1`` — atomically replaced); ``seal()`` flushes the remainder
    and promotes the tail to the closed manifest.  Works over any
    store backend: a local directory for the tailing case, the
    remote :class:`~mdanalysis_mpi_tpu_torch.io.store.remote.
    HttpStoreBackend` when frames are pushed over the chunk-service
    protocol.  NOT thread-safe — one producer owns a live ingest."""

    def __init__(self, out: str | None = None, n_atoms: int | None = None,
                 chunk_frames: int | None = None, quant="int16",
                 backend=None, content_addressed: bool | None = None,
                 source: str | None = None):
        if backend is None:
            if out is None:
                raise ValueError(
                    "LiveIngest needs an output path or a backend")
            backend = LocalDirBackend(out)
        if content_addressed is None:
            content_addressed = bool(
                getattr(backend, "content_addressed", False))
        self._backend = backend
        self._cas = content_addressed
        self._qmode = norm_store_quant(quant)
        self._cf = int(chunk_frames or DEFAULT_CHUNK_FRAMES)
        if self._cf < 1:
            raise ValueError(
                f"chunk_frames must be >= 1, got {self._cf}")
        self._na = None if n_atoms is None else int(n_atoms)
        self._source = source
        self._scale = None
        self._entries: list = []
        self._overflow = 0
        self._dedup_chunks = 0
        self._dedup_bytes = 0
        self._total_bytes = 0
        self._epoch = 0
        self._sealed = False
        self._t0 = time.perf_counter()
        self._buf: list = []          # (coords, boxes, times) blocks
        self._buffered = 0
        # live-ingest over a prior store: kill the old manifests FIRST
        # (the re-ingest invariant) — a crash mid-append must degrade
        # to "this tail's frames", never to a stale full manifest
        # whose fingerprints reject every replaced chunk
        backend.delete_bytes(MANIFEST_NAME)
        backend.delete_bytes(TAIL_MANIFEST_NAME)
        # epoch 1, zero chunks: publish the empty tail immediately so
        # a follow reader can open the store before the first chunk
        # seals (it simply serves n_frames == 0 until then)
        self._write_tail()

    # ---- state ----

    @property
    def epoch(self) -> int:
        """Tail-manifest epoch: bumps once per sealed chunk."""
        return self._epoch

    @property
    def frames_sealed(self) -> int:
        """Frames durably visible to followers (buffered frames of a
        not-yet-full chunk are NOT — they are the crash-loss window)."""
        return self._entries[-1]["stop"] if self._entries else 0

    @property
    def sealed(self) -> bool:
        return self._sealed

    # ---- appending ----

    def append(self, coords, boxes=None, times=None) -> int:
        """Append a block of frames (``(n, atoms, 3)``; a single
        ``(atoms, 3)`` frame is accepted too).  Seals every chunk the
        block completes; returns the number of chunks sealed (0 when
        everything is still buffered)."""
        if self._sealed:
            raise RuntimeError("LiveIngest is sealed; no more appends")
        coords = np.asarray(coords, dtype=np.float32)
        if coords.ndim == 2:
            coords = coords[None]
            boxes = None if boxes is None else np.asarray(boxes)[None]
            times = None if times is None else np.atleast_1d(times)
        if coords.ndim != 3 or coords.shape[-1] != 3:
            raise ValueError(
                f"append wants (n, atoms, 3) coords, got {coords.shape}")
        if self._na is None:
            self._na = int(coords.shape[1])
        elif coords.shape[1] != self._na:
            raise ValueError(
                f"append got {coords.shape[1]} atoms, store has "
                f"{self._na}")
        n = len(coords)
        self._buf.append((
            coords,
            None if boxes is None
            else np.asarray(boxes, dtype=np.float32).reshape(n, -1),
            None if times is None
            else np.asarray(times, dtype=np.float64).reshape(n)))
        self._buffered += n
        sealed = 0
        while self._buffered >= self._cf:
            self._seal_next_chunk(self._cf)
            sealed += 1
        return sealed

    def _take(self, n: int):
        """Pop exactly ``n`` buffered frames → (coords, boxes, times).
        boxes/times are carried only when EVERY contributing block has
        them (mixed producers degrade to none, matching the manifest's
        all-or-nothing has_boxes/has_times flags per chunk)."""
        got = 0
        parts = []
        while got < n:
            c, b, t = self._buf[0]
            take = min(n - got, len(c))
            parts.append((c[:take], None if b is None else b[:take],
                          None if t is None else t[:take]))
            if take == len(c):
                self._buf.pop(0)
            else:
                self._buf[0] = (
                    c[take:], None if b is None else b[take:],
                    None if t is None else t[take:])
            got += take
        self._buffered -= n
        coords = (parts[0][0] if len(parts) == 1
                  else np.concatenate([p[0] for p in parts]))
        boxes = (None if any(p[1] is None for p in parts)
                 else parts[0][1] if len(parts) == 1
                 else np.concatenate([p[1] for p in parts]))
        times = (None if any(p[2] is None for p in parts)
                 else parts[0][2] if len(parts) == 1
                 else np.concatenate([p[2] for p in parts]))
        return coords, boxes, times

    def _seal_next_chunk(self, n: int) -> None:
        coords, boxes, times = self._take(n)
        ci = len(self._entries)
        lo = self.frames_sealed
        entry, self._scale, overflow, dedup = _ingest_mod._seal_chunk(
            self._backend, ci, lo, coords, boxes, times, self._qmode,
            self._scale, self._cas)
        if overflow:
            self._overflow += 1
        if dedup:
            self._dedup_chunks += 1
            self._dedup_bytes += dedup
        self._entries.append(entry)
        self._total_bytes += entry["nbytes"]
        # chunk durably down → publish it: the tail manifest is the
        # ONLY thing a follower trusts, so the epoch bump happens
        # strictly after the chunk bytes it references
        self._write_tail()
        _count("mdtpu_stream_chunks_sealed_total")

    def _manifest(self) -> dict:
        return _ingest_mod.build_manifest(
            {"n_atoms": int(self._na or 0), "chunk_frames": self._cf,
             "quant": self._qmode, "source": self._source},
            self._entries, self._overflow)

    def _write_tail(self) -> None:
        self._epoch += 1
        man = self._manifest()
        man["epoch"] = self._epoch
        self._backend.put_bytes(TAIL_MANIFEST_NAME, dump_manifest(man))

    # ---- sealing ----

    def seal(self) -> dict:
        """Flush the final partial chunk, promote tail → closed
        manifest, delete the tail.  Returns an ingest-style summary
        dict (idempotent: a second seal returns the same summary)."""
        if self._sealed:
            return self._summary
        if self._buffered:
            self._seal_next_chunk(self._buffered)
        man = self._manifest()
        self._backend.put_bytes(MANIFEST_NAME, dump_manifest(man))
        self._backend.delete_bytes(TAIL_MANIFEST_NAME)
        self._sealed = True
        wall = time.perf_counter() - self._t0
        n_frames = man["n_frames"]
        summary = {
            "store": self._backend.describe(), "quant": self._qmode,
            "n_frames": n_frames, "n_chunks": len(self._entries),
            "chunk_frames": self._cf, "bytes": self._total_bytes,
            "scale_overflow_chunks": self._overflow,
            "epochs": self._epoch, "live": True,
            "wall_s": round(wall, 4),
            "store_ingest_fps": (round(n_frames / wall, 2)
                                 if wall > 0 else None),
        }
        if self._cas:
            summary["content_addressed"] = True
            summary["dedup_chunks"] = self._dedup_chunks
            summary["dedup_bytes"] = self._dedup_bytes
            summary["dedup_ratio"] = (
                round(self._dedup_bytes / self._total_bytes, 4)
                if self._total_bytes else 0.0)
        self._summary = summary
        return summary

    # context-manager sugar: ``with LiveIngest(out) as live: ...``
    # seals on clean exit; an exception propagates WITHOUT sealing —
    # the crash contract (valid shorter store) is the whole point
    def __enter__(self) -> "LiveIngest":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.seal()


def follow(trajectory, out: str | None = None,
           chunk_frames: int | None = None, quant="int16",
           backend=None, content_addressed: bool | None = None,
           poll_interval_s: float = 0.05, idle_timeout_s: float = 5.0,
           expect_frames: int | None = None, clock=time.monotonic,
           sleep=time.sleep) -> dict:
    """Tail a growing source trajectory into a live store.

    Polls the source for new frames (reopening the reader to refresh
    its frame count — file readers cache it at open), appends them
    through :class:`LiveIngest`, and seals when ``expect_frames`` is
    reached or the source stops growing for ``idle_timeout_s``.
    Returns the seal summary.  ``clock``/``sleep`` are injectable for
    deterministic tests."""
    from mdanalysis_mpi_tpu_torch.io import trajectory_files

    reader = trajectory_files.open(os.fspath(trajectory))
    try:
        live = LiveIngest(out=out, n_atoms=reader.n_atoms,
                          chunk_frames=chunk_frames, quant=quant,
                          backend=backend,
                          content_addressed=content_addressed,
                          source=os.fspath(trajectory))
        done = 0
        last_growth = clock()
        while True:
            nf = reader.n_frames
            if expect_frames is not None:
                nf = min(nf, int(expect_frames))
            if nf > done:
                block, boxes = reader.read_block(done, nf)
                times = reader.frame_times(range(done, nf))
                live.append(block, boxes, times)
                done = nf
                last_growth = clock()
            if expect_frames is not None and done >= expect_frames:
                break
            if clock() - last_growth >= idle_timeout_s:
                break
            sleep(poll_interval_s)
            fresh = reader.reopen()
            if fresh is not reader:
                reader.close()
                reader = fresh
        return live.seal()
    finally:
        reader.close()
