"""Ingest-once: re-chunk a trajectory into the block store.

One sequential decode pass — the LAST one the trajectory ever needs.
Frames are read through the source reader's bulk ``read_block`` (the
fused native decode when the format has one), re-chunked to the
staging geometry (``chunk_frames`` = the frame block ``_run_batches``
stages; default 512, the flagship batch), quantized once with the
executors' wire policy, framed with per-array fingerprints
(``codec.encode_chunk``), and written through the backend's atomic
puts.  The CRC-sealed manifest lands LAST, so a crash mid-ingest
leaves a directory that simply is not a store yet.

Quantization policy (int16/int8): ONE store-wide scale, derived from
the first chunk's max |coordinate| with the readers' drift margin
(``ReaderBase.QUANT_MARGIN``), so chunk-spanning reads can serve raw
quantized slices under a single ``inv_scale`` — the condition for the
:class:`~mdanalysis_mpi_tpu_torch.io.store.reader.StoreReader` staging fast
path.  A chunk whose range outgrows the margin falls back to its own
exact scale (recorded per chunk; readers detect the mismatch and
requantize through f32 instead of serving mixed-scale bytes).
"""

from __future__ import annotations

import os
import time

import numpy as np

from mdanalysis_mpi_tpu_torch.io.base import (
    QUANT_INT_MAX, QUANT_TARGETS, ReaderBase, norm_quantize,
)
from mdanalysis_mpi_tpu_torch.io.store import codec
from mdanalysis_mpi_tpu_torch.io.store.backend import LocalDirBackend
from mdanalysis_mpi_tpu_torch.io.store.manifest import (
    FORMAT, MANIFEST_NAME, VERSION, dump_manifest,
)

#: Default chunk geometry: the flagship staging batch (bench.py
#: BENCH_BATCH default) — chunk = the block ``_run_batches`` stages,
#: so a store-backed run's every stage call is one chunk slice.
DEFAULT_CHUNK_FRAMES = 512

def _count(metric: str, value: int = 1) -> None:
    # lazy obs import, the utils/integrity.py convention
    from mdanalysis_mpi_tpu_torch.obs import METRICS

    METRICS.inc(metric, value)


def norm_store_quant(quant) -> str:
    """Store quantization tier: ``"int16"`` / ``"int8"`` /
    ``"f32"`` (accepting ``None``/``False``/``"float32"`` spellings
    for the passthrough tier)."""
    if quant in (None, False, "f32", "float32"):
        return "f32"
    return norm_quantize(quant)


def ingest(trajectory, out: str | None = None,
           chunk_frames: int | None = None, quant="int16",
           backend=None, stop: int | None = None,
           content_addressed: bool | None = None) -> dict:
    """Ingest ``trajectory`` (a path or an open ReaderBase) into a
    block store at ``out`` (or through an explicit ``backend``).

    ``stop`` bounds the ingested window to frames ``[0, stop)`` —
    the bench's cold-leg protocol ingests a measurement window, not
    the whole fixture.  Returns a summary dict (frame/chunk/byte
    counts, ``store_ingest_fps``; in content-addressed mode also the
    dedup ledger: ``dedup_chunks`` / ``dedup_bytes`` /
    ``dedup_ratio``).

    ``content_addressed``: key chunks by payload digest
    (``cas-<sha256>.mdtc``) instead of position, so re-ingesting
    identical payloads — a second tenant, a re-run — writes ZERO new
    chunk bytes (the put is skipped when the object already exists;
    the manifest still maps logical chunk → digest).  ``None`` (the
    default) follows the backend's own ``content_addressed`` flag:
    on for :class:`~mdanalysis_mpi_tpu_torch.io.store.remote.
    HttpStoreBackend`, off for local directories (where positional
    names keep stores human-diffable).
    """
    owned = None
    if hasattr(trajectory, "read_block"):
        reader = trajectory
    else:
        from mdanalysis_mpi_tpu_torch.io import trajectory_files

        # opened here, closed here (finally below) — a long-lived
        # process re-ingesting many trajectories must not leak source
        # handles; caller-owned readers stay open
        reader = owned = trajectory_files.open(os.fspath(trajectory))
    try:
        if backend is None:
            if out is None:
                raise ValueError(
                    "ingest needs an output path or a backend")
            backend = LocalDirBackend(out)
        if content_addressed is None:
            content_addressed = bool(
                getattr(backend, "content_addressed", False))
        return _ingest(reader, backend, chunk_frames, quant, stop,
                       content_addressed)
    finally:
        if owned is not None:
            owned.close()


def _seal_chunk(backend, ci, lo, block, boxes, times, qmode, scale,
                content_addressed: bool):
    """Quantize, frame and put ONE chunk — the seal step shared by the
    closed-file ingest loop and the live appender
    (:class:`~mdanalysis_mpi_tpu_torch.io.store.append.LiveIngest`).
    Returns ``(entry, scale, overflowed, dedup_bytes)``: the manifest
    entry, the (possibly just-seeded) store-wide scale, whether this
    chunk fell back to its own exact scale, and the bytes NOT written
    thanks to content-addressed dedup (0 otherwise)."""
    hi = lo + len(block)
    arrays: dict = {}
    meta = {"start": lo, "stop": hi, "quant": qmode}
    overflow = False
    if qmode == "f32":
        arrays["coords"] = np.asarray(block, dtype=np.float32)
    else:
        target = QUANT_TARGETS[qmode]
        m = float(np.abs(block).max()) if block.size else 1.0
        if scale is None:
            scale = target / (max(m, 1e-30) * ReaderBase.QUANT_MARGIN)
        s = scale
        if m * s > QUANT_INT_MAX[qmode]:
            # range outgrew the store-wide margin: exact per-chunk
            # scale (readers fall back to f32 requant across it)
            s = target / max(m, 1e-30)
            overflow = True
        arrays["coords"] = np.round(block * s).astype(qmode)
        meta["inv_scale"] = float(1.0 / s)
    if boxes is not None:
        arrays["boxes"] = np.ascontiguousarray(boxes, np.float32)
    if times is not None:
        arrays["times"] = np.ascontiguousarray(times, np.float32)
    blob, fps = codec.encode_chunk(arrays, meta)
    dedup = 0
    digest = None
    if content_addressed:
        # content addressing: the name IS the payload digest, so an
        # identical chunk from ANY prior ingest (another tenant's copy
        # of the same trajectory included) is already there — skip the
        # put, count the bytes not moved
        digest = codec.payload_digest(blob)
        name = codec.cas_chunk_name(digest)
        if backend.exists(name):
            dedup = len(blob)
            _count("mdtpu_store_chunks_deduped_total")
            _count("mdtpu_store_dedup_bytes_total", len(blob))
        else:
            backend.put_bytes(name, blob)
    else:
        name = codec.chunk_name(ci)
        backend.put_bytes(name, blob)
    entry = {"i": ci, "start": lo, "stop": hi, "file": name,
             "nbytes": len(blob), "arrays": list(arrays), "fps": fps}
    if digest is not None:
        entry["digest"] = digest
    if "inv_scale" in meta:
        entry["inv_scale"] = meta["inv_scale"]
    _count("mdtpu_store_chunks_ingested_total")
    return entry, scale, overflow, dedup


def build_manifest(reader_meta: dict, entries: list,
                   overflow_chunks: int) -> dict:
    """The manifest document for ``entries`` — shared by the one-shot
    ingest (written once, last) and the live appender (rewritten as
    the tail manifest after every chunk seal)."""
    n_frames = entries[-1]["stop"] if entries else 0
    return {
        "format": FORMAT, "version": VERSION,
        "n_frames": int(n_frames),
        "n_atoms": int(reader_meta["n_atoms"]),
        "chunk_frames": int(reader_meta["chunk_frames"]),
        "quant": reader_meta["quant"],
        "has_boxes": any("boxes" in e["arrays"] for e in entries),
        "has_times": any("times" in e["arrays"] for e in entries),
        "source": reader_meta.get("source"),
        # chunks that fell back to their own exact scale: every
        # stage request spanning one requantizes through f32 instead
        # of serving raw slices — disclosed, never silent (the "no
        # silent caps" rule), because it quietly costs the store its
        # headline fast path
        "scale_overflow_chunks": overflow_chunks,
        "chunks": entries,
    }


def _ingest(reader, backend, chunk_frames, quant, stop,
            content_addressed: bool = False) -> dict:
    qmode = norm_store_quant(quant)
    cf = int(chunk_frames or DEFAULT_CHUNK_FRAMES)
    if cf < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {cf}")
    n_frames = reader.n_frames
    if stop is not None:
        n_frames = min(n_frames, int(stop))
    # re-ingest over an existing store: kill the old manifest FIRST,
    # so a crash mid-overwrite leaves "not a store" (the fresh-ingest
    # invariant) — never a valid-looking manifest whose fingerprints
    # reject every half-replaced chunk
    backend.delete_bytes(MANIFEST_NAME)
    t0 = time.perf_counter()
    entries = []
    total_bytes = 0
    scale = None          # store-wide scale, seeded by chunk 0
    overflow_chunks = 0
    dedup_chunks = 0
    dedup_bytes = 0
    for ci, lo in enumerate(range(0, n_frames, cf)):
        hi = min(lo + cf, n_frames)
        block, boxes = reader.read_block(lo, hi)
        times = reader.frame_times(range(lo, hi))
        entry, scale, overflow, dedup = _seal_chunk(
            backend, ci, lo, block, boxes, times, qmode, scale,
            content_addressed)
        if overflow:
            overflow_chunks += 1
        if dedup:
            dedup_chunks += 1
            dedup_bytes += dedup
        entries.append(entry)
        total_bytes += entry["nbytes"]
    man = build_manifest(
        {"n_atoms": reader.n_atoms, "chunk_frames": cf,
         "quant": qmode, "source": getattr(reader, "filename", None)},
        entries, overflow_chunks)
    man["n_frames"] = int(n_frames)
    backend.put_bytes(MANIFEST_NAME, dump_manifest(man))
    # a re-ingest with fewer/larger chunks must not strand the old
    # geometry's files as unreferenced disk forever
    kept = {e["file"] for e in entries}
    for name in backend.list_names():
        if name.startswith("chunk-") and name not in kept:
            backend.delete_bytes(name)
    wall = time.perf_counter() - t0
    summary = {
        "store": backend.describe(), "quant": qmode,
        "n_frames": int(n_frames), "n_chunks": len(entries),
        "chunk_frames": cf, "bytes": total_bytes,
        "scale_overflow_chunks": overflow_chunks,
        "wall_s": round(wall, 4),
        "store_ingest_fps": (round(n_frames / wall, 2) if wall > 0
                             else None),
    }
    if content_addressed:
        summary["content_addressed"] = True
        summary["dedup_chunks"] = dedup_chunks
        summary["dedup_bytes"] = dedup_bytes
        summary["dedup_ratio"] = (round(dedup_bytes / total_bytes, 4)
                                  if total_bytes else 0.0)
    return summary
