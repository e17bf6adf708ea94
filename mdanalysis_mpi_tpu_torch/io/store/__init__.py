"""Native chunked trajectory block store (docs/STORE.md).

The reader boundary was the last MDAnalysis-shaped layer in the repo:
every cold pass re-decoded the trajectory file sequentially, and
"Parallel Performance of MD Trajectory Analysis" (PAPERS.md,
1907.00097) shows trajectory I/O — not compute — is what caps parallel
scaling.  This package owns the I/O tier instead:

- **ingest once** (:func:`ingest`): one sequential decode pass
  re-chunks a trajectory to the staging geometry (chunk = the frame
  block ``_run_batches`` stages), quantizes coordinates with the same
  int16/int8 policy as the wire formats (f32 passthrough supported),
  and frames every chunk with CRC fingerprints
  (``utils/integrity.py``);
- **random access** (:class:`StoreReader`): a
  :class:`~mdanalysis_mpi_tpu_torch.io.base.ReaderBase` whose
  ``stage_block`` serves chunk-aligned quantized requests as raw
  slices — no XDR decode, no re-quantize — so executors, prefetch,
  ``HostStageCache`` and the fleet's ``shard_windows`` children fetch
  exactly their slices through the boundary they already use;
- **verified reads**: every chunk's per-array fingerprints are
  re-computed at read time and compared against BOTH the chunk's own
  CRC-framed header and the manifest's stage-time copy — a flipped
  bit or a swapped chunk raises a typed
  :class:`~mdanalysis_mpi_tpu_torch.utils.integrity.StoreCorruptError`
  (counted: ``mdtpu_store_chunk_crc_rejects_total``), never silently
  wrong numbers;
- **pluggable backend** (:class:`StoreBackend`): a local directory
  (:class:`LocalDirBackend`) or the remote chunk service
  (:class:`HttpStoreBackend` — content-addressed dedup, retry/hedge/
  breaker network boundary, cache-first degradation; docs/STORE.md
  "Remote backend") — the reader and ingester only ever see the
  byte-namespace methods.
"""

from mdanalysis_mpi_tpu_torch.io.store.append import LiveIngest, follow
from mdanalysis_mpi_tpu_torch.io.store.backend import (
    LocalDirBackend, StoreBackend,
)
from mdanalysis_mpi_tpu_torch.io.store.ingest import DEFAULT_CHUNK_FRAMES, ingest
from mdanalysis_mpi_tpu_torch.io.store.manifest import (
    MANIFEST_NAME, TAIL_MANIFEST_NAME, is_store, load_any_manifest,
    load_manifest, load_tail_manifest, store_meta,
)
from mdanalysis_mpi_tpu_torch.io.store.reader import StoreEndOfFeed, StoreReader
from mdanalysis_mpi_tpu_torch.io.store.remote import (
    ChunkCache, ChunkServer, HttpStoreBackend, ServerFault,
    is_store_url, open_remote_store,
)

__all__ = [
    "StoreBackend", "LocalDirBackend", "StoreReader", "ingest",
    "LiveIngest", "follow", "StoreEndOfFeed",
    "DEFAULT_CHUNK_FRAMES", "MANIFEST_NAME", "TAIL_MANIFEST_NAME",
    "is_store", "load_manifest", "load_any_manifest",
    "load_tail_manifest", "store_meta", "HttpStoreBackend",
    "ChunkCache", "ChunkServer", "ServerFault", "is_store_url",
    "open_remote_store",
]
