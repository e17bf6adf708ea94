"""Pluggable store backends: a named byte namespace.

The reader and ingester address chunks by NAME only (``manifest.json``,
``chunk-00000042.mdtc``, ``cas-<digest>.mdtc``); everything about
*where* those bytes live is behind this interface.  A local directory
is the shipped default; :class:`~mdanalysis_mpi_tpu_torch.io.store.remote.
HttpStoreBackend` speaks the same methods over a GET/PUT/HEAD/range
chunk protocol.  The interface stays bytes-in/bytes-out with chunk
granularity as the PRIMARY access granularity (a chunk equals one
staged block); :meth:`StoreBackend.get_range` exists for transports
where a byte sub-range is cheaper than the whole object (HTTP Range
requests serving exactly the spans a shard child needs) and defaults
to slicing a whole-object read, so every backend supports it.

Error taxonomy at this boundary (the reader keys off it):

- :class:`~mdanalysis_mpi_tpu_torch.utils.integrity.StoreUnavailableError`
  (an ``OSError``, retryable): the name could not be produced at all
  — missing file/replica, unreachable endpoint.
- :class:`~mdanalysis_mpi_tpu_torch.utils.integrity.StoreCorruptError`
  (an ``IntegrityError``, fatal): bytes were produced and are
  provably wrong (digest/CRC mismatch).  Never re-fetched from the
  same source as "transient".
"""

from __future__ import annotations

import os

from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity


class StoreBackend:
    """Abstract chunk-store backend (local dir, HTTP chunk service).
    Implementations must make :meth:`put_bytes` atomic — a reader
    must never observe a torn chunk (the local backend rides
    ``utils.integrity.atomic_write_bytes``'s tmp → fsync → rename) —
    and must raise the typed split above from :meth:`get_bytes`:
    missing name → ``StoreUnavailableError``, provably bad bytes →
    ``StoreCorruptError``."""

    #: Where the LAST ``get_bytes`` on this thread was actually served
    #: from, for usage attribution (obs/usage.py ``source=`` label):
    #: ``local`` / ``remote`` / ``cache``.  Plain files are always
    #: local; the HTTP backend overrides this per degradation rung.
    usage_source = "local"

    def put_bytes(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def get_bytes(self, name: str) -> bytes:
        raise NotImplementedError

    def get_range(self, name: str, start: int, stop: int) -> bytes:
        """Bytes ``[start, stop)`` of ``name`` — exactly
        ``get_bytes(name)[start:stop]`` (a past-the-end ``stop``
        clamps, like a slice).  Default: fetch whole, slice local;
        transports with native ranged reads (HTTP ``Range``) override
        to move only the span."""
        if start < 0 or stop < start:
            raise ValueError(
                f"bad byte range [{start}, {stop}) for {name!r}")
        return self.get_bytes(name)[start:stop]

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def delete_bytes(self, name: str) -> None:
        """Remove ``name`` if present (idempotent).  The ingester
        deletes a pre-existing manifest BEFORE overwriting chunks, so
        a crashed re-ingest leaves a directory that is not a store
        (the fresh-ingest invariant) instead of a valid-looking
        manifest over half-replaced chunks."""
        raise NotImplementedError

    def list_names(self) -> list[str]:
        raise NotImplementedError

    def describe(self) -> str:
        """Human-readable location (error messages, manifests)."""
        return type(self).__name__


class LocalDirBackend(StoreBackend):
    """Chunks as files under one directory.

    Writes are atomic (``utils.integrity.atomic_write_bytes``:
    tmp → fsync → rename, ENOSPC-class failures mapped to typed
    :class:`~mdanalysis_mpi_tpu_torch.utils.integrity.ArtifactWriteError`
    and counted), so a crashed ingest leaves whole chunks or no
    chunks — and since the manifest is written LAST, no manifest at
    all: the half-ingested directory is simply not a store."""

    def __init__(self, root: str):
        self.root = os.fspath(root)

    def put_bytes(self, name: str, data: bytes) -> None:
        os.makedirs(self.root, exist_ok=True)
        _integrity.atomic_write_bytes(
            os.path.join(self.root, name), data, artifact="store")

    def get_bytes(self, name: str) -> bytes:
        try:
            with open(os.path.join(self.root, name), "rb") as f:
                return f.read()
        except FileNotFoundError as exc:
            # the retryable half of the split: the name is absent, not
            # torn — on a replicated tier another source may have it
            raise _integrity.StoreUnavailableError(
                f"store object {name!r} missing under {self.root!r}",
                name=name, source=self.root) from exc

    def get_range(self, name: str, start: int, stop: int) -> bytes:
        if start < 0 or stop < start:
            raise ValueError(
                f"bad byte range [{start}, {stop}) for {name!r}")
        try:
            with open(os.path.join(self.root, name), "rb") as f:
                f.seek(start)
                return f.read(stop - start)
        except FileNotFoundError as exc:
            raise _integrity.StoreUnavailableError(
                f"store object {name!r} missing under {self.root!r}",
                name=name, source=self.root) from exc

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.root, name))

    def delete_bytes(self, name: str) -> None:
        try:
            os.remove(os.path.join(self.root, name))
        except FileNotFoundError:
            pass

    def list_names(self) -> list[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(os.listdir(self.root))

    def describe(self) -> str:
        return self.root
