"""End-to-end data integrity: digests, CRC framing, atomic writes.

Every byte the system persists or keeps resident was, before this
module, trusted blindly: journal records, checkpoint ``.npz`` files,
per-job result outputs, and the HBM-resident staged superblocks in
``DeviceBlockCache``.  A full disk turned any of those writes into a
crash (or worse, a torn file), and a flipped bit — disk, RAM, or the
host→device wire — turned them into silently wrong numbers.  The
map-reduce MD-analysis literature this repo reproduces assumes workers
whose partial results can be *verified* before they are merged
(PAPERS.md: 1801.07630 supervisor-over-simulations, 0808.2992
map-reduce framing); this module is the one place that verification
vocabulary lives (docs/RELIABILITY.md §5 "Integrity model"):

- **CRC32C record framing** (:func:`crc32c`, :func:`record_crc`) for
  short persisted records — the journal stamps every JSONL line, and
  replay *rejects* a record whose CRC fails instead of trusting it.
  Pure-Python Castagnoli table: records are ~200 bytes, table lookups
  are noise there, and no dependency is added.
- **Staged-block fingerprints** (:func:`staged_fingerprint`) for the
  SDC scrub path — per-array ``zlib.crc32`` (C speed, ~GB/s: fit for
  the staging hot path), *chainable* so a scan group's stacked
  superblock fingerprint accumulates block-by-block at stage time and
  still equals the fingerprint of the fetched stacked arrays.
- **Content digests** (:func:`digest_arrays`) — sha256 over names,
  dtypes, shapes and bytes — stamped into checkpoints and job ``.npz``
  outputs, so resume-from-corrupt and serve-from-corrupt raise typed
  errors instead of producing wrong numbers.
- **Atomic writes** (:func:`atomic_write`, :func:`write_npz_atomic`) —
  tmp → fsync → rename, with ``ENOSPC``/``EIO``-class ``OSError``\\ s
  mapped to a typed :class:`ArtifactWriteError` and counted
  (``mdtpu_integrity_write_errors_total{artifact=...}``) so callers can
  degrade deliberately: the journal falls back to in-memory with a loud
  counter, checkpoints retry on a spill dir, ``.npz`` failures fail the
  job (not the worker).

Exception taxonomy: :class:`ArtifactWriteError` (an ``OSError``) is
"could not persist"; :class:`IntegrityError` (a ``ValueError``) is
"persisted/resident bytes are wrong", with per-artifact subclasses
(:class:`JournalCorruptError`, :class:`CheckpointCorruptError`,
:class:`ResultCorruptError`) so callers can route without string
matching; :class:`StoreUnavailableError` (an ``OSError``) is "could
not produce the bytes at all" — the retryable availability half of
the store split (missing replica / unreachable remote), versus the
fatal :class:`StoreCorruptError` bad-bytes half.
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
import tempfile
import zlib

import numpy as np

#: npz key carrying the content digest of every OTHER array in the
#: file (docs/RELIABILITY.md §5: digest formats).
DIGEST_KEY = "__mdtpu_digest__"

#: OSError errnos that mean resource exhaustion / media failure — the
#: class an :class:`ArtifactWriteError` exists to make routable.  Any
#: other OSError maps too (a write that did not land is a write that
#: did not land); these are the ones the degradation ladder documents.
EXHAUSTION_ERRNOS = frozenset(
    getattr(errno, name) for name in
    ("ENOSPC", "EDQUOT", "EIO", "EROFS", "EFBIG", "ENODEV")
    if hasattr(errno, name))


class ArtifactWriteError(OSError):
    """A persistence write failed (disk full, I/O error, read-only
    fs).  Carries ``artifact`` (journal / checkpoint / npz / ...) and
    ``path`` so the caller's degradation ladder can route without
    parsing messages.  Subclasses ``OSError`` — ``errno`` is preserved
    from the original failure."""

    def __init__(self, artifact: str, path: str, cause: OSError):
        super().__init__(
            cause.errno if cause.errno is not None else errno.EIO,
            f"{artifact} write to {path!r} failed: {cause}")
        self.artifact = artifact
        self.path = path


class IntegrityError(ValueError):
    """Persisted or resident bytes failed verification (CRC/digest
    mismatch, unparseable container).  A typed refusal: the caller
    must not merge, resume from, or serve the artifact."""

    def __init__(self, message: str, artifact: str = "artifact",
                 path: str | None = None):
        super().__init__(message)
        self.artifact = artifact
        self.path = path


class JournalCorruptError(IntegrityError):
    """A journal record inside the surviving prefix fails its CRC (or
    carries none): recovery REJECTS the journal rather than replaying
    corrupt state.  (A torn, unparseable final line is NOT this — that
    is the write the crash interrupted, and replay skips it.)"""


class CheckpointCorruptError(IntegrityError):
    """A checkpoint file is unreadable or fails its content digest:
    resuming would merge wrong partials into wrong results."""


class ResultCorruptError(IntegrityError):
    """A job ``.npz`` output is unreadable or fails its content
    digest: a ``--journal`` restart must re-run the job rather than
    trust the artifact."""


class StoreCorruptError(IntegrityError):
    """A block-store chunk or manifest fails its CRC framing or its
    manifest fingerprint (docs/STORE.md): the reader must refuse the
    chunk — dequantizing flipped bits produces silently wrong
    coordinates in every analysis downstream."""


class StoreUnavailableError(OSError):
    """A block-store chunk could not be PRODUCED — missing replica,
    unreachable remote endpoint, breaker-open tier with a cold cache
    and no mirror (docs/STORE.md degradation ladder).  The retryable
    half of the store taxonomy: the bytes were never seen, so nothing
    is known corrupt, and the policy layer's transient classifier
    treats it like any flaky-I/O ``OSError`` (retry/backoff may heal
    it).  Contrast :class:`StoreCorruptError` (a ``ValueError``):
    bytes WERE produced and are provably wrong — re-fetching the same
    source as "transient" is forbidden.  Carries ``name`` (the chunk
    or manifest object) and ``source`` (backend description)."""

    def __init__(self, message: str, name: str | None = None,
                 source: str | None = None):
        super().__init__(errno.EHOSTUNREACH, message)
        self.name = name
        self.source = source


_EXC_BY_ARTIFACT = {
    "journal": JournalCorruptError,
    "checkpoint": CheckpointCorruptError,
    "npz": ResultCorruptError,
    "store": StoreCorruptError,
}


def integrity_error(artifact: str, message: str,
                    path: str | None = None) -> IntegrityError:
    """The typed corruption error for ``artifact`` (the subclass table
    above; plain :class:`IntegrityError` for unknown kinds)."""
    cls = _EXC_BY_ARTIFACT.get(artifact, IntegrityError)
    return cls(message, artifact=artifact, path=path)


# ---- observability (lazy obs import: utils must stay importable
#      before jax/obs side effects in odd embedding orders) ----

def _count(metric: str, **labels) -> None:
    from mdanalysis_mpi_tpu_torch.obs import METRICS

    METRICS.inc(metric, **labels)


def note_write_error(artifact: str, path: str) -> None:
    """Count + trace-instant one persistence write failure — the loud
    half of every graceful degradation below."""
    from mdanalysis_mpi_tpu_torch.obs import METRICS, span_event

    METRICS.inc("mdtpu_integrity_write_errors_total", artifact=artifact)
    span_event("artifact_write_error", artifact=artifact, path=path)


def note_verified(artifact: str) -> None:
    _count("mdtpu_integrity_verifications_total", artifact=artifact)


def note_corrupt(artifact: str, path: str | None = None) -> None:
    from mdanalysis_mpi_tpu_torch.obs import METRICS, span_event

    METRICS.inc("mdtpu_integrity_corrupt_total", artifact=artifact)
    span_event("artifact_corrupt", artifact=artifact,
               path=path or "")


# ---- CRC32C (Castagnoli): record framing ----

def _make_crc32c_table() -> tuple:
    poly = 0x82F63B78            # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes, value: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``value``
    (same chaining convention as ``zlib.crc32``).  Pure Python —
    intended for SHORT records (journal lines), not bulk data: use
    :func:`staged_fingerprint` for block payloads."""
    crc = value ^ 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def record_crc(rec: dict) -> str:
    """8-hex CRC32C over the canonical JSON rendering of ``rec``
    (sorted keys, no ``crc`` field) — what the journal stamps into
    every line and replay verifies."""
    body = {k: v for k, v in rec.items() if k != "crc"}
    return format(
        crc32c(json.dumps(body, sort_keys=True, default=str).encode()),
        "08x")


def verify_record(rec: dict) -> bool:
    """True when ``rec`` carries a ``crc`` field matching its own
    canonical rendering."""
    crc = rec.get("crc")
    return crc is not None and crc == record_crc(rec)


# ---- staged-block fingerprints (SDC scrub) ----

def _buf_crc(x, start: int = 0) -> int:
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return zlib.crc32(a, start)


def staged_fingerprint(staged, start=None) -> tuple:
    """Per-array CRCs of one staged tuple (host numpy OR fetched
    device arrays — ``np.asarray`` normalizes both).

    ``start`` chains: the scan-fold path accumulates a group's
    fingerprint block-by-block at stage time
    (``fp = staged_fingerprint(block_i, fp)``), and because
    ``_stack_staged`` stacks every leaf along a new leading axis in
    block order (C-order bytes = the blocks' bytes concatenated), the
    chained value equals ``staged_fingerprint(fetched_superblock)`` —
    no device fetch is ever needed at stage time."""
    out = []
    for i, x in enumerate(staged):
        s = 0 if start is None else start[i]
        out.append(_buf_crc(x, s))
    return tuple(out)


# ---- content digests ----

def digest_arrays(arrays: dict) -> str:
    """sha256 over sorted names + dtype + shape + bytes of every array
    — the content digest stamped into checkpoints and job ``.npz``
    outputs (the ``DIGEST_KEY`` entry itself is excluded)."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        if name == DIGEST_KEY:
            continue
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        # buffer protocol, not tobytes(): hashing a multi-GB partials
        # tree must not transiently DOUBLE its memory at exactly the
        # scales where staged blocks already dominate RAM
        h.update(a)
    return h.hexdigest()


# ---- atomic writes with typed exhaustion mapping ----

def atomic_write(path: str, writer, artifact: str = "artifact") -> None:
    """tmp → fsync → rename.  ``writer(tmp_path)`` produces the
    content (e.g. ``np.savez``); the file is then fsync'd and
    atomically renamed over ``path``, so a crash at ANY point leaves
    either the old file or the new one — never a torn hybrid.  Any
    ``OSError`` on the way (ENOSPC, EIO, EROFS, ...) is counted
    (``mdtpu_integrity_write_errors_total``) and re-raised as a typed
    :class:`ArtifactWriteError` so callers can degrade deliberately
    instead of crashing a worker on a full disk."""
    tmp = path + ".tmp"
    try:
        writer(tmp)
        with open(tmp, "rb+") as f:
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as exc:
        if isinstance(exc, ArtifactWriteError):
            raise
        note_write_error(artifact, path)
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        raise ArtifactWriteError(artifact, path, exc) from exc


def atomic_write_bytes(path: str, data: bytes,
                       artifact: str = "artifact") -> None:
    def writer(tmp):
        with open(tmp, "wb") as f:
            f.write(data)

    atomic_write(path, writer, artifact)


def spill_dir() -> str:
    """Where checkpoints retry when their primary directory is
    exhausted (``MDTPU_SPILL_DIR``, else the system temp dir) — step 2
    of the ENOSPC degradation ladder (docs/RELIABILITY.md §5)."""
    return os.environ.get("MDTPU_SPILL_DIR") or tempfile.gettempdir()


# ---- digest-stamped npz artifacts ----

def write_npz_atomic(path: str, arrays: dict,
                     artifact: str = "npz") -> None:
    """``np.savez`` with a :data:`DIGEST_KEY` content digest, written
    atomically (tmp → fsync → rename).  :func:`verify_npz` is the read
    side."""
    digest = digest_arrays(arrays)

    def writer(tmp):
        # np.savez appends .npz to bare names; write the exact tmp
        # path via the file-object form so atomic_write's rename
        # source actually exists
        with open(tmp, "wb") as tmp_f:
            np.savez(tmp_f, **{DIGEST_KEY: np.str_(digest)}, **arrays)

    atomic_write(path, writer, artifact)


def verify_npz(path: str, artifact: str = "npz") -> dict:
    """Load + verify a digest-stamped ``.npz``; returns the arrays
    (digest entry stripped).  Raises the artifact's typed
    :class:`IntegrityError` subclass when the container is unreadable,
    the digest entry is missing, or the content digest mismatches —
    and counts the outcome either way."""
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {name: z[name] for name in z.files}
    except IntegrityError:
        raise
    except Exception as exc:     # BadZipFile, OSError, ValueError, ...
        note_corrupt(artifact, path)
        raise integrity_error(
            artifact,
            f"{artifact} {path!r} is unreadable ({type(exc).__name__}: "
            f"{exc}) — refusing to trust it", path) from exc
    stamped = arrays.pop(DIGEST_KEY, None)
    if stamped is None:
        note_corrupt(artifact, path)
        raise integrity_error(
            artifact,
            f"{artifact} {path!r} carries no content digest "
            f"({DIGEST_KEY}) — not a digest-stamped artifact, or the "
            "stamp was destroyed", path)
    if str(stamped) != digest_arrays(arrays):
        note_corrupt(artifact, path)
        raise integrity_error(
            artifact,
            f"{artifact} {path!r} fails its content digest — the bytes "
            "on disk are not the bytes that were written", path)
    note_verified(artifact)
    return arrays
