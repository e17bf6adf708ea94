"""Chunk codec: self-verifying framed array blobs.

One chunk = one staged frame block, encoded as::

    MAGIC | header_len (4 B LE) | header JSON | array bytes (C-order,
                                                concatenated)

The header carries each array's name/dtype/shape plus its
``zlib.crc32`` fingerprint — the SAME fingerprint family as the SDC
scrubber's ``utils.integrity.staged_fingerprint`` (C speed, fit for
bulk payloads) — and is itself sealed with the CRC32C record framing
the journal uses (``utils.integrity.record_crc``: pure-Python
Castagnoli is fine for a ~300-byte header, exactly the short-record
case it exists for).  Decoding verifies BOTH layers and, when the
caller passes the manifest's stage-time fingerprint list, cross-checks
it too — so a flipped payload bit, a corrupted header, a truncated
file, and a swapped-but-self-valid chunk all raise the same typed
:class:`~mdanalysis_mpi_tpu_torch.utils.integrity.StoreCorruptError` instead
of dequantizing garbage.
"""

from __future__ import annotations

import hashlib
import json
import zlib

import numpy as np

from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity

MAGIC = b"MDTC1\n"
_LEN_BYTES = 4


def _reject(path: str, message: str):
    _integrity.note_corrupt("store", path)
    raise _integrity.integrity_error("store", message, path)


def encode_chunk(arrays: dict, meta: dict) -> tuple[bytes, list[int]]:
    """Encode named arrays + chunk metadata into one framed blob.

    Returns ``(blob, fingerprints)`` — the per-array ``zlib.crc32``
    list in array order, which the manifest records as the chunk's
    stage-time fingerprint (what read-time verification compares
    against).
    """
    descs = []
    payloads = []
    fps = []
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        crc = zlib.crc32(a)
        descs.append({"name": name, "dtype": str(a.dtype),
                      "shape": list(a.shape), "crc": crc})
        payloads.append(a.tobytes())
        fps.append(crc)
    header = {"format": "mdtpu-store-chunk", "meta": dict(meta),
              "arrays": descs}
    header["crc"] = _integrity.record_crc(header)
    hjson = json.dumps(header, sort_keys=True).encode()
    blob = b"".join(
        [MAGIC, len(hjson).to_bytes(_LEN_BYTES, "little"), hjson]
        + payloads)
    return blob, fps


def decode_chunk(blob: bytes, path: str = "<chunk>",
                 expect_fps=None) -> tuple[dict, dict]:
    """Decode + verify one framed chunk blob → ``(arrays, meta)``.

    ``expect_fps`` (the manifest's recorded fingerprint list) enables
    the read-time scrub comparison: a chunk whose bytes verify against
    its OWN header but not against the manifest (two valid chunks
    swapped on disk, or a re-written chunk under a stale manifest) is
    rejected too.  Returned arrays are read-only views over ``blob``
    (zero copy — the staging fast path slices them directly).
    """
    head_end = len(MAGIC) + _LEN_BYTES
    if blob[:len(MAGIC)] != MAGIC:
        _reject(path, f"store chunk {path!r} has no {MAGIC!r} magic — "
                      "not a chunk, or its head was destroyed")
    hlen = int.from_bytes(blob[len(MAGIC):head_end], "little")
    try:
        header = json.loads(blob[head_end:head_end + hlen])
        descs = header["arrays"]
    except Exception as exc:     # truncated / flipped header bytes
        _reject(path, f"store chunk {path!r} header is unparseable "
                      f"({type(exc).__name__}: {exc})")
    if not _integrity.verify_record(header):
        _reject(path, f"store chunk {path!r} fails its header CRC32C "
                      "— the frame metadata cannot be trusted")
    arrays: dict = {}
    crcs = []
    off = head_end + hlen
    mv = memoryview(blob)        # true zero copy: bytes slicing copies
    for d in descs:
        dt = np.dtype(d["dtype"])
        shape = tuple(d["shape"])
        size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        seg = mv[off:off + size]
        if len(seg) != size:
            _reject(path, f"store chunk {path!r} is truncated: array "
                          f"{d['name']!r} needs {size} bytes, "
                          f"{len(seg)} remain")
        if zlib.crc32(seg) != d["crc"]:
            _reject(path, f"store chunk {path!r} array {d['name']!r} "
                          "fails its fingerprint — the bytes on disk "
                          "are not the bytes that were ingested")
        arrays[d["name"]] = np.frombuffer(seg, dtype=dt).reshape(shape)
        crcs.append(d["crc"])
        off += size
    if off != len(blob):
        _reject(path, f"store chunk {path!r} carries {len(blob) - off} "
                      "trailing bytes past its declared arrays")
    if expect_fps is not None and list(expect_fps) != crcs:
        _reject(path, f"store chunk {path!r} fingerprints do not match "
                      "the manifest's stage-time record — the chunk "
                      "was swapped or re-written under a stale "
                      "manifest")
    return arrays, header["meta"]


def chunk_name(index: int) -> str:
    return f"chunk-{index:08d}.mdtc"


# ---- content addressing (docs/STORE.md "Remote backend") ----

#: Content-addressed chunk names: ``cas-<sha256 hex>.mdtc``.  The name
#: IS the payload digest, so (a) identical chunks ingested by any
#: tenant collapse to one immutable shared object (dedup), and (b) any
#: holder — a network boundary included — can verify a CAS payload
#: from the name alone, before the reader's CRC/fingerprint pass.
CAS_PREFIX = "cas-"


def payload_digest(blob: bytes) -> str:
    """sha256 hex of a chunk payload — the content address."""
    return hashlib.sha256(blob).hexdigest()


def cas_chunk_name(digest: str) -> str:
    return f"{CAS_PREFIX}{digest}.mdtc"


def cas_digest(name: str) -> str | None:
    """The digest a CAS name claims, or None for positional
    (``chunk-``) and non-chunk names."""
    if not name.startswith(CAS_PREFIX) or not name.endswith(".mdtc"):
        return None
    return name[len(CAS_PREFIX):-len(".mdtc")]


def verify_cas(name: str, blob: bytes, source: str = "?") -> None:
    """Digest-check a CAS payload against its own name; mismatch is
    the fatal half of the taxonomy (bad bytes, never retried from the
    same source).  Positional names pass through — their verification
    lives in :func:`decode_chunk`."""
    want = cas_digest(name)
    if want is None:
        return
    got = payload_digest(blob)
    if got != want:
        _integrity.note_corrupt("store", name)
        raise _integrity.integrity_error(
            "store",
            f"store chunk {name!r} from {source} fails its content "
            f"address (sha256 {got[:16]}… != named {want[:16]}…) — "
            f"corrupt payload", name)
