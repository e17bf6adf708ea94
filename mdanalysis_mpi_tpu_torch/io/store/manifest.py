"""Store manifest: the chunk index, CRC-sealed.

One JSON document (``manifest.json``) describing the whole store:
frame/atom counts, the chunk geometry, the quantization tier, and one
entry per chunk carrying its file name, byte size and stage-time
fingerprint list.  Sealed with the same CRC32C record framing as
journal records (``utils.integrity.record_crc``) and written LAST by
the ingester, so a crashed ingest never leaves a readable-but-partial
store — no manifest, no store.
"""

from __future__ import annotations

import json
import os

from mdanalysis_mpi_tpu_torch.io.store.backend import LocalDirBackend
from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity

FORMAT = "mdtpu-store"
VERSION = 1
MANIFEST_NAME = "manifest.json"
#: Live-ingest tail manifest (docs/STREAMING.md): same CRC-sealed
#: document shape as ``manifest.json`` plus an ``epoch`` counter,
#: rewritten atomically beside the sealed chunks after EVERY chunk
#: seal and referencing only fully-written chunks — so a crashed live
#: ingest degrades to a valid shorter store, never a corrupt one.
#: The final seal promotes tail → closed manifest and deletes it.
TAIL_MANIFEST_NAME = "manifest.tail.json"


def dump_manifest(man: dict) -> bytes:
    man = dict(man)
    man.pop("crc", None)
    man["crc"] = _integrity.record_crc(man)
    return json.dumps(man, sort_keys=True).encode()


def parse_manifest(data: bytes, path: str = MANIFEST_NAME) -> dict:
    try:
        man = json.loads(data)
    except Exception as exc:
        _integrity.note_corrupt("store", path)
        raise _integrity.integrity_error(
            "store", f"store manifest {path!r} is unparseable "
                     f"({type(exc).__name__}: {exc})", path) from exc
    return validate_manifest(man, path)


def validate_manifest(man, path: str = MANIFEST_NAME) -> dict:
    """Format/version/CRC checks over an already-parsed manifest dict
    (split from :func:`parse_manifest` so callers that must sniff AND
    load — :func:`store_meta` — parse the O(chunks) JSON once)."""
    if not isinstance(man, dict) or man.get("format") != FORMAT:
        _integrity.note_corrupt("store", path)
        raise _integrity.integrity_error(
            "store", f"{path!r} is not a {FORMAT} manifest", path)
    if int(man.get("version", 0)) > VERSION:
        raise _integrity.integrity_error(
            "store", f"store manifest {path!r} is version "
                     f"{man.get('version')}; this reader understands "
                     f"<= {VERSION}", path)
    if not _integrity.verify_record(man):
        _integrity.note_corrupt("store", path)
        raise _integrity.integrity_error(
            "store", f"store manifest {path!r} fails its CRC32C — "
                     "the chunk index cannot be trusted", path)
    return man


def load_manifest(backend) -> dict:
    path = os.path.join(backend.describe(), MANIFEST_NAME)
    try:
        data = backend.get_bytes(MANIFEST_NAME)
    except OSError as exc:
        raise FileNotFoundError(
            f"no store manifest at {path!r} ({exc}); run "
            f"`mdanalysis_mpi_tpu_torch.io.store.ingest(trajectory, "
            f"store_dir)` first") from exc
    return parse_manifest(data, path)


def load_tail_manifest(backend) -> dict | None:
    """Parsed + verified tail manifest, or ``None`` when the store has
    no live tail (it is either closed or not a store at all).  A tail
    that EXISTS but fails parsing/CRC raises typed — a live feed whose
    index cannot be trusted must not be silently treated as absent."""
    try:
        data = backend.get_bytes(TAIL_MANIFEST_NAME)
    except OSError:
        return None
    path = os.path.join(backend.describe(), TAIL_MANIFEST_NAME)
    return parse_manifest(data, path)


def load_any_manifest(backend) -> tuple:
    """``(manifest, sealed)`` — the closed manifest when present
    (``sealed=True``), else the live tail manifest (``sealed=False``).
    The closed manifest wins: the final seal writes it BEFORE deleting
    the tail, so a reader racing the promotion sees the sealed store,
    never a gap."""
    try:
        return load_manifest(backend), True
    except FileNotFoundError:
        tail = load_tail_manifest(backend)
        if tail is None:
            raise
        return tail, False


def is_store(path) -> bool:
    """Cheap sniff: does ``path`` look like an ingested store?  (A
    directory carrying a ``manifest.json`` that declares the store
    format — full CRC verification happens at open.)"""
    if not isinstance(path, (str, os.PathLike)) or not os.path.isdir(path):
        return False
    mpath = os.path.join(os.fspath(path), MANIFEST_NAME)
    try:
        with open(mpath, "rb") as f:
            return json.load(f).get("format") == FORMAT
    except Exception:
        return False


#: (path → (stamp, manifest)) — repeat lookups (every sharded submit
#: on the fleet controller, under its lock) hit this instead of
#: re-parsing + re-CRCing an O(chunks) JSON document per submit.  The
#: stamp covers BOTH manifests' (mtime_ns, size, inode): a growing
#: store's tail-manifest rewrite must invalidate the entry even when
#: it lands within the same second at an equal byte size (chunk
#: entries are fixed-width enough for that to happen in practice) —
#: the atomic replace always allocates a fresh inode, so the inode
#: component catches what the mtime+size stamp used to miss and fleet
#: shard routing never sees a stale chunk count.  Bounded; stale
#: entries evict on mismatch.
_META_CACHE: dict = {}
_META_CACHE_MAX = 8


def _stat_stamp(path):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def store_meta(path) -> dict | None:
    """Verified manifest for a store directory, or None when ``path``
    is not one — the fleet controller's lightweight accessor for
    routing per-shard chunk ranges (``chunk_frames``/``n_frames``)
    without opening a reader."""
    if not isinstance(path, (str, os.PathLike)):
        return None
    path = os.fspath(path)
    if isinstance(path, str) and \
            path.startswith(("http://", "https://")):
        # remote store URL: fetch-and-verify through the hardened
        # backend (None when the remote tier is briefly dark — the
        # controller degrades to un-chunked sharding, never fails
        # the submit on a routing lookup)
        from mdanalysis_mpi_tpu_torch.io.store import remote

        return remote.remote_store_meta(path)
    # O(1) stats first: a cache hit must not pay the is_store sniff's
    # full O(chunks) json.load (the fleet controller calls this per
    # sharded submit, under its lock).  A growing (live-ingest) store
    # has only the tail manifest; the closed manifest wins when both
    # exist (the reader's load_any_manifest precedence).
    mpath = os.path.join(path, MANIFEST_NAME)
    tpath = os.path.join(path, TAIL_MANIFEST_NAME)
    mstamp = _stat_stamp(mpath)
    tstamp = _stat_stamp(tpath)
    if mstamp is None and tstamp is None:
        return None
    stamp = (mstamp, tstamp)
    hit = _META_CACHE.get(path)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    # one parse total: sniff (unparseable / foreign manifest.json →
    # "not a store") and verification (OUR format failing its CRC →
    # typed refusal) share the same json.loads
    src = mpath if mstamp is not None else tpath
    try:
        with open(src, "rb") as f:
            man = json.loads(f.read())
    except Exception:
        return None
    if not isinstance(man, dict) or man.get("format") != FORMAT:
        return None
    man = validate_manifest(man, src)
    while len(_META_CACHE) >= _META_CACHE_MAX:
        _META_CACHE.pop(next(iter(_META_CACHE)))
    _META_CACHE[path] = (stamp, man)
    return man
