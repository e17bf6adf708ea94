"""Remote chunk service: HTTP store backend + fault-hardened boundary.

The remote data tier ROADMAP item 3 calls in: chunks live behind a
minimal GET/PUT/HEAD/range HTTP protocol (stdlib ``http.client`` —
object stores are this four-verb shape) instead of a local directory,
and the network boundary is hardened the way the serving stack already
is (docs/RELIABILITY.md): deterministic fault injection, retry with
backoff under per-request deadlines, one hedged read for a slow
replica, a per-endpoint circuit breaker, and a degradation ladder that
keeps jobs completing through an outage.

Protocol (one namespace per tenant store + one shared CAS namespace)::

    GET/PUT/HEAD/DELETE  /stores/<store>/<name>     mutable objects
    GET/PUT/HEAD         /cas/<name>                immutable chunks
    GET                  /stores/<store>/           JSON name list

Chunks are **content-addressed** (``codec.cas_chunk_name``): the
object name is the payload's sha256, so identical trajectories
ingested by different tenants collapse to shared immutable objects
(dedup, surfaced in ingest summaries), and ANY holder can verify a
chunk payload from its name alone — which is what lets this boundary
reject a corrupt remote body typed (``StoreCorruptError``) and try a
different source instead of poisoning the cache, before the reader's
own CRC/fingerprint pass (which stays mandatory).

Read path = the degradation ladder (each step disclosed with a
``store_remote_degraded`` span instant):

1. per-host read-through :class:`ChunkCache` (immutable CAS names
   only — mutable names consult the remote first and fall back here);
2. remote endpoints in order, each behind a ``BreakerBoard`` breaker
   keyed ``(endpoint, "remote")``: retry with backoff on transient
   faults (timeout / 5xx / reset / truncated), at most one hedged
   read per GET when the primary is slow, NEVER a same-source retry
   after provable corruption;
3. the local mirror, if configured;
4. typed :class:`~mdanalysis_mpi_tpu_torch.utils.integrity.
   StoreUnavailableError` (retryable) — or ``StoreCorruptError`` when
   every source that answered produced provably bad bytes.

:class:`ChunkServer` is the in-process test fixture (the ``statusd``
pattern: stdlib ``ThreadingHTTPServer`` on an ephemeral port) serving
the same protocol off a local directory, with a deterministic
server-side fault schedule (:class:`ServerFault`: 5xx, stalls,
connection resets, truncated bodies, corrupt payloads — visit
counters, no randomness) so every client failure path replays
bit-for-bit.  Client-side injection (a connection that never starts)
is the ``remote`` site in :mod:`mdanalysis_mpi_tpu_torch.reliability.faults`.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from mdanalysis_mpi_tpu_torch.io.store import codec
from mdanalysis_mpi_tpu_torch.io.store.backend import (
    LocalDirBackend, StoreBackend,
)
from mdanalysis_mpi_tpu_torch.reliability import faults as _faults
from mdanalysis_mpi_tpu_torch.reliability.breaker import (
    HALF_OPEN, OPEN, BreakerBoard,
)
from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity

#: Default per-host read-through cache budget: enough to keep a whole
#: bench-scale wave's working set servable through an outage, small
#: next to the staged-block tiers above it.
DEFAULT_CACHE_BYTES = 256 << 20


def _obs():
    # lazy obs import, the utils/integrity.py convention
    from mdanalysis_mpi_tpu_torch.obs import METRICS, span_event

    return METRICS, span_event


class _TransportError(Exception):
    """One failed HTTP round trip, classified for the retry policy and
    the ``mdtpu_store_remote_errors_total{kind=}`` counter: ``timeout``
    / ``reset`` / ``truncated`` / ``http_5xx``.  Internal — the
    envelope turns exhaustion into the typed public split."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


class ChunkCache:
    """Per-host read-through chunk cache: a byte-bounded, thread-safe
    LRU of VERIFIED blobs (everything inserted has passed its content
    address or come off a trusted local source).  Step 2 of the
    degradation ladder: a breaker-open remote serves warm reads from
    here at local speed.  Counts
    ``mdtpu_store_cache_{hits,misses}_total`` and gauges
    ``mdtpu_store_cache_bytes``."""

    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._blobs: dict = {}          # key -> bytes, LRU order
        self._bytes = 0

    def get(self, key) -> bytes | None:
        with self._lock:
            blob = self._blobs.pop(key, None)
            if blob is not None:
                self._blobs[key] = blob          # refresh recency
        metrics, _ = _obs()
        metrics.inc("mdtpu_store_cache_hits_total" if blob is not None
                    else "mdtpu_store_cache_misses_total")
        return blob

    def put(self, key, blob: bytes) -> None:
        if len(blob) > self.max_bytes:
            return                        # never evict the world for one
        with self._lock:
            old = self._blobs.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._blobs[key] = blob
            self._bytes += len(blob)
            while self._bytes > self.max_bytes and self._blobs:
                lru = next(iter(self._blobs))   # insertion order = LRU
                self._bytes -= len(self._blobs.pop(lru))
            total = self._bytes
        metrics, _ = _obs()
        metrics.set_gauge("mdtpu_store_cache_bytes", total)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._blobs)


#: The default per-host cache every remote reader shares (one outage,
#: one working set — a second reader of the same store must not fault
#: the same chunks twice).  Tests pass their own for isolation.
HOST_CHUNK_CACHE = ChunkCache()


class HttpStoreBackend(StoreBackend):
    """:class:`StoreBackend` over the chunk-service HTTP protocol.

    ``endpoints``
        One base URL or an ordered replica list
        (``"http://host:port"``); reads try them in order, writes land
        on the first healthy one.
    ``store``
        Tenant namespace for mutable names (``manifest.json``);
        content-addressed chunks live in the shared ``/cas/``
        namespace regardless.
    ``timeout_s`` / ``retries`` / ``backoff_s`` / ``backoff_factor``
        Per-request deadline (socket timeout) and the transient-fault
        retry envelope per endpoint.
    ``hedge_s``
        When set and a second replica exists: a GET whose primary has
        not answered within ``hedge_s`` issues ONE hedged read against
        the next replica and takes whichever source answers first
        (counted ``mdtpu_store_remote_hedges_total``; breaker
        accounting stays with the primary conversation).
    ``breakers``
        A shared :class:`~mdanalysis_mpi_tpu_torch.reliability.breaker.
        BreakerBoard` (one per process is typical); breakers are keyed
        ``(endpoint, "remote")`` so one replica's outage never
        blacklists another.  An open breaker skips its endpoint; a
        half-open one admits traffic only after a cheap HEAD probe
        succeeds (recovery is the probe path, not a tenant read).
    ``cache`` / ``mirror``
        Ladder steps 2 and 3: the read-through :class:`ChunkCache`
        (defaults to the per-host :data:`HOST_CHUNK_CACHE`) and an
        optional local :class:`StoreBackend` (or path) holding a
        mirror of the store.
    """

    #: The ingester keys chunks by payload digest over this backend
    #: (dedup across tenants — docs/STORE.md "Remote backend").
    content_addressed = True

    def __init__(self, endpoints, store: str = "default", *,
                 timeout_s: float = 5.0, retries: int = 2,
                 backoff_s: float = 0.05, backoff_factor: float = 2.0,
                 hedge_s: float | None = None, breakers=None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 5.0,
                 cache: ChunkCache | None = None, mirror=None,
                 sleep=time.sleep):
        if isinstance(endpoints, str):
            endpoints = [endpoints]
        self.endpoints = [e.rstrip("/") for e in endpoints]
        if not self.endpoints:
            raise ValueError("HttpStoreBackend needs >= 1 endpoint")
        self.store = store
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.hedge_s = None if hedge_s is None else float(hedge_s)
        self.breakers = breakers if breakers is not None else \
            BreakerBoard(threshold=breaker_threshold,
                         cooldown_s=breaker_cooldown_s)
        self.cache = cache if cache is not None else HOST_CHUNK_CACHE
        if isinstance(mirror, (str, os.PathLike)):
            mirror = LocalDirBackend(os.fspath(mirror))
        self.mirror = mirror
        self._sleep = sleep
        # per-thread source of the last get_bytes (usage attribution);
        # thread-local because fleet workers share one backend
        self._usage_src = threading.local()

    @property
    def usage_source(self) -> str:
        """``cache`` / ``remote`` / ``local`` (mirror) — which ladder
        rung served this thread's last :meth:`get_bytes`."""
        return getattr(self._usage_src, "value", "remote")

    # ---- protocol plumbing ----

    def _path(self, name: str) -> str:
        if codec.cas_digest(name) is not None:
            return f"/cas/{name}"
        return f"/stores/{self.store}/{name}"

    def _cache_key(self, name: str):
        # CAS names are globally immutable (digest-verified), so the
        # cache entry is shared across stores/tenants; mutable names
        # (the manifest) are namespaced to this store's first endpoint
        if codec.cas_digest(name) is not None:
            return ("cas", name)
        return (self.endpoints[0], self.store, name)

    def _request(self, endpoint: str, method: str, path: str,
                 body: bytes | None = None, headers=None,
                 timeout: float | None = None):
        """One HTTP round trip → ``(status, headers, body)``; raises
        :class:`_TransportError` for anything that is not a complete
        response (and maps 5xx there too — a retryable server-side
        failure, unlike 4xx which is a protocol answer)."""
        if _faults.plans():
            try:
                _faults.fire("remote")
            except _faults.InjectedTransientError as exc:
                # the client-half injection (a connection that never
                # starts) enters the SAME retry envelope a real
                # refused connection would; deliberately only the
                # transient class — an InjectedCrash must keep
                # unwinding past every recovery layer
                raise _TransportError("injected", str(exc)) from exc
        metrics, _ = _obs()
        metrics.inc("mdtpu_store_remote_requests_total", verb=method)
        u = urlsplit(endpoint)
        conn = http.client.HTTPConnection(
            u.hostname, u.port, timeout=timeout or self.timeout_s)
        try:
            try:
                conn.request(method, path, body=body,
                             headers=dict(headers or {}))
                resp = conn.getresponse()
                status = resp.status
                rheaders = dict(resp.getheaders())
                data = b"" if method == "HEAD" else resp.read()
            except TimeoutError as exc:
                raise _TransportError(
                    "timeout", f"{method} {endpoint}{path} exceeded "
                               f"its {timeout or self.timeout_s}s "
                               f"deadline") from exc
            except http.client.IncompleteRead as exc:
                raise _TransportError(
                    "truncated", f"{method} {endpoint}{path} body "
                                 f"truncated ({exc})") from exc
            except (ConnectionError, http.client.HTTPException,
                    OSError) as exc:
                raise _TransportError(
                    "reset", f"{method} {endpoint}{path} connection "
                             f"failed ({type(exc).__name__}: "
                             f"{exc})") from exc
        finally:
            conn.close()
        if method != "HEAD":
            clen = rheaders.get("Content-Length")
            if clen is not None and len(data) != int(clen):
                raise _TransportError(
                    "truncated", f"{method} {endpoint}{path} body "
                                 f"truncated ({len(data)}/{clen} B)")
        if status >= 500:
            raise _TransportError(
                "http_5xx", f"{method} {endpoint}{path} -> {status}")
        return status, rheaders, data

    # ---- the robustness envelope ----

    def _breaker(self, endpoint: str):
        return self.breakers.get(endpoint, "remote")

    def _admit(self, endpoint: str) -> bool:
        """Consult the endpoint's breaker: open skips it, half-open
        admits only after a cheap HEAD probe (the recovery path —
        probe success closes the breaker, failure re-opens it for
        another cooldown)."""
        br = self._breaker(endpoint)
        st = br.state
        if st == OPEN:
            return False
        if st == HALF_OPEN:
            return br.probe(lambda: self._request(
                endpoint, "HEAD",
                f"/stores/{self.store}/manifest.json"))
        return True

    def _with_retries(self, endpoint: str, fn, name: str):
        """Run ``fn()`` against one endpoint under the transient-fault
        retry envelope.  Corruption is NOT in the envelope — a caller
        seeing ``StoreCorruptError`` moves to a different source."""
        metrics, span_event = _obs()
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                return fn(attempt)
            except _TransportError as exc:
                metrics.inc("mdtpu_store_remote_errors_total",
                            kind=exc.kind)
                if attempt >= self.retries:
                    raise
                metrics.inc("mdtpu_store_remote_retries_total")
                span_event("store_remote_retry", endpoint=endpoint,
                           chunk=name, kind=exc.kind,
                           attempt=attempt + 1)
                self._sleep(delay)
                delay *= self.backoff_factor

    def _hedged_get(self, endpoint: str, path: str, name: str,
                    attempt: int):
        """One GET with at most one hedged read: if the primary has
        not answered within ``hedge_s``, race the next replica and
        take the first complete answer (hedging applies to the first
        attempt only — backoff retries are already the slow path)."""
        others = [e for e in self.endpoints if e != endpoint]
        if self.hedge_s is None or attempt > 0 or not others:
            return self._request(endpoint, "GET", path)
        outcome: dict = {}
        done = threading.Event()

        def _primary():
            try:
                outcome["r"] = self._request(endpoint, "GET", path)
            except Exception as exc:            # re-raised by winner
                outcome["e"] = exc
            finally:
                done.set()

        t = threading.Thread(target=_primary, daemon=True,
                             name="mdtpu-store-hedge-primary")
        t.start()
        if done.wait(self.hedge_s):
            if "e" in outcome:
                raise outcome["e"]
            return outcome["r"]
        metrics, span_event = _obs()
        metrics.inc("mdtpu_store_remote_hedges_total")
        span_event("store_remote_hedge", slow=endpoint,
                   hedge=others[0], chunk=name)
        try:
            return self._request(others[0], "GET", path)
        except (_TransportError, _integrity.IntegrityError):
            # hedge lost too: fall back to however the slow primary
            # ends (its own deadline bounds the wait)
            done.wait(self.timeout_s + 1.0)
            if "r" in outcome:
                return outcome["r"]
            if "e" in outcome:
                raise outcome["e"] from None
            raise

    def _remote_get(self, name: str):
        """The per-endpoint read loop → ``(blob | None,
        last_corrupt_exc | None)``.  A provably corrupt body fails the
        endpoint immediately (never a same-source retry); transient
        faults retry with backoff then fail the endpoint; a 404 is a
        HEALTHY conversation (the replica just lacks the name)."""
        metrics, span_event = _obs()
        path = self._path(name)
        last_corrupt = None
        for endpoint in self.endpoints:
            if not self._admit(endpoint):
                continue
            br = self._breaker(endpoint)
            try:
                status, _h, data = self._with_retries(
                    endpoint,
                    lambda attempt: self._hedged_get(
                        endpoint, path, name, attempt),
                    name)
            except _TransportError:
                br.record_failure()
                continue
            if status == 404:
                br.record_success()
                continue
            if status >= 400:
                br.record_failure()
                continue
            try:
                codec.verify_cas(name, data, source=endpoint)
            except _integrity.StoreCorruptError as exc:
                metrics.inc("mdtpu_store_remote_errors_total",
                            kind="corrupt")
                last_corrupt = exc
                br.record_failure()
                continue            # a DIFFERENT source, never a retry
            br.record_success()
            return data, None
        return None, last_corrupt

    # ---- StoreBackend surface ----

    def get_bytes(self, name: str) -> bytes:
        metrics, span_event = _obs()
        key = self._cache_key(name)
        immutable = codec.cas_digest(name) is not None
        if immutable:
            hit = self.cache.get(key)
            if hit is not None:
                self._usage_src.value = "cache"
                return hit
        blob, corrupt = self._remote_get(name)
        if blob is not None:
            self.cache.put(key, blob)
            self._usage_src.value = "remote"
            return blob
        # ---- degradation ladder (remote exhausted) ----
        if not immutable:
            # mutable names consult the remote first (a re-ingest must
            # be visible), so the cache is their OUTAGE copy — serving
            # it here is the disclosed stale-read degradation
            hit = self.cache.get(key)
            if hit is not None:
                span_event("store_remote_degraded", step="cache",
                           chunk=name)
                self._usage_src.value = "cache"
                return hit
        if self.mirror is not None:
            try:
                blob = self.mirror.get_bytes(name)
                codec.verify_cas(name, blob,
                                 source=self.mirror.describe())
                metrics.inc("mdtpu_store_mirror_reads_total")
                span_event("store_remote_degraded", step="mirror",
                           chunk=name)
                self.cache.put(key, blob)
                self._usage_src.value = "local"
                return blob
            except (_integrity.StoreUnavailableError, OSError):
                pass
        if corrupt is not None:
            # every source that produced bytes produced WRONG bytes:
            # that is the fatal half of the split, not an availability
            # blip a retry could heal
            raise corrupt
        metrics.inc("mdtpu_store_unavailable_total")
        span_event("store_remote_degraded", step="unavailable",
                   chunk=name)
        raise _integrity.StoreUnavailableError(
            f"store object {name!r} unavailable: every remote "
            f"endpoint failed or is breaker-open "
            f"({', '.join(self.endpoints)}), not cached"
            + ("" if self.mirror is None else ", mirror missed"),
            name=name, source=self.describe())

    def get_range(self, name: str, start: int, stop: int) -> bytes:
        if start < 0 or stop < start:
            raise ValueError(
                f"bad byte range [{start}, {stop}) for {name!r}")
        if start == stop:
            return b""
        hit = self.cache.get(self._cache_key(name))
        if hit is not None:
            return hit[start:stop]
        path = self._path(name)
        rng = {"Range": f"bytes={start}-{stop - 1}"}
        for endpoint in self.endpoints:
            if not self._admit(endpoint):
                continue
            br = self._breaker(endpoint)
            try:
                status, _h, data = self._with_retries(
                    endpoint,
                    lambda attempt: self._request(
                        endpoint, "GET", path, headers=rng),
                    name)
            except _TransportError:
                br.record_failure()
                continue
            if status == 416:           # start past the end: slice
                br.record_success()     # semantics say empty, like
                return b""              # get_bytes(name)[len:...]
            if status == 404:
                br.record_success()
                continue
            if status >= 400:
                br.record_failure()
                continue
            br.record_success()
            if status == 206:
                return data
            return data[start:stop]     # 200: whole body, slice local
        if self.mirror is not None:
            try:
                data = self.mirror.get_range(name, start, stop)
                metrics, span_event = _obs()
                metrics.inc("mdtpu_store_mirror_reads_total")
                span_event("store_remote_degraded", step="mirror",
                           chunk=name)
                return data
            except (_integrity.StoreUnavailableError, OSError):
                pass
        metrics, span_event = _obs()
        metrics.inc("mdtpu_store_unavailable_total")
        span_event("store_remote_degraded", step="unavailable",
                   chunk=name)
        raise _integrity.StoreUnavailableError(
            f"byte range [{start},{stop}) of {name!r} unavailable "
            f"from {', '.join(self.endpoints)}",
            name=name, source=self.describe())

    def put_bytes(self, name: str, data: bytes) -> None:
        path = self._path(name)
        last: Exception | None = None
        for endpoint in self.endpoints:
            if not self._admit(endpoint):
                continue
            br = self._breaker(endpoint)
            try:
                status, _h, _b = self._with_retries(
                    endpoint,
                    lambda attempt: self._request(
                        endpoint, "PUT", path, body=data,
                        headers={"Content-Length": str(len(data))}),
                    name)
            except _TransportError as exc:
                br.record_failure()
                last = exc
                continue
            if status in (200, 201, 204):
                br.record_success()
                # writes refresh the read-through copy so a read-after-
                # write during an outage serves what was written
                self.cache.put(self._cache_key(name), data)
                return
            br.record_failure()
            last = _TransportError("http_5xx",
                                   f"PUT {path} -> {status}")
        raise _integrity.StoreUnavailableError(
            f"could not write store object {name!r} to any endpoint "
            f"({', '.join(self.endpoints)}): {last}",
            name=name, source=self.describe())

    def exists(self, name: str) -> bool:
        if codec.cas_digest(name) is not None \
                and self.cache.get(self._cache_key(name)) is not None:
            return True
        path = self._path(name)
        last: Exception | None = None
        for endpoint in self.endpoints:
            if not self._admit(endpoint):
                continue
            br = self._breaker(endpoint)
            try:
                status, _h, _b = self._with_retries(
                    endpoint,
                    lambda attempt: self._request(endpoint, "HEAD",
                                                  path),
                    name)
            except _TransportError as exc:
                br.record_failure()
                last = exc
                continue
            br.record_success()
            if status == 200:
                return True
            # 404: this replica lacks it — a later replica may not
        if last is None:
            return False
        raise _integrity.StoreUnavailableError(
            f"could not HEAD store object {name!r} on any endpoint: "
            f"{last}", name=name, source=self.describe())

    def delete_bytes(self, name: str) -> None:
        if codec.cas_digest(name) is not None:
            return          # CAS objects are immutable and shared —
        #                     lifecycle (refcount/GC) is the service's
        path = self._path(name)
        for endpoint in self.endpoints:
            if not self._admit(endpoint):
                continue
            br = self._breaker(endpoint)
            try:
                self._with_retries(
                    endpoint,
                    lambda attempt: self._request(endpoint, "DELETE",
                                                  path),
                    name)
                br.record_success()
                return
            except _TransportError:
                br.record_failure()
        raise _integrity.StoreUnavailableError(
            f"could not delete store object {name!r} on any endpoint",
            name=name, source=self.describe())

    def list_names(self) -> list[str]:
        for endpoint in self.endpoints:
            if not self._admit(endpoint):
                continue
            br = self._breaker(endpoint)
            try:
                status, _h, data = self._with_retries(
                    endpoint,
                    lambda attempt: self._request(
                        endpoint, "GET", f"/stores/{self.store}/"),
                    "<list>")
            except _TransportError:
                br.record_failure()
                continue
            br.record_success()
            if status == 200:
                return sorted(json.loads(data))
        raise _integrity.StoreUnavailableError(
            "could not list store names on any endpoint",
            source=self.describe())

    def describe(self) -> str:
        return f"{self.endpoints[0]}/stores/{self.store}"


# ---------------------------------------------------------------------------
# URL plumbing: job specs / CLI carry one string
# ---------------------------------------------------------------------------

def is_store_url(target) -> bool:
    return isinstance(target, str) and \
        target.startswith(("http://", "https://"))


def backend_from_url(url: str, cache: ChunkCache | None = None,
                     breakers=None) -> HttpStoreBackend:
    """Build a hardened backend from a store URL::

        http://host:port/stores/<name>[?mirror=/local/store&...]

    Query knobs (all optional, so a fleet job spec can carry the whole
    remote-read policy in its one trajectory string): ``mirror``
    (local mirror directory), ``retries``, ``timeout_s``,
    ``backoff_s``, ``hedge_s``, ``breaker_threshold``,
    ``breaker_cooldown_s``.
    """
    u = urlsplit(url)
    parts = [p for p in u.path.split("/") if p]
    if len(parts) != 2 or parts[0] != "stores":
        raise ValueError(
            f"store URL must look like http://host:port/stores/NAME, "
            f"got {url!r}")
    q = {k: v[-1] for k, v in parse_qs(u.query).items()}
    opts: dict = {}
    if "mirror" in q:
        opts["mirror"] = q["mirror"]
    for knob, conv in (("retries", int), ("timeout_s", float),
                       ("backoff_s", float), ("hedge_s", float),
                       ("breaker_threshold", int),
                       ("breaker_cooldown_s", float)):
        if knob in q:
            opts[knob] = conv(q[knob])
    endpoint = f"{u.scheme}://{u.netloc}"
    return HttpStoreBackend(endpoint, store=parts[1], cache=cache,
                            breakers=breakers, **opts)


def open_remote_store(url: str, n_atoms: int | None = None,
                      cache: ChunkCache | None = None, breakers=None):
    """A :class:`~mdanalysis_mpi_tpu_torch.io.store.reader.StoreReader` over
    a store URL — what ``trajectory_files.open`` dispatches to, so a
    fleet job spec's trajectory can be a remote store the same way it
    can be an ingested directory."""
    from mdanalysis_mpi_tpu_torch.io.store.reader import StoreReader

    backend = backend_from_url(url, cache=cache, breakers=breakers)
    return StoreReader(url, n_atoms=n_atoms, backend=backend)


def remote_store_meta(url: str) -> dict | None:
    """Verified manifest for a store URL, or None when it cannot be
    fetched right now — the fleet controller's routing accessor
    (chunk-aligned shard windows) must degrade to un-chunked sharding,
    not fail the submit, when the remote tier is briefly dark."""
    from mdanalysis_mpi_tpu_torch.io.store.manifest import load_manifest

    try:
        return load_manifest(backend_from_url(url))
    except (_integrity.IntegrityError, OSError):
        return None


# ---------------------------------------------------------------------------
# the in-process fixture service (tests, smoke, bench)
# ---------------------------------------------------------------------------

class ServerFault:
    """One armed server-side fault, deterministic like
    :class:`~mdanalysis_mpi_tpu_torch.reliability.faults.FaultSpec` (visit
    counters, no randomness).

    ``kind``
        ``"http_5xx"`` (answer ``status``), ``"stall"`` (sleep
        ``stall_s`` before answering — longer than the client deadline
        means a client-side timeout), ``"reset"`` (close the socket
        without a response), ``"truncate"`` (declare the full
        Content-Length, send ``truncate_at`` bytes, close), or
        ``"corrupt"`` (flip one payload byte — the content address no
        longer matches).
    ``method`` / ``match``
        Only requests with this verb whose path contains ``match``
        fire the fault (empty matches everything).
    ``after`` / ``times``
        Skip ``after`` matching requests, then fire at most ``times``
        (None = every match) — deterministic mid-wave placement.
    """

    KINDS = ("http_5xx", "stall", "reset", "truncate", "corrupt")

    def __init__(self, kind: str, *, method: str = "GET",
                 match: str = "", after: int = 0,
                 times: int | None = 1, status: int = 503,
                 stall_s: float = 0.2, truncate_at: int = 64):
        if kind not in self.KINDS:
            raise ValueError(f"unknown server fault kind {kind!r}")
        self.kind = kind
        self.method = method
        self.match = match
        self.after = int(after)
        self.times = times
        self.status = int(status)
        self.stall_s = float(stall_s)
        self.truncate_at = int(truncate_at)
        self.visits = 0
        self.fired = 0


class ChunkServer:
    """In-process chunk service over a local directory (the
    ``statusd`` pattern: stdlib ``ThreadingHTTPServer``, daemon serve
    thread, ephemeral port) — the deterministic test double for a real
    object-store tier, with :class:`ServerFault` injection riding the
    real socket so the client's timeout/5xx/reset/truncated/corrupt
    handling is exercised end to end.

    Layout under ``root``: ``stores/<store>/<name>`` for mutable
    objects, ``cas/<name>`` for content-addressed chunks.  CAS PUTs
    are digest-verified (422 on mismatch — poison never enters the
    shared namespace) and deduplicated: re-putting an existing object
    is acknowledged without a write (``dedup_puts`` counts them, and
    ``cas_bytes_written`` proves a second tenant's identical ingest
    moved zero chunk bytes)."""

    def __init__(self, root: str, bind_host: str = "127.0.0.1",
                 port: int = 0):
        self.root = os.fspath(root)
        os.makedirs(os.path.join(self.root, "cas"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "stores"), exist_ok=True)
        self._lock = threading.Lock()
        self._faults: list[ServerFault] = []
        self.requests = 0
        self.put_requests = 0
        self.dedup_puts = 0
        self.cas_bytes_written = 0
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):    # quiet: tests, not stderr
                pass

            def do_GET(self):
                outer._handle(self, "GET")

            def do_HEAD(self):
                outer._handle(self, "HEAD")

            def do_PUT(self):
                outer._handle(self, "PUT")

            def do_DELETE(self):
                outer._handle(self, "DELETE")

        self._server = ThreadingHTTPServer((bind_host, port), _Handler)
        self._server.daemon_threads = True
        self.address = self._server.server_address
        self.url = f"http://{self.address[0]}:{self.address[1]}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="mdtpu-chunkd")
        self._thread.start()

    def store_url(self, store: str, **query) -> str:
        """The one-string client target for ``store`` (optionally with
        policy query knobs — see :func:`backend_from_url`)."""
        qs = "&".join(f"{k}={v}" for k, v in query.items())
        return f"{self.url}/stores/{store}" + (f"?{qs}" if qs else "")

    # ---- fault schedule ----

    def inject(self, *faults: ServerFault) -> None:
        with self._lock:
            self._faults.extend(faults)

    def clear_faults(self) -> None:
        with self._lock:
            self._faults.clear()

    def _match_fault(self, method: str, path: str) -> ServerFault | None:
        with self._lock:
            for f in self._faults:
                if f.method != method or f.match not in path:
                    continue
                f.visits += 1
                if f.visits <= f.after:
                    continue
                if f.times is not None and f.fired >= f.times:
                    continue
                f.fired += 1
                return f
        return None

    # ---- storage ----

    def _fs_path(self, path: str) -> str | None:
        parts = [p for p in path.split("/") if p]
        if len(parts) == 2 and parts[0] == "cas":
            return os.path.join(self.root, "cas", parts[1])
        if len(parts) == 3 and parts[0] == "stores":
            return os.path.join(self.root, "stores", parts[1],
                                parts[2])
        return None

    def _handle(self, handler, method: str) -> None:
        path = handler.path.split("?", 1)[0]
        with self._lock:
            self.requests += 1
        fault = self._match_fault(method, path)
        if fault is not None and fault.kind == "http_5xx":
            self._send(handler, fault.status,
                       json.dumps({"error": "injected"}).encode())
            return
        if fault is not None and fault.kind == "reset":
            # no response at all: the client sees a dropped connection
            try:
                handler.connection.close()
            except OSError:
                pass
            return
        if fault is not None and fault.kind == "stall":
            time.sleep(fault.stall_s)
        try:
            self._dispatch(handler, method, path, fault)
        except BrokenPipeError:
            pass                     # client gave up mid-response

    def _dispatch(self, handler, method: str, path: str,
                  fault) -> None:
        parts = [p for p in path.split("/") if p]
        # listing: GET /stores/<store>/ (or no trailing slash)
        if method == "GET" and len(parts) == 2 \
                and parts[0] == "stores":
            d = os.path.join(self.root, "stores", parts[1])
            names = sorted(os.listdir(d)) if os.path.isdir(d) else []
            self._send(handler, 200, json.dumps(names).encode())
            return
        fsp = self._fs_path(path)
        if fsp is None:
            self._send(handler, 400,
                       json.dumps({"error": f"bad path {path!r}"})
                       .encode())
            return
        if method in ("GET", "HEAD"):
            if not os.path.exists(fsp):
                self._send(handler, 404, b"", head=(method == "HEAD"))
                return
            with open(fsp, "rb") as f:
                body = f.read()
            status = 200
            rng = handler.headers.get("Range")
            if rng is not None and method == "GET":
                status, body = self._slice(handler, rng, body)
                if body is None:
                    return              # 416 already sent
            if fault is not None and fault.kind == "corrupt":
                mut = bytearray(body)
                if mut:
                    mut[len(mut) // 2] ^= 0x40
                body = bytes(mut)
            if fault is not None and fault.kind == "truncate":
                self._send_truncated(handler, body,
                                     fault.truncate_at)
                return
            self._send(handler, status, body,
                       head=(method == "HEAD"))
            return
        if method == "PUT":
            clen = int(handler.headers.get("Content-Length", "0"))
            body = handler.rfile.read(clen)
            with self._lock:
                self.put_requests += 1
            digest = codec.cas_digest(os.path.basename(fsp))
            if path.startswith("/cas/"):
                if digest is None or \
                        codec.payload_digest(body) != digest:
                    self._send(handler, 422, json.dumps(
                        {"error": "payload does not match its "
                                  "content address"}).encode())
                    return
                if os.path.exists(fsp):
                    with self._lock:
                        self.dedup_puts += 1
                    self._send(handler, 200, b"")   # dedup: no write
                    return
                with self._lock:
                    self.cas_bytes_written += len(body)
            os.makedirs(os.path.dirname(fsp), exist_ok=True)
            _integrity.atomic_write_bytes(fsp, body, artifact="store")
            self._send(handler, 201, b"")
            return
        if method == "DELETE":
            if path.startswith("/cas/"):
                self._send(handler, 405, b"")       # immutable
                return
            try:
                os.remove(fsp)
            except FileNotFoundError:
                pass
            self._send(handler, 204, b"")
            return
        self._send(handler, 405, b"")

    def _slice(self, handler, rng: str, body: bytes):
        try:
            unit, _, span = rng.partition("=")
            lo_s, _, hi_s = span.partition("-")
            if unit.strip() != "bytes" or not lo_s:
                raise ValueError(rng)
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else len(body) - 1
        except ValueError:
            self._send(handler, 400, b"")
            return None, None
        if lo >= len(body):
            handler.send_response(416)
            handler.send_header("Content-Range",
                                f"bytes */{len(body)}")
            handler.send_header("Content-Length", "0")
            handler.end_headers()
            return None, None
        return 206, body[lo:min(hi, len(body) - 1) + 1]

    def _send(self, handler, status: int, body: bytes,
              head: bool = False) -> None:
        try:
            handler.send_response(status)
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            if not head and body:
                handler.wfile.write(body)
        except OSError:
            pass

    def _send_truncated(self, handler, body: bytes,
                        truncate_at: int) -> None:
        """Declare the full length, write a prefix, drop the socket —
        the wire shape of a mid-transfer replica death."""
        try:
            handler.send_response(200)
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body[:max(0, truncate_at)])
            handler.wfile.flush()
        except OSError:
            pass
        try:
            handler.connection.close()
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
