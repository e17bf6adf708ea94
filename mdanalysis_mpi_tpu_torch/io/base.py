"""Reader protocol shared by all trajectory backends."""

from __future__ import annotations

import functools
import os
import threading

import numpy as np

from mdanalysis_mpi_tpu_torch.core.timestep import Timestep
from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS
from mdanalysis_mpi_tpu_torch.reliability import faults as _faults
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS


class BlockCache:
    """Byte-capped staged-block cache (shared by the host staging cache
    here and the executors' HBM ``DeviceBlockCache``).

    Policy: insert until ``max_bytes``, then stop (no eviction).  For
    repeated sequential scans — the access pattern of every analysis
    here — keeping the head and re-staging the tail is optimal; FIFO/LRU
    would evict exactly the blocks the next scan needs first.

    Thread safety: every mutation (``put``/``clear``/reservations/
    pinning/eviction) runs under one re-entrant lock.  A single run
    never needed it, but the serving layer
    (:mod:`mdanalysis_mpi_tpu_torch.service`) shares one cache between
    scheduler workers, and unlocked concurrent ``put`` interleavings
    corrupt the byte accounting (two threads both read ``_bytes``
    before either adds) — the thread-safety audit the service PR's
    stress test pins.  ``get`` takes the lock too: the hit/miss
    counters feed serving telemetry and lost updates would skew the
    reported hit rate.

    Multi-tenant hooks (used by the service admission layer; no-ops for
    solo runs):

    - ``reserve(nbytes)`` / ``release(nbytes)`` — admission control:
      a scheduler reserves a job's estimated working set before letting
      it stage into the cache, so concurrently admitted jobs cannot
      jointly overcommit the budget.  Reservations gate *admission
      decisions* only — ``put`` keeps its own byte cap check (an
      estimate is not a contract).
    - ``pin(ns)`` / ``unpin(ns)`` — mark a key namespace (the leading
      key element: the executors' cache keys lead with the reader
      fingerprint) as belonging to a hot tenant.
    - ``evict_unpinned()`` — drop every entry outside the pinned
      namespaces, returning the evicted values so device-backed
      subclasses can release their buffers.  This is the ONLY eviction
      path: the no-eviction policy above still holds for cache-internal
      behavior, and only an explicit admission decision ("make room for
      a queued tenant without touching hot ones") triggers it.
    """

    def __init__(self, max_bytes: int):
        self._store: dict = {}
        self._sizes: dict = {}
        self._bytes = 0
        self._rejected = False
        self._reserved = 0
        self._pinned_ns: set = set()
        self._lock = threading.RLock()
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        # host-side stage-time fingerprints (utils/integrity.py
        # staged_fingerprint), keyed like _store — the SDC scrubber's
        # reference copy (docs/RELIABILITY.md §5).  Entries without
        # one (multi-host slices, pre-integrity callers) are never
        # scrubbed.
        self._fps: dict = {}
        #: high-water mark of stored + reserved bytes — the staged
        #: admission pressure gauge (`mdtpu_staged_bytes_peak`) the
        #: memory watchdog reads
        self.bytes_peak = 0

    def get(self, key):
        with self._lock:
            value = self._store.get(key)
            if value is None:
                self.misses += 1
            else:
                self.hits += 1
            return value

    def put(self, key, value, nbytes: int) -> bool:
        """Insert; returns whether the entry was stored (callers that
        must clean up a rejected value — e.g. the scan superblock
        stacker — branch on this instead of probing the store)."""
        # overwriting a key credits the replaced entry's bytes back
        # first — without this, re-staging the same block (e.g. a
        # resilient run salvaging different bytes) double-counts and
        # silently flips `full`, demoting every later run to re-staging
        with self._lock:
            freed = self._sizes.get(key, 0)
            if self._bytes - freed + nbytes <= self.max_bytes:
                self._store[key] = value
                self._sizes[key] = nbytes
                self._bytes += nbytes - freed
                # a replaced entry's fingerprint no longer describes
                # the stored value; the caller re-notes the fresh one
                self._fps.pop(key, None)
                self.bytes_peak = max(self.bytes_peak,
                                      self._bytes + self._reserved)
                return True
            # the cache just refused a block: record it, so `full`
            # flips even when _bytes never lands exactly on the cap
            self._rejected = True
            return False

    @property
    def full(self) -> bool:
        """True once the cache has stopped accepting blocks — the byte
        cap was reached exactly, OR an insert was rejected for not
        fitting (the common over-cap case: _bytes stays below
        max_bytes forever, so the byte comparison alone never flips).
        Consumers route overflow elsewhere, e.g. the executors hand
        staging back to the host stage cache once the device cache
        stops accepting (executors._run_batches stage selection)."""
        return self._rejected or self._bytes >= self.max_bytes

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._sizes.clear()
            self._fps.clear()
            self._bytes = 0
            self._rejected = False
            self._reserved = 0

    # ---- admission / pinning hooks (service layer) ----

    @property
    def available_bytes(self) -> int:
        """Budget not yet held by stored entries OR outstanding
        reservations — what an admission decision compares a job's
        estimated working set against."""
        with self._lock:
            return max(0, self.max_bytes - self._bytes - self._reserved)

    def reserve(self, nbytes: int) -> bool:
        """Atomically claim ``nbytes`` of budget for a job about to
        stage, or refuse (the scheduler then queues the job instead of
        letting it thrash the cache).  Pair with :meth:`release` when
        the job finishes — the bytes it actually cached are then
        accounted as stored entries."""
        with self._lock:
            if nbytes <= self.max_bytes - self._bytes - self._reserved:
                self._reserved += nbytes
                self.bytes_peak = max(self.bytes_peak,
                                      self._bytes + self._reserved)
                return True
            return False

    def release(self, nbytes: int) -> None:
        with self._lock:
            self._reserved = max(0, self._reserved - nbytes)

    def pin(self, ns) -> None:
        """Pin a key namespace (``key[0]`` for tuple keys — the reader
        fingerprint the executors lead their cache keys with): its
        entries survive :meth:`evict_unpinned`."""
        with self._lock:
            self._pinned_ns.add(ns)

    def unpin(self, ns) -> None:
        with self._lock:
            self._pinned_ns.discard(ns)

    def _key_ns(self, key):
        return key[0] if isinstance(key, tuple) and key else key

    def ns_bytes(self, ns) -> int:
        """Stored bytes under one key namespace — how much of the cache
        a tenant already holds.  Admission uses it to let a RESIDENT
        tenant ride its own entries when a fresh reservation would not
        fit (its prior superblocks are the very budget the reservation
        competes with; denying it would force re-staging blocks that
        are already cached)."""
        with self._lock:
            return sum(size for key, size in self._sizes.items()
                       if self._key_ns(key) == ns)

    def unpinned_bytes(self) -> int:
        """Stored bytes :meth:`evict_unpinned` would reclaim — what an
        admission decision checks BEFORE evicting, so idle tenants'
        staged superblocks are never destroyed when the reclaim could
        not make the reservation fit anyway."""
        with self._lock:
            return sum(size for key, size in self._sizes.items()
                       if self._key_ns(key) not in self._pinned_ns)

    def evict_unpinned(self) -> list:
        """Drop every entry whose namespace is not pinned, crediting
        their bytes back (and un-flipping ``full`` — the cache accepts
        inserts again).  Returns the evicted values; device-backed
        subclasses release the buffers."""
        with self._lock:
            evicted = []
            for key in [k for k in self._store
                        if self._key_ns(k) not in self._pinned_ns]:
                evicted.append(self._store.pop(key))
                self._bytes -= self._sizes.pop(key)
                self._fps.pop(key, None)
            if evicted:
                self._rejected = False
            return evicted

    # ---- SDC-scrub fingerprint hooks (docs/RELIABILITY.md §5) ----

    def note_fingerprint(self, key, fp, expect=None) -> None:
        """Record the host-side stage-time fingerprint of a stored
        entry (``utils.integrity.staged_fingerprint`` tuple).  No-op
        for keys not currently stored — the entry may already have
        been evicted/overwritten by the time the stager gets here.
        ``expect`` (identity-compared, like :meth:`quarantine`) pins
        the fingerprint to the VALUE it describes: a racing same-key
        put must not end up paired with the loser's fingerprint — the
        scrubber would falsely quarantine a clean block."""
        with self._lock:
            if key in self._store and (
                    expect is None or self._store[key] is expect):
                self._fps[key] = tuple(fp)

    def fingerprint(self, key):
        with self._lock:
            return self._fps.get(key)

    def scrub_items(self) -> list:
        """Snapshot of ``(key, value, fingerprint)`` for every stored
        entry that carries a fingerprint — what one scrub pass
        verifies."""
        with self._lock:
            return [(k, self._store[k], self._fps[k])
                    for k in list(self._store) if k in self._fps]

    def quarantine(self, key, expect) -> bool:
        """Drop ``key`` iff it still stores ``expect`` (identity): the
        scrubber's remove path, raced safely against concurrent
        overwrites.  Returns whether the entry was removed; subclasses
        release device buffers on True."""
        with self._lock:
            if self._store.get(key) is not expect:
                return False
            self._store.pop(key)
            self._bytes -= self._sizes.pop(key, 0)
            self._fps.pop(key, None)
            # freed budget: the cache accepts inserts again, so the
            # re-staged replacement block has somewhere to land
            self._rejected = False
            return True


#: Host staged-block cache (``ReaderBase.stage_cached``).
#:
#: The staging pipeline's bottleneck is the single host core: every byte
#: it moves (decode, selection gather, quantize, transfer serialization)
#: is additive wall time.  Re-running an analysis over the same
#: (trajectory, selection) therefore re-pays the full gather+quantize
#: for bytes that have not changed.  The cache keeps the *post-gather*
#: (and post-quantize) host blocks so repeated passes pay only the wire
#: serialization — the same design move as the upstream oracle's
#: ``in_memory=True`` workflow (RMSF.py:12), applied at the staging
#: layer.  Assumes the backing trajectory is immutable (file readers
#: already validate offset indexes by mtime; in-memory readers document
#: it); a reader's ``_host_stage_cache.clear()`` resets.
HostStageCache = BlockCache


#: THE quantization policy numbers, one copy for every tier that
#: quantizes coordinates — the wire formats (``executors.
#: quantize_block``), the readers' fused int16 staging
#: (``ReaderBase.QUANT_TARGET`` below mirrors the int16 entry), and
#: the block store's ingest (docs/STORE.md).  ``QUANT_TARGETS`` is the
#: symmetric-scale target (resolution = max|x| / target);
#: ``QUANT_INT_MAX`` the representable bound overflow checks compare
#: against.  Retuning a target here retunes every tier together — a
#: store ingested under one policy must never be served raw against a
#: reader expecting another.
QUANT_TARGETS = {"int16": 32000.0, "int8": 120.0}
QUANT_INT_MAX = {"int16": 32767.0, "int8": 127.0}


def planar_repack(q: np.ndarray) -> np.ndarray:
    """Repack an interleaved ``(B, S, 3)`` staged block to the planar
    ``(3, B, S)`` component-plane layout the fused kernel
    consumes (ops/fused_planar.py).  The host copy the planar path pays
    where no native pass writes the planes itself (the store, the
    generic reader, int8, the NumPy fallback; a ``MemoryReader``'s and
    an ``XTCReader``'s int16 blocks run none) — on quantized bytes,
    behind the staging boundary, counted in
    ``mdtpu_fused_planar_repacks_total`` and timed as the ``repack``
    phase."""
    from mdanalysis_mpi_tpu_torch import obs

    obs.METRICS.inc("mdtpu_fused_planar_repacks_total")
    with TIMERS.phase("repack"):
        return np.ascontiguousarray(np.moveaxis(q, 2, 0))


_NUMPY_FALLBACK_LOGGED = threading.Event()


def note_numpy_fallback(exc: Exception) -> None:
    """The native gather/quantize failed and NumPy stages the block:
    counted every time, logged once a process (a host without the
    native library stages every block this way, and more slowly)."""
    METRICS.inc("mdtpu_stage_blocks_total", path="numpy")
    if not _NUMPY_FALLBACK_LOGGED.is_set():
        _NUMPY_FALLBACK_LOGGED.set()
        from mdanalysis_mpi_tpu_torch.utils.log import get_logger

        get_logger("mdtpu").warning(
            "native staging unavailable (%s: %s); staging with NumPy",
            type(exc).__name__, exc)


def norm_quantize(quantize) -> str | None:
    """Normalize a staging-quantization request: ``False``/``None`` →
    None, ``True`` → ``"int16"`` (backward compatible), ``"int16"`` /
    ``"int8"`` pass through.  One normalization shared by every reader
    and cache key, so ``True`` and ``"int16"`` can never produce
    distinct cache entries for identical bytes."""
    if not quantize:
        return None
    if quantize is True:
        return "int16"
    if quantize in ("int16", "int8"):
        return quantize
    raise ValueError(
        f"quantize must be a bool, 'int16' or 'int8', got {quantize!r}")


def sel_fingerprint(sel) -> int | None:
    """Content hash of a selection index array — the cache-key component
    shared by the host stage cache and the executors' device block cache
    (a shared key namespace must never serve blocks gathered for a
    different selection)."""
    if sel is None:
        return None
    return hash(np.ascontiguousarray(sel).tobytes())


def _host_stage_cache_bytes() -> int:
    """Host cache cap in bytes (env ``MDTPU_HOST_STAGE_CACHE_MB``;
    0 disables).  Default 4 GB — sized so the flagship working set
    (BASELINE config 2 at stated scale: 10k frames × 50k selected
    atoms × int16 = ~3 GB) fits whole; whatever exceeds the cap is
    simply re-staged, and any host analyzing that workload holds the
    12 GB raw trajectory anyway, so the cache is not the constraint.
    Read per call so tests/benches can toggle it without reloads."""
    return int(float(os.environ.get("MDTPU_HOST_STAGE_CACHE_MB", "4096"))
               * 1e6)


class ReaderBase:
    """Abstract trajectory reader.

    Subclasses implement ``n_frames``, ``n_atoms`` and ``_read_frame(i)``;
    the base provides indexing, iteration, the ``ts`` cursor (the
    reference's ``trajectory.ts``, RMSF.py:80), and a default
    ``read_block`` built on per-frame reads (native readers override it
    with a bulk decode path).
    """

    _ts: Timestep | None = None

    @property
    def n_frames(self) -> int:  # RMSF.py:65
        raise NotImplementedError

    @property
    def n_atoms(self) -> int:   # RMSF.py:89
        raise NotImplementedError

    def _read_frame(self, i: int) -> Timestep:
        raise NotImplementedError

    # Adaptive int16 staging-scale policy (io/xtc.py's fused path and
    # _quantize_staged below must quantize with bit-identical scales):
    # the module-level QUANT_TARGETS int16 entry, ×1.05 drift margin
    # on the previous max, float64 scale arithmetic.
    QUANT_TARGET = QUANT_TARGETS["int16"]
    QUANT_MARGIN = 1.05

    def _quant_hints(self) -> dict:
        """Per-selection max-|coordinate| hints for the adaptive
        one-pass int16 quantizers (scoped per selection content so one
        wide-coordinate selection cannot coarsen another's
        resolution)."""
        return self.__dict__.setdefault("_quant_max_hints", {})

    @property
    def filename(self) -> str | None:
        """Backing file path, or None for non-file readers (the public
        contract consumers like AlignTraj's default-output naming use;
        file-backed subclasses store it as ``_path``)."""
        return getattr(self, "_path", None)

    # ---- on-the-fly transformations (upstream add_transformations) ----

    @property
    def transformations(self) -> tuple:
        return self.__dict__.get("_transformations", ())

    def add_transformations(self, *transformations) -> None:
        """Attach ``ts -> ts`` callables applied to every frame read
        (upstream one-shot contract: set once).  Readers with
        transformations fall back from fused decode→gather fast paths
        to the generic read-transform-gather loop, because a
        transformation may need atoms outside the staged selection."""
        if self.__dict__.get("_transformations"):
            raise ValueError(
                "transformations are already set (upstream contract: "
                "add_transformations can only be called once)")
        self.__dict__["_transformations"] = tuple(transformations)
        # staged-block caches hold UNtransformed data
        self.__dict__.pop("_host_stage_cache", None)
        self._reset_cursor()       # re-read transformed, same frame
        # the cursor re-read above passed one frame through any NEW
        # stateful transformation; clear that seed so the caller's own
        # first read is window frame 1, not a double-counted duplicate
        for t in transformations:
            if getattr(t, "stateful", False):
                t.reset()

    # ---- auxiliary series (upstream add_auxiliary / ts.aux) ----

    @property
    def auxiliaries(self) -> dict:
        return self.__dict__.get("_auxiliaries", {})

    def add_auxiliary(self, name: str, aux, cutoff: float | None = None
                      ) -> None:
        """Attach an auxiliary time series (``auxiliary.XVGReader`` /
        ``ArrayAuxReader``); every subsequently read frame carries
        ``ts.aux.<name>`` = the aux step nearest the frame's time
        (NaNs past ``cutoff`` — never a silently wrong neighbor)."""
        if not hasattr(aux, "value_at"):
            raise TypeError(
                f"aux must provide value_at(time, cutoff) (an "
                f"auxiliary.ArrayAuxReader/XVGReader), got "
                f"{type(aux).__name__}")
        if not name.isidentifier() or hasattr(dict, name):
            # ts.aux is attribute-accessed; a name shadowing a dict
            # method ('values', 'items', ...) would silently return the
            # bound method instead of the data
            raise ValueError(
                f"auxiliary name {name!r} must be a Python identifier "
                "that does not collide with dict attributes")
        auxs = self.__dict__.setdefault("_auxiliaries", {})
        if name in auxs:
            raise ValueError(f"auxiliary {name!r} already attached")
        auxs[name] = (aux, cutoff)
        self._reset_cursor()       # re-read with aux attached, IN PLACE

    def remove_auxiliary(self, name: str) -> None:
        try:
            del self.__dict__["_auxiliaries"][name]
        except KeyError:
            raise ValueError(
                f"no auxiliary {name!r}; attached: "
                f"{sorted(self.auxiliaries)}") from None
        self._reset_cursor()       # drop the stale aux view, IN PLACE

    def _reset_cursor(self) -> None:
        """Invalidate the ts cursor WITHOUT losing the current frame: a
        bare ``_ts = None`` would silently rewind the next ``ts`` access
        to frame 0 — wrong for a user positioned mid-trajectory."""
        cur = None if self._ts is None else self._ts.frame
        self._ts = None
        if cur is not None:
            self[cur]

    def _emit(self, ts: Timestep) -> Timestep:
        for t in self.transformations:
            ts = t(ts)
        return ts

    def _emit_cursor(self, ts: Timestep) -> Timestep:
        """The per-frame CURSOR path: transformations + the auxiliary
        namespace.  Block reads (read_block/stage_block) go through
        plain ``_emit`` — batch kernels never see aux, so building an
        AuxHolder per staged frame would be pure discarded work."""
        ts = self._emit(ts)
        auxs = self.auxiliaries
        if auxs:
            from mdanalysis_mpi_tpu_torch.auxiliary import AuxHolder

            ts.aux = AuxHolder(
                {name: aux.value_at(ts.time, cutoff)
                 for name, (aux, cutoff) in auxs.items()})
        return ts

    # ---- shared behavior ----

    @property
    def ts(self) -> Timestep:
        if self._ts is None:
            self._ts = self._emit_cursor(self._read_frame(0))
        return self._ts

    def __len__(self) -> int:
        return self.n_frames

    def __getitem__(self, i) -> Timestep:
        if isinstance(i, slice):
            raise TypeError("slice indexing not supported; use read_block")
        i = int(i)
        if i < 0:
            i += self.n_frames
        if not 0 <= i < self.n_frames:
            raise IndexError(f"frame {i} out of range [0, {self.n_frames})")
        ts = self._read_frame(i)
        if _faults.plans():
            # "read" fault site (reliability/faults.py): the per-frame
            # cursor read — the serial oracle path and the policy
            # layer's corrupt-frame salvage re-read both land here
            ts.positions = _faults.fire("read", frame=i,
                                        array=ts.positions)
        self._ts = self._emit_cursor(ts)
        return self._ts

    def __iter__(self):
        for i in range(self.n_frames):
            yield self[i]

    def rewind(self) -> Timestep:
        return self[0]

    def read_block(self, start: int, stop: int,
                   sel: np.ndarray | None = None, step: int = 1
                   ) -> tuple[np.ndarray, np.ndarray | None]:
        """Bulk-read frames [start:stop:step] → (positions (B,S,3) f32,
        boxes).

        ``sel`` (optional int index array) gathers a subset of atoms
        during the read — one copy instead of read-then-gather, which
        matters when staging 100k-atom frames for a small selection.
        ``boxes`` is (B, 6) float32 ([lx,ly,lz,alpha,beta,gamma]) or None
        if the trajectory carries no box.  This is the staging primitive
        for host→HBM block transfer (SURVEY.md §7 layer 2).
        """
        if not 0 <= start <= stop <= self.n_frames:
            raise IndexError(f"block [{start},{stop}) out of range [0,{self.n_frames}]")
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        if any(getattr(t, "stateful", False) for t in self.transformations):
            # block/cache schedules are not the sequential cursor a
            # stateful transformation's numbers depend on — two passes
            # could silently disagree; refuse instead
            raise ValueError(
                "stateful transformations (PositionAverager) are "
                "sequential-cursor only; iterate frames with "
                "backend='serial' (block staging would silently change "
                "their output)")
        frames = range(start, stop, step)
        b = len(frames)
        n = self.n_atoms if sel is None else len(sel)
        out = np.empty((b, n, 3), dtype=np.float32)
        boxes = None
        for j, i in enumerate(frames):
            ts = self._emit(self._read_frame(i))
            out[j] = ts.positions if sel is None else ts.positions[sel]
            if ts.dimensions is not None:
                if boxes is None:
                    # zeros, not empty: frames before the first boxed frame
                    # must not leak uninitialized memory
                    boxes = np.zeros((b, 6), dtype=np.float32)
                boxes[j] = ts.dimensions
        return out, boxes

    def frame_times(self, frames) -> np.ndarray | None:
        """Per-frame times for ``frames`` (an iterable of indices), or
        None when the format carries no time metadata the reader can
        fetch without decoding coordinates.  Used by
        ``Universe.transfer_to_memory`` to preserve times."""
        return None

    def stage_block(self, start: int, stop: int,
                    sel: np.ndarray | None = None, quantize=False,
                    layout: str = "interleaved"):
        """Staging primitive: ``read_block`` plus optional fused
        quantization → (block, boxes, inv_scale).

        ``quantize``: False (float32 staging, ``inv_scale`` None), True
        or ``"int16"`` (the default wire format — native C++ fused path
        when available, NumPy fallback), or ``"int8"`` (half the wire
        bytes again; coarse — see ``quantize_block`` for the accuracy
        envelope; NumPy path only).  The first int16 block per
        selection uses the exact per-block scale (bit-identical to the
        NumPy path); later blocks use the adaptive one-pass scale (see
        ``_quantize_staged``) — same resolution class, different bits.

        ``layout``: ``"interleaved"`` (the default ``(B, S, 3)`` block)
        or ``"planar"`` — the ``(3, B, S)`` component-plane form the
        fused kernel consumes (ops/fused_planar.py), produced by
        one ``planar_repack`` on the quantized bytes.  Planar staging
        requires a quantized dtype: the fused path exists to avoid host
        float32 materialization, so float32 planar is a contract error.
        """
        qmode = norm_quantize(quantize)
        if layout == "planar" and qmode is None:
            raise ValueError(
                "layout='planar' requires quantized staging "
                "(int16/int8); float32 blocks stay interleaved")
        with TIMERS.phase("gather"):
            block, boxes = self.read_block(start, stop, sel=sel)
            if qmode is None:
                METRICS.inc("mdtpu_stage_blocks_total", path="generic")
                return block, boxes, None
            if qmode == "int8":
                from mdanalysis_mpi_tpu_torch.staging import quantize_block

                q, inv_scale = quantize_block(block, "int8")
                METRICS.inc("mdtpu_stage_blocks_total", path="numpy")
            else:
                q, inv_scale = self._quantize_staged(
                    block, None, sel_fp=sel_fingerprint(sel))
        if layout == "planar":
            q = planar_repack(q)
        return q, boxes, inv_scale

    def _quantize_staged(self, src: np.ndarray, sel, sel_fp=None,
                         threads: int | None = None):
        """Fused gather + int16 quantize of ``src[:, sel]`` → (q, inv_scale).

        Adaptive one-pass path: after the first block establishes the
        coordinate range, later blocks quantize in a single streaming
        pass against that range (×1.05 margin) via the native
        ``stage_gather_quantize_i16_scaled`` kernel — the separate
        max-abs read pass is what made int16 staging lose to float32 on
        a clean link (VERDICT r1 weak #2).  A block whose true max
        exceeds the margin is detected by the kernel and re-quantized
        exactly (rare: coordinate ranges drift slowly).  Range hints are
        scoped per selection content (``sel_fp``) so one wide-coordinate
        selection cannot coarsen another's resolution on the same
        reader.

        ``threads``: None for the interleaved ``(B, S, 3)`` kernels
        (counted as ``path="native"``); a count for their planar twins,
        which write the ``(3, B, S)`` planes themselves with the frames
        split over that many host threads (the same bytes as
        ``planar_repack`` of the interleaved ones, the same scales and
        hints; counted as ``path="native_planar"``, the count set as the
        ``mdtpu_stage_threads`` gauge).  Falls back to the NumPy
        reference path without the native library, ``planar_repack``
        included for a planar request (counted as ``path="numpy"``,
        logged once).
        """
        try:
            from mdanalysis_mpi_tpu_torch.io import native

            if threads is None:
                scaled, exact = (native.stage_gather_quantize_scaled,
                                 native.stage_gather_quantize)
            else:
                scaled = functools.partial(
                    native.stage_gather_quantize_scaled_planar,
                    threads=threads)
                exact = functools.partial(
                    native.stage_gather_quantize_planar, threads=threads)
            hints = self._quant_hints()
            key = sel_fp if sel_fp is not None else sel_fingerprint(sel)
            hint = hints.get(key, 0.0)
            q = None
            if hint > 0.0:
                scale = self.QUANT_TARGET / (hint * self.QUANT_MARGIN)
                staged, vmax, overflowed = scaled(src, sel, scale)
                if vmax > hint:
                    hints[key] = vmax
                if not overflowed:
                    q, inv_scale = staged, np.float32(1.0 / scale)
            if q is None:
                q, inv_scale = exact(src, sel)
                # the exact kernel's scale encodes the block max: seed
                # the hint
                hints[key] = max(hints.get(key, 0.0),
                                 float(inv_scale) * self.QUANT_TARGET)
        except Exception as exc:
            from mdanalysis_mpi_tpu_torch.staging import quantize_block

            note_numpy_fallback(exc)
            return quantize_block(
                src if sel is None else src[:, sel],
                layout="interleaved" if threads is None else "planar")
        if threads is None:
            METRICS.inc("mdtpu_stage_blocks_total", path="native")
        else:
            METRICS.inc("mdtpu_stage_blocks_total", path="native_planar")
            METRICS.set_gauge("mdtpu_stage_threads", threads)
        return q, inv_scale

    def stage_cached(self, start: int, stop: int,
                     sel: np.ndarray | None = None, quantize=False,
                     layout: str = "interleaved"):
        """``stage_block`` through the reader's :class:`HostStageCache`.

        The executors' staging entry point.  Cache key = (frame window,
        selection content, transfer dtype, layout); the stored blocks
        are treated as immutable by all consumers (pad_batch passes
        full batches through untouched and ``device_put`` only reads).
        Planar blocks cache under a distinct key so the two layouts of
        one window never alias (the scrub fingerprints hash whatever
        bytes were staged, so both layouts scrub independently).
        """
        cap = _host_stage_cache_bytes()
        if cap <= 0:
            return self.stage_block(start, stop, sel=sel, quantize=quantize,
                                    layout=layout)
        cache = self.__dict__.get("_host_stage_cache")
        if cache is None or cache.max_bytes != cap:
            cache = HostStageCache(cap)
            self.__dict__["_host_stage_cache"] = cache
        key = (start, stop, sel_fingerprint(sel), norm_quantize(quantize))
        if layout != "interleaved":
            key = key + (layout,)
        staged = cache.get(key)
        if staged is None:
            staged = self.stage_block(start, stop, sel=sel, quantize=quantize,
                                      layout=layout)
            cache.put(key, staged, staged[0].nbytes)
        return staged

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
