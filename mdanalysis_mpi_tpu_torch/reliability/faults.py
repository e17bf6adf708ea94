"""Deterministic fault injection at named sites.

The recovery machinery in :mod:`mdanalysis_mpi_tpu_torch.reliability.policy`
(retry/backoff, corrupt-frame salvage, executor degradation, resume)
only earns trust if every path is exercisable on CPU without real
hardware faults.  This module is the lever: production code calls
:func:`fire` at a handful of named sites, and tests arm
:class:`FaultSpec` s that make those sites raise, stall, or corrupt the
data flowing through them — deterministically (visit counters, no
randomness), so a failing recovery test replays bit-for-bit.

Sites (the complete set — grep for ``_faults.fire``):

``"read"``
    Per-frame cursor read (``ReaderBase.__getitem__``), the serial
    oracle path and the policy layer's per-frame salvage re-read.
    Payload: the frame's ``(n_atoms, 3)`` positions.
``"stage"``
    Host-side block staging in the batch executors
    (``executors._run_batches._host_stage``), after decode+gather and
    before quantization.  Payload: the float32 ``(B, S, 3)`` block;
    ``frames`` carries the batch's frame indices so a spec can corrupt
    one frame's row.
``"put"``
    Host→device transfer (``executors._run_batches._place``).  No
    payload — raise/stall only.
``"kernel"``
    Batch-kernel dispatch (``executors._run_batches.consume``).  No
    payload — raise (device-loss-shaped) / stall.  A ``stall`` spec
    with ``stall_s`` past a scheduler lease TTL is the canonical
    "hung dispatch" injection (docs/RELIABILITY.md, serving
    supervision).
``"worker"``
    Scheduler worker boundary (``service.scheduler.Scheduler._worker``,
    right after a batch claim).  No payload.  The process-level site:
    the default exception is :class:`InjectedWorkerDeath`, a
    ``BaseException`` nothing in the run layers catches, so the worker
    THREAD dies with its lease held — the supervisor's reap path.  A
    ``stall`` spec here is a wedged claim loop instead.
``"probe"``
    Circuit-breaker half-open probe
    (``service.scheduler.Scheduler._probe_backend``), fired before the
    warmup-shaped no-op dispatch.  No payload — raise (device-loss,
    the default) keeps the breaker open; not firing lets the probe
    succeed and close it.
``"remote"``
    Remote-store request boundary
    (``io/store/remote.py HttpStoreBackend._request``), fired before
    every HTTP round trip.  No payload — raise (transient, the
    default: the shape of a refused connection the client never even
    started) / stall.  SERVER-side failures — timeouts, 5xx,
    connection resets, truncated bodies, corrupt payloads — are
    injected by the :class:`~mdanalysis_mpi_tpu_torch.io.store.remote.
    ChunkServer` fixture's own deterministic schedule instead (they
    must traverse the real socket to exercise the client's error
    mapping), so this site covers the client half only.
``"bitflip"``
    Silent-data-corruption injection on the host→device wire
    (``executors._run_batches._place``), fired AFTER the stage-time
    integrity fingerprint is computed and BEFORE the device transfer
    — so the cached device copy is corrupt while the recorded
    fingerprint describes the clean bytes, exactly the SDC shape the
    ``DeviceBlockCache.scrub`` pass exists to catch
    (docs/RELIABILITY.md §5).  Payload: the block's primary staged
    array; the default action is ``corrupt="bitflip"`` — ONE flipped
    high bit in element 0, deterministic and sign-bit-sized so parity
    tests see it loudly if it ever reaches a result.

When no specs are armed, the per-call overhead at a site is one module
attribute load and a truthiness check (``if _faults.plans(): ...``).

Exception taxonomy (what the policy layer keys off):

- :class:`InjectedTransientError` — retryable AND degradable: the
  shape of flaky I/O or a wedged staging client.
- :class:`DeviceLossError` — retryable and degradable: the shape of
  XLA device loss (the message carries ``DEVICE_LOST``, matching how
  real ``XlaRuntimeError`` s print).
- :class:`InjectedCrash` — neither: simulates a process-killing bug so
  checkpoint/resume can be tested (nothing may swallow it).
- :class:`InjectedWorkerDeath` — a ``BaseException``: simulates a
  worker thread dying mid-claim (the scheduler supervisor, not any
  retry envelope, is what must recover from it).
"""

from __future__ import annotations

import threading
import time

import numpy as np


class InjectedTransientError(RuntimeError):
    """Injected failure that retry is expected to heal (flaky I/O)."""


class DeviceLossError(RuntimeError):
    """Device-loss-shaped failure (``DEVICE_LOST``): retry may heal a
    transient one; a persistent one triggers executor degradation."""


class InjectedCrash(RuntimeError):
    """Injected hard crash: NOT retryable, NOT degradable — stands in
    for the process dying mid-run (checkpoint/resume tests)."""


class InjectedWorkerDeath(BaseException):
    """Injected worker-thread death: a ``BaseException`` so no run- or
    policy-layer ``except Exception`` can swallow it — the thread dies
    with its lease held, exactly like a segfaulting C extension or an
    OOM kill would leave it, and the scheduler SUPERVISOR (lease reap +
    respawn) is the only recovery path."""


_DEFAULT_EXC = {
    "read": InjectedTransientError,
    "stage": InjectedTransientError,
    "put": InjectedTransientError,
    "kernel": DeviceLossError,
    "worker": InjectedWorkerDeath,
    "probe": DeviceLossError,
    "bitflip": InjectedTransientError,
    "remote": InjectedTransientError,
}


class FaultSpec:
    """One armed fault: where it fires, what it does, and when.

    ``site``     one of the documented site names.
    ``kind``     ``"raise"`` | ``"stall"`` | ``"corrupt"``.
    ``frames``   optional container of frame indices: the spec only
                 matches calls touching one of these frames (and
                 corruption applies only to their rows).
    ``after``    skip this many matching visits before firing
                 (deterministic placement: "crash on the 4th batch").
    ``times``    fire at most this many times (None = every match).
    ``exc``      exception class for ``kind="raise"`` (default per
                 site: transient for read/stage/put, device-loss for
                 kernel).
    ``stall_s``  sleep duration for ``kind="stall"``.
    ``corrupt``  ``"nan"`` (row → NaN), ``"garbage"`` (row → 1e9 —
                 trips the max-coordinate sanity check), ``"truncate"``
                 (drop the payload's last row — a short frame;
                 per-frame payloads only), or ``"bitflip"`` (XOR the
                 top bit of element 0's last byte — works on ANY
                 dtype, including quantized int16 blocks, where it is
                 the sign bit: a large, deterministic SDC).
                 ``FaultSpec("bitflip")`` defaults to
                 ``kind="corrupt", corrupt="bitflip"`` — the one
                 corrupting site.
    """

    def __init__(self, site: str, kind: str | None = None, *,
                 frames=None, after: int = 0, times: int | None = 1,
                 exc=None, stall_s: float = 0.05,
                 corrupt: str | None = None):
        # per-site defaults resolved from None sentinels, so an
        # EXPLICIT kind="raise" at the bitflip site stays a raise —
        # only the omitted defaults flip to the site's natural shape
        # (corrupt/bitflip for the SDC site, raise/nan elsewhere)
        if kind is None:
            kind = "corrupt" if site == "bitflip" else "raise"
        if corrupt is None:
            corrupt = "bitflip" if site == "bitflip" else "nan"
        if kind not in ("raise", "stall", "corrupt"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if corrupt not in ("nan", "garbage", "truncate", "bitflip"):
            raise ValueError(f"unknown corruption {corrupt!r}")
        self.site = site
        self.kind = kind
        self.frames = None if frames is None else set(int(f) for f in frames)
        self.after = int(after)
        self.times = times
        self.exc = exc or _DEFAULT_EXC.get(site, InjectedTransientError)
        self.stall_s = float(stall_s)
        self.corrupt = corrupt
        self.visits = 0
        self.fired = 0

    def _matches(self, frame, frames) -> bool:
        if self.frames is None:
            return True
        if frame is not None:
            return int(frame) in self.frames
        if frames is not None:
            return any(int(f) in self.frames for f in frames)
        return False

    def _corrupt_rows(self, frames) -> list[int] | None:
        """Row indices (within the block payload) to corrupt, or None
        for the whole payload."""
        if self.frames is None or frames is None:
            return None
        return [j for j, f in enumerate(frames) if int(f) in self.frames]


# Armed specs.  A plain list guarded by a lock for arm/disarm; fire()
# reads it lock-free (the GIL makes list iteration safe, and tests
# arm/disarm outside the measured region).
_PLANS: list[FaultSpec] = []
_LOCK = threading.Lock()


def plans() -> bool:
    """Truthy when any fault is armed — the hot-path guard."""
    return bool(_PLANS)


def arm(*specs: FaultSpec) -> None:
    with _LOCK:
        _PLANS.extend(specs)


def disarm(*specs: FaultSpec) -> None:
    with _LOCK:
        for s in specs:
            if s in _PLANS:
                _PLANS.remove(s)


def clear() -> None:
    with _LOCK:
        _PLANS.clear()


class inject:
    """Context manager arming ``specs`` for the enclosed block::

        with faults.inject(FaultSpec("kernel", "raise", times=None)):
            analysis.run(resilient=True, backend="mesh")
    """

    def __init__(self, *specs: FaultSpec):
        self.specs = specs

    def __enter__(self):
        arm(*self.specs)
        return self.specs

    def __exit__(self, *exc):
        disarm(*self.specs)
        return False


def _apply_corrupt(spec: FaultSpec, array, frames):
    if array is None:
        return None
    if spec.corrupt == "truncate":
        # short (truncated) frame: only meaningful for per-frame
        # payloads; block payloads lose their last frame row
        return array[:-1]
    if spec.corrupt == "bitflip":
        # one flipped high bit in element 0 — dtype-agnostic (the
        # last byte of a little-endian element is its sign/exponent
        # byte, so the value change is LARGE and any parity check
        # that ever sees it fails loudly)
        out = np.array(array, copy=True)
        flat = out.view(np.uint8).reshape(-1)
        flat[out.dtype.itemsize - 1] ^= 0x80
        return out
    if not np.issubdtype(np.asarray(array).dtype, np.floating):
        # quantized payloads cannot carry NaN; leave them alone (the
        # float32 validation path is where corruption detection lives)
        return array
    value = np.nan if spec.corrupt == "nan" else np.float32(1e9)
    rows = spec._corrupt_rows(frames)
    out = np.array(array, copy=True)
    if rows is None:
        out[...] = value
    else:
        for j in rows:
            out[j] = value
    return out


def fire(site: str, frame=None, frames=None, array=None):
    """Run every armed spec matching ``site`` (and frame filter).

    Returns the (possibly corrupted/replaced) ``array`` payload; may
    raise or sleep instead, per the matching spec's ``kind``.  Visit
    and fire counters advance deterministically per spec.
    """
    for spec in list(_PLANS):
        if spec.site != site or not spec._matches(frame, frames):
            continue
        spec.visits += 1
        if spec.visits <= spec.after:
            continue
        if spec.times is not None and spec.fired >= spec.times:
            continue
        spec.fired += 1
        # observability mirror: an injected fault is a trace instant +
        # counter, exactly like a real incident would be
        from mdanalysis_mpi_tpu_torch.obs import METRICS, span_event

        span_event("fault_injected", site=site, kind=spec.kind)
        METRICS.inc("mdtpu_faults_injected_total", site=site)
        if spec.kind == "raise":
            raise spec.exc(
                f"injected fault at site {site!r} "
                f"(visit {spec.visits}, fire {spec.fired})")
        if spec.kind == "stall":
            time.sleep(spec.stall_s)
        else:
            array = _apply_corrupt(spec, array, frames)
    return array
