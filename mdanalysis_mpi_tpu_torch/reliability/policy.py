"""Retry / deadline / corrupt-frame policy + graceful degradation (the
JAX package's ``reliability/policy.py``, copied with the package name
rewritten; the degradation chain and the error classification are the
port's own, see :func:`degradation_chain` and :func:`is_degradable`).

The reference script has zero fault tolerance: a crash at frame 9,999
of 10,000 loses everything, and any rank failure deadlocks the
collectives (SURVEY.md §5.4, RMSF.py:110,143).  The task-parallel
MD-analysis literature (Khoshlessan 2019, Paraskevakos 2018) identifies
stragglers and I/O variability as the dominant scaling failure mode, so
retry/timeout/degradation is a performance feature as much as a
correctness one.  This module is the configurable middle layer between
the fault sites (:mod:`mdanalysis_mpi_tpu_torch.reliability.faults`) and the
executors:

- :class:`ReliabilityPolicy` — the knobs (retries, backoff, deadlines,
  corrupt-frame semantics, checkpoint cadence, fallback on/off).
- :class:`ReliabilityRuntime` — one run's live state: the policy plus a
  :class:`ReliabilityReport` accumulating retries, deadline misses,
  dropped frames, and executor fallbacks.  Executors duck-call
  ``runtime.op(site, fn)`` and ``runtime.salvage_block(...)`` — this
  module imports the executors, never the reverse.
- :class:`FallbackChain` — graceful degradation: Mesh → Torch (fused,
  then generic) → Serial on repeated device/staging failure, with a
  logged warning instead of a crash.  On a CUDA device the chain keeps
  to the rungs that launch the hand kernels there (Mesh → Torch): a
  run on the card never finishes on the generic form or on the host.
- :func:`run_resilient` — the implementation behind
  ``AnalysisBase.run(resilient=...)``: wires the chain, and for
  reduction analyses wires :mod:`mdanalysis_mpi_tpu_torch.utils.checkpoint`
  in automatically so a killed run resumes from the last folded
  partials.

Corrupt-frame semantics (the reader-boundary validation): every staged
float32 block (and every cursor read on the serial path) is checked for
non-finite values, absurd coordinates (``|x| > max_abs_coord``), and
truncated shapes.  A bad frame is re-read up to ``max_retries`` times
(transient decode faults heal); a persistently bad frame is then either
skipped — with its index recorded in ``results.reliability`` so users
see exactly which frames were dropped — or aborts the run
(``on_corrupt="abort"``), and more than ``max_dropped_frames`` skips
abort regardless.

Deadlines are *soft*: an op that completes but took longer than
``stage_deadline_s`` is treated as a failed attempt and retried
(staging is idempotent), because preempting a wedged C extension
mid-call from the same thread is not possible; a hard-stuck op is the
watchdog layer's problem, not this one's.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from mdanalysis_mpi_tpu_torch.reliability.faults import (
    DeviceLossError, InjectedTransientError,
)


class DeadlineExceeded(RuntimeError):
    """An op (staging / transfer) repeatedly blew its soft deadline."""


class CorruptFrameError(RuntimeError):
    """A persistently corrupt frame under ``on_corrupt="abort"`` (or
    the ``max_dropped_frames`` budget ran out)."""

    def __init__(self, message, frames=()):
        super().__init__(message)
        self.frames = tuple(frames)


#: OSError subclasses that are deterministic, not flaky — a retry can
#: only burn the backoff budget before failing identically
_NON_TRANSIENT_OS = (FileNotFoundError, IsADirectoryError,
                     NotADirectoryError, PermissionError)


def _device_errors() -> tuple:
    """The explicit device-failure types of this torch: out of device
    memory, and ``torch.AcceleratorError`` (an asynchronous CUDA error
    surfacing at a later call) where this torch has it."""
    import torch

    errs = (torch.cuda.OutOfMemoryError,)
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(accel, type):
        errs += (accel,)
    return errs


def _is_transient(exc: BaseException) -> bool:
    """Retry-worthy?  Transient I/O, device loss, deadline misses and
    the device-failure types of :func:`_device_errors`; never a
    programming error (ValueError & co.), a deterministic filesystem
    error (missing/unreadable path), a kernel build failure or a
    refused kernel launch (the same launch is refused again)."""
    if isinstance(exc, (InjectedTransientError, DeviceLossError,
                        DeadlineExceeded)):
        return True
    if isinstance(exc, OSError):
        return not isinstance(exc, _NON_TRANSIENT_OS)
    return isinstance(exc, _device_errors())


def is_degradable(exc: BaseException) -> bool:
    """Should this failure demote the run to the next executor in the
    chain?  Keyed on explicit types (the JAX package keys on the names
    of XLA's runtime errors): device loss, exhausted transients,
    blown deadlines, out of device memory and ``torch.AcceleratorError``.
    Never a kernel that fails to build or launch
    (:class:`~mdanalysis_mpi_tpu_torch._build.KernelBuildError`,
    :class:`~mdanalysis_mpi_tpu_torch._build.KernelLaunchError`: the
    next rung would do the work without the kernel, so a resilient run
    raises them), corrupt data or a programming error — a slower
    backend would just hit them again."""
    from mdanalysis_mpi_tpu_torch._build import (KernelBuildError,
                                                 KernelLaunchError)

    if isinstance(exc, (KernelBuildError, KernelLaunchError)):
        return False
    return isinstance(exc, (DeviceLossError, DeadlineExceeded,
                            InjectedTransientError) + _device_errors())


@dataclasses.dataclass
class ReliabilityPolicy:
    """Knobs for resilient execution (see the module docstring).

    Pass an instance as ``run(resilient=policy)`` — or ``resilient=True``
    for these defaults — or hand it to an executor directly via
    ``run(backend="torch", reliability=ReliabilityRuntime(policy))``.
    """

    #: per-op retry budget (staging, transfer, kernel dispatch, and the
    #: per-frame corrupt re-read all share this number)
    max_retries: int = 2
    #: exponential backoff: sleep ``backoff_s * backoff_factor**k``
    #: before retry k+1
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    #: soft per-op deadline for host staging and host→device transfer
    #: (None = no deadline); an attempt finishing late counts as failed
    stage_deadline_s: float | None = None
    #: validate staged frames (NaN / |x| > max_abs_coord / truncation)
    validate_frames: bool = True
    max_abs_coord: float = 1e6
    #: after retries, a still-corrupt frame is "skip" (recorded) or
    #: "abort" (raise CorruptFrameError)
    on_corrupt: str = "skip"
    #: abort anyway once this many frames were dropped (None = no cap)
    max_dropped_frames: int | None = None
    #: executor degradation Mesh → Torch → Serial on repeated failure
    #: (on a CUDA device Mesh → Torch: :func:`degradation_chain`)
    fallback: bool = True
    #: auto-checkpoint reduction analyses (utils/checkpoint.py) so a
    #: killed run resumes from the last folded partials
    checkpoint: bool = True
    checkpoint_every: int = 4096
    #: explicit checkpoint file; None derives a stable per-run path
    checkpoint_path: str | None = None
    #: directory for derived paths ($MDTPU_CHECKPOINT_DIR, else tempdir)
    checkpoint_dir: str | None = None

    def __post_init__(self):
        if self.on_corrupt not in ("skip", "abort"):
            raise ValueError(
                f"on_corrupt must be 'skip' or 'abort', got "
                f"{self.on_corrupt!r}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")


class ReliabilityReport:
    """What actually happened during a resilient run: retries per site,
    deadline misses, dropped frames, executor fallbacks.  Attached to
    ``results.reliability`` as a plain dict (npz/JSON-friendly)."""

    def __init__(self):
        self.retries: dict[str, int] = {}
        self.deadline_misses = 0
        self.dropped_frames: list[int] = []
        self.healed_frames: list[int] = []
        self.fallbacks: list[tuple[str, str, str]] = []

    def note_retry(self, site: str) -> None:
        self.retries[site] = self.retries.get(site, 0) + 1

    def note_fallback(self, from_name: str, to_name: str,
                      reason: BaseException) -> None:
        self.fallbacks.append((from_name, to_name, str(reason)))

    def as_results(self) -> dict:
        return {
            "retries": dict(self.retries),
            "deadline_misses": self.deadline_misses,
            "dropped_frames": np.unique(np.asarray(self.dropped_frames,
                                                   dtype=np.int64)),
            # unique: a frame healed once per pass (or per deadline
            # retry) is still one healed frame
            "healed_frames": np.unique(np.asarray(self.healed_frames,
                                                  dtype=np.int64)),
            "fallbacks": list(self.fallbacks),
        }


def merge_reliability_results(*reports: dict | None) -> dict:
    """Combine per-pass ``results.reliability`` dicts into one — what
    multi-pass orchestrators (AlignedRMSF) attach to their own results
    so a resilient run's drops/retries/fallbacks stay visible at the
    surface the user actually reads."""
    out: dict = {"retries": {}, "deadline_misses": 0,
                 "dropped_frames": [], "healed_frames": [],
                 "fallbacks": []}
    for r in reports:
        if not r:
            continue
        for site, n in r.get("retries", {}).items():
            out["retries"][site] = out["retries"].get(site, 0) + n
        out["deadline_misses"] += r.get("deadline_misses", 0)
        out["dropped_frames"].extend(
            np.asarray(r.get("dropped_frames", []), dtype=np.int64)
            .tolist())
        out["healed_frames"].extend(
            np.asarray(r.get("healed_frames", []), dtype=np.int64)
            .tolist())
        out["fallbacks"].extend(r.get("fallbacks", []))
    out["dropped_frames"] = np.unique(
        np.asarray(out["dropped_frames"], dtype=np.int64))
    out["healed_frames"] = np.unique(
        np.asarray(out["healed_frames"], dtype=np.int64))
    return out


class ReliabilityRuntime:
    """Policy + per-run report, in the shape the executors consume."""

    def __init__(self, policy: ReliabilityPolicy | None = None):
        self.policy = policy or ReliabilityPolicy()
        self.report = ReliabilityReport()

    # ---- generic op wrapper: retry + backoff + soft deadline ----

    def op(self, site: str, fn):
        """Run ``fn()`` under the policy's retry/backoff/deadline
        envelope for ``site``.  Raises the last failure when the
        budget is exhausted (classification decides what happens
        upstream: degradable failures demote the executor)."""
        pol = self.policy
        deadline = (pol.stage_deadline_s if site in ("stage", "put")
                    else None)
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                out = fn()
            except Exception as exc:
                if not _is_transient(exc) or attempt >= pol.max_retries:
                    raise
                attempt += 1
                self.note_retry(site, exc)
                time.sleep(pol.backoff_s * pol.backoff_factor
                           ** (attempt - 1))
                continue
            if (deadline is not None
                    and time.perf_counter() - t0 > deadline):
                self.report.deadline_misses += 1
                if attempt >= pol.max_retries:
                    raise DeadlineExceeded(
                        f"{site} op exceeded its {deadline}s deadline "
                        f"on {attempt + 1} consecutive attempts")
                attempt += 1
                self.note_retry(site, None)
                continue
            return out

    def note_retry(self, site: str, exc) -> None:
        self.report.note_retry(site)
        from mdanalysis_mpi_tpu_torch.obs import METRICS, span_event
        from mdanalysis_mpi_tpu_torch.utils.log import get_logger

        reason = "deadline miss" if exc is None else type(exc).__name__
        # reliability incidents as trace instants: a retry lands ON the
        # timeline next to the span it delayed (docs/OBSERVABILITY.md)
        span_event("retry", site=site, reason=reason)
        METRICS.inc("mdtpu_retries_total", site=site)
        get_logger("mdtpu.reliability").info(
            "retrying %s op (%s)", site,
            "deadline miss" if exc is None else exc)

    def _note_read_retry(self) -> None:
        """Per-frame salvage re-read bookkeeping: report counter plus
        the observability mirrors (no log line — a long salvage loop
        must not spam INFO)."""
        self.report.note_retry("read")
        from mdanalysis_mpi_tpu_torch.obs import METRICS, span_event

        span_event("retry", site="read", reason="corrupt-or-transient")
        METRICS.inc("mdtpu_retries_total", site="read")

    # ---- corrupt-frame validation + salvage ----

    def _bad_rows(self, block: np.ndarray) -> np.ndarray:
        flat = block.reshape(block.shape[0], -1)
        bad = ~np.isfinite(flat).all(axis=1)
        # NaN rows compare False here, but the isfinite check above
        # already flagged them — no nanmax (and no All-NaN warnings)
        bad |= np.abs(flat).max(axis=1,
                                initial=0.0) > self.policy.max_abs_coord
        return np.flatnonzero(bad)

    def _reread_frame(self, reader, frame: int, sel_idx):
        """Per-frame salvage re-read with validation; returns the
        selected (S, 3) row or None when the frame stays corrupt."""
        n_full = reader.n_atoms
        for attempt in range(self.policy.max_retries + 1):
            if attempt:
                self._note_read_retry()
                time.sleep(self.policy.backoff_s
                           * self.policy.backoff_factor ** (attempt - 1))
            try:
                pos = reader[frame].positions
            except Exception as exc:
                if not _is_transient(exc):
                    raise
                continue
            if pos.shape != (n_full, 3):        # truncated frame
                continue
            row = pos if sel_idx is None else pos[sel_idx]
            if (np.isfinite(row).all()
                    and np.abs(row).max(initial=0.0)
                    <= self.policy.max_abs_coord):
                return row
        return None

    def _record_drop(self, frame: int) -> None:
        if int(frame) in self.report.dropped_frames:
            # a deadline-retried stage op (or a later pass over the
            # same frames) re-salvages the same corrupt frame: one
            # distinct frame charges the max_dropped_frames budget once
            return
        self.report.dropped_frames.append(int(frame))
        from mdanalysis_mpi_tpu_torch.obs import METRICS, span_event

        span_event("frame_drop", frame=int(frame))
        METRICS.inc("mdtpu_dropped_frames_total")
        pol = self.policy
        from mdanalysis_mpi_tpu_torch.utils.log import get_logger

        get_logger("mdtpu.reliability").warning(
            "dropping corrupt frame %d (%d dropped so far)", frame,
            len(self.report.dropped_frames))
        if (pol.max_dropped_frames is not None
                and len(self.report.dropped_frames)
                > pol.max_dropped_frames):
            raise CorruptFrameError(
                f"dropped {len(self.report.dropped_frames)} corrupt "
                f"frames, over the max_dropped_frames="
                f"{pol.max_dropped_frames} budget",
                frames=self.report.dropped_frames)

    def salvage_block(self, reader, sel_idx, batch_frames, block, boxes,
                      series: bool = False):
        """Validate a staged float block; re-read corrupt frames, then
        skip-with-count or abort per policy.  Returns (block, boxes,
        n_dropped) with persistently-corrupt rows removed (the
        executors' pad+mask machinery absorbs the shorter block;
        ``n_dropped > 0`` also tells them the block must not be cached
        — a cache hit would skip salvage in a later run and leave that
        run's report blind to the missing frames)."""
        bad = self._bad_rows(block)
        if len(bad) == 0:
            return block, boxes, 0
        drop = []
        for j in bad:
            frame = int(batch_frames[j])
            row = self._reread_frame(reader, frame, sel_idx)
            if row is not None:
                block[j] = row
                self.report.healed_frames.append(frame)
                continue
            if self.policy.on_corrupt == "abort":
                raise CorruptFrameError(
                    f"frame {frame} is corrupt (non-finite / truncated "
                    "/ out-of-range coordinates) and on_corrupt='abort'",
                    frames=[frame])
            if series:
                # a batch time-series output is positional: silently
                # removing a row would misalign every later frame
                # against results.frames — refuse instead of lying
                raise CorruptFrameError(
                    f"frame {frame} is corrupt and cannot be skipped "
                    "from a batched time-series analysis (positional "
                    "output); run with backend='serial' or "
                    "on_corrupt='abort'", frames=[frame])
            drop.append(j)
            self._record_drop(frame)
        if drop:
            keep = np.setdiff1d(np.arange(block.shape[0]), drop)
            block = block[keep]
            if boxes is not None:
                boxes = boxes[keep]
        return block, boxes, len(drop)

    def read_frame(self, reader, frame: int):
        """Serial-path read with validation: a Timestep, or None when
        the frame was skipped per policy."""
        pol = self.policy
        n_full = reader.n_atoms
        for attempt in range(pol.max_retries + 1):
            if attempt:
                self._note_read_retry()
                time.sleep(pol.backoff_s
                           * pol.backoff_factor ** (attempt - 1))
            try:
                ts = reader[frame]
            except Exception as exc:
                if not _is_transient(exc):
                    raise
                continue
            if not pol.validate_frames:
                return ts
            pos = ts.positions
            if (pos.shape == (n_full, 3) and np.isfinite(pos).all()
                    and np.abs(pos).max(initial=0.0)
                    <= pol.max_abs_coord):
                if attempt:
                    self.report.healed_frames.append(int(frame))
                return ts
        if pol.on_corrupt == "abort":
            raise CorruptFrameError(
                f"frame {frame} is corrupt (non-finite / truncated / "
                "out-of-range coordinates) and on_corrupt='abort'",
                frames=[frame])
        self._record_drop(frame)
        return None


class FallbackChain:
    """Executor chain with graceful degradation: run on the first
    executor; on a degradable failure (device loss, exhausted
    transients, blown deadlines) log a warning and demote to the next
    — Mesh → Torch → Serial, on the card Mesh → Torch
    (:func:`degradation_chain`) — instead of crashing.  Non-degradable
    failures (corrupt data, programming errors) propagate unchanged."""

    name = "resilient"

    def __init__(self, executors, runtime: ReliabilityRuntime | None = None):
        if not executors:
            raise ValueError("FallbackChain needs at least one executor")
        self._chain = list(executors)
        self._runtime = runtime
        # sticky demotion floor: once a member is demoted away from,
        # later execute() calls (run_checkpointed chunks) start at the
        # member that last worked instead of re-burning the dead
        # member's retry/backoff budget every chunk
        self._floor = 0

    @property
    def per_call_partials(self) -> bool:
        # checkpointable only when EVERY member returns per-call
        # partials (a serial member accumulates inside the analysis and
        # would double-count across chunks)
        return all(getattr(e, "per_call_partials", False)
                   for e in self._chain)

    def execute(self, analysis, reader, frames, batch_size=None):
        from mdanalysis_mpi_tpu_torch.utils.log import get_logger, log_event

        # resolve skips BEFORE iterating: ring (mesh-only) kernels
        # cannot run single-device, and the "last member" that must
        # re-raise has to be the last RUNNABLE member — a trailing
        # skip would otherwise fall off the loop end
        chain = [ex for ex in self._chain
                 if not (getattr(analysis, "_mesh_only", False)
                         and type(ex).__name__ == "TorchExecutor")]
        if not chain:
            chain = self._chain
        last = len(chain) - 1
        for k, ex in enumerate(chain):
            if k < min(self._floor, last):
                continue            # demoted away from in a prior call
            try:
                return ex.execute(analysis, reader, frames,
                                  batch_size=batch_size)
            except Exception as exc:
                if k == last or not is_degradable(exc):
                    raise
                self._floor = k + 1
                nxt = chain[k + 1]
                get_logger("mdtpu.reliability").warning(
                    "backend %r failed (%s: %s); degrading to %r",
                    getattr(ex, "name", type(ex).__name__),
                    type(exc).__name__, exc,
                    getattr(nxt, "name", type(nxt).__name__))
                log_event("executor_fallback",
                          from_backend=getattr(ex, "name", "?"),
                          to_backend=getattr(nxt, "name", "?"),
                          error=str(exc))
                from mdanalysis_mpi_tpu_torch.obs import METRICS, span_event

                span_event("executor_fallback",
                           from_backend=getattr(ex, "name", "?"),
                           to_backend=getattr(nxt, "name", "?"),
                           error=type(exc).__name__)
                METRICS.inc("mdtpu_executor_fallbacks_total")
                if self._runtime is not None:
                    self._runtime.report.note_fallback(
                        getattr(ex, "name", "?"),
                        getattr(nxt, "name", "?"), exc)
        raise AssertionError("unreachable")


def _on_card(executor) -> bool:
    """Does ``executor`` run on a CUDA device?"""
    devices = (getattr(executor, "devices", None)
               or [getattr(executor, "device", None)])
    return any(getattr(d, "type", None) == "cuda" for d in devices)


def degradation_chain(base, runtime: ReliabilityRuntime):
    """Base executor → the ordered degradation list.

    Off the card: Mesh → Torch → Serial; Torch → Serial; and where a
    Torch rung would run a fused quantized-native kernel (int16, int8
    or delta staging), a second Torch rung with
    ``use_quantized_native=False`` after it, as in the JAX package.
    Anything else (serial, mpi, custom instances) degrades straight to
    Serial unless it IS serial.  On a CUDA device: Mesh → Torch, and
    nothing after — the generic rung and Serial would finish the work
    without the hand kernels, so a run on the card that exhausts its
    device rungs raises instead.  Fallback executors inherit the base's
    batch geometry, device, transfer dtype, prestage and ``scan_k`` but
    not its block cache (its keys are namespaced per batch size and
    devices, and a failed device's blocks are gone anyway).
    """
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        MeshExecutor, SerialExecutor, TorchExecutor,
    )

    base.reliability = runtime
    chain = [base]
    torch_rung = base if isinstance(base, TorchExecutor) else None
    if isinstance(base, MeshExecutor):
        torch_rung = TorchExecutor(batch_size=base.batch_size,
                                   device=base.devices[0],
                                   transfer_dtype=base.transfer_dtype,
                                   prestage=base.prestage,
                                   scan_k=base.scan_k,
                                   reliability=runtime)
        chain.append(torch_rung)
    if _on_card(base):
        return chain
    if (torch_rung is not None
            and torch_rung.transfer_dtype in ("int16", "int8", "delta")
            and getattr(torch_rung, "use_quantized_native", True)):
        chain.append(TorchExecutor(batch_size=torch_rung.batch_size,
                                   device=torch_rung.device,
                                   transfer_dtype=torch_rung.transfer_dtype,
                                   prestage=torch_rung.prestage,
                                   scan_k=torch_rung.scan_k,
                                   use_quantized_native=False,
                                   reliability=runtime))
    if not isinstance(base, SerialExecutor):
        chain.append(SerialExecutor(reliability=runtime))
    return chain


def run_resilient(analysis, policy: ReliabilityPolicy, *, start=None,
                  stop=None, step=None, frames=None,
                  backend: str = "torch", batch_size: int | None = None,
                  **executor_kwargs):
    """The engine behind ``AnalysisBase.run(resilient=...)``.

    Builds the degradation chain around the requested backend and — for
    reduction analyses on a batch backend — routes execution through
    :func:`mdanalysis_mpi_tpu_torch.utils.checkpoint.run_checkpointed` so an
    interrupted run resumes from the last folded partials.  If the
    whole batch chain gives up (persistent device/staging failure), a
    run off the card completes on the serial oracle instead of raising;
    a run on a CUDA device raises (:func:`degradation_chain`).  The
    :class:`ReliabilityReport` lands in ``results.reliability``.
    """
    from mdanalysis_mpi_tpu_torch.parallel.executors import get_executor

    runtime = ReliabilityRuntime(policy)
    base = get_executor(backend, **executor_kwargs)
    # remember any pre-existing INSTANCE runtime so a user-supplied
    # executor can be restored on exit — leaving this run's runtime
    # attached would make a later non-resilient run through the same
    # instance silently salvage frames into a dead, never-read report
    prev_runtime = base.__dict__.get("reliability")
    base.reliability = runtime
    try:
        _run_resilient_body(analysis, policy, runtime, base,
                            batch_size=batch_size, start=start,
                            stop=stop, step=step, frames=frames)
    finally:
        if prev_runtime is None:
            base.__dict__.pop("reliability", None)
        else:
            base.reliability = prev_runtime
    analysis.results.reliability = runtime.report.as_results()
    return analysis


def _run_resilient_body(analysis, policy, runtime, base, *, batch_size,
                        start, stop, step, frames):
    from mdanalysis_mpi_tpu_torch.parallel.executors import SerialExecutor
    from mdanalysis_mpi_tpu_torch.utils.log import get_logger

    chain = (degradation_chain(base, runtime) if policy.fallback
             else [base])
    window = dict(start=start, stop=stop, step=step, frames=frames)

    # per_call_partials first: a mixed AnalysisCollection RAISES on
    # _device_fold_fn access, and on a serial/mpi base the question
    # must never even be asked
    use_checkpoint = (
        policy.checkpoint
        and getattr(base, "per_call_partials", False)
        and analysis._device_fold_fn is not None)
    if use_checkpoint:
        from mdanalysis_mpi_tpu_torch.utils import checkpoint as ckpt

        batch_chain = FallbackChain(
            [e for e in chain
             if getattr(e, "per_call_partials", False)], runtime)
        try:
            ckpt.run_checkpointed(
                analysis, path=policy.checkpoint_path,
                chunk_frames=policy.checkpoint_every,
                checkpoint_dir=policy.checkpoint_dir,
                backend=batch_chain, batch_size=batch_size, **window)
        except Exception as exc:
            if not (policy.fallback and is_degradable(exc)) or _on_card(
                    base):
                raise
            get_logger("mdtpu.reliability").warning(
                "batch executor chain gave up (%s: %s); completing on "
                "the serial oracle without checkpointing",
                type(exc).__name__, exc)
            last_batch = batch_chain._chain[-1]
            runtime.report.note_fallback(
                getattr(last_batch, "name", "?"), "serial", exc)
            # resolve the stale-checkpoint path NOW, while
            # _frame_indices still holds the full window
            # run_checkpointed fingerprinted — the serial run below
            # may shrink it (skip-with-count), which would derive a
            # different filename and strand the real file
            stale = policy.checkpoint_path or ckpt.checkpoint_path(
                analysis, list(analysis._frame_indices),
                checkpoint_dir=policy.checkpoint_dir)
            analysis.run(backend=SerialExecutor(reliability=runtime),
                         **window)
            # the checkpointed partials cover a window the serial run
            # just recomputed whole — a stale file must not seed a
            # future resume
            if os.path.exists(stale):
                os.remove(stale)
    elif len(chain) > 1:
        analysis.run(backend=FallbackChain(chain, runtime),
                     batch_size=batch_size, **window)
    else:
        analysis.run(backend=base, batch_size=batch_size, **window)
