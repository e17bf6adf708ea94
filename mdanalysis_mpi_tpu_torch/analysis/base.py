"""AnalysisBase: the run/prepare/conclude template + backend dispatch.

``run()`` iterates the configured frames and only the inner per-frame
or per-batch compute crosses the executor boundary.  Subclasses
implement:

=====================  ========================================================
``_prepare()``         host setup: selections → index arrays, reference coords
``_single_frame(ts)``  serial oracle path: update host accumulators
``_serial_summary()``  → partials after the serial loop
``_batch_fn()``        → a module-level function ``f(params, batch (B,S,3)
                       f32, boxes (B,6) f32, mask (B,)) -> partials`` on
                       tensors (device path)
``_batch_params()``    → params passed to ``_batch_fn``'s function (the
                       executor moves them to its device)
``_batch_select()``    indices staged to the device (None = all atoms)
``_device_fold_fn``    module-level ``(total, partials) -> total`` merge run
                       on the device once per batch (assign with
                       ``staticmethod(...)``)
``_device_combine``    optional module-level ``(parts, comm) -> partials``
                       merge of one batch's per-device partials for the
                       mesh backend (``parts`` a list, one entry per
                       device shard; ``comm`` the process group's
                       :class:`~mdanalysis_mpi_tpu_torch.parallel.
                       distributed.Collectives` or None); None → the
                       per-device series are concatenated in frame order
``_batch_specs()``     None (frames sharded), or the atom-sharded (ring)
                       layout of params, batch, boxes and mask
``_identity_partials()``  empty-trajectory partials
``_conclude(total)``   partials → ``self.results``
=====================  ========================================================
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.parallel.executors import _tree_to, get_executor


class StreamFeedStalled(RuntimeError):
    """A streaming run's feed stopped growing for longer than its
    stall timeout while still unsealed (docs/STREAMING.md).

    NOT a failure of the analysis: all progress so far is preserved on
    the analysis object (``_stream_state`` carries the fold total and
    the processed-frame cursor), so calling :meth:`AnalysisBase.
    run_streaming` again RESUMES exactly where the feed stalled."""

    def __init__(self, message: str, frames_done: int = 0,
                 waited_s: float = 0.0):
        super().__init__(message)
        self.frames_done = int(frames_done)
        self.waited_s = float(waited_s)


def tree_add(a, b):
    """Elementwise sum over matching tuples/lists — the generic
    ``_device_fold_fn`` for analyses whose partials merge by addition."""
    if isinstance(a, (tuple, list)):
        return type(a)(tree_add(x, y) for x, y in zip(a, b))
    return a + b


def _tree_device(tree):
    """The device of the first tensor leaf of ``tree`` (None if it
    holds no tensor)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, (tuple, list)):
        for x in tree:
            dev = _tree_device(x)
            if dev is not None:
                return dev
    return None


def tree_psum(parts, comm=None):
    """Sum a batch's per-device partials leaf by leaf on the first
    part's device — the generic ``_device_combine`` (the JAX package's
    ``psum`` over the mesh axis, the image of ``comm.Allreduce(MPI.SUM)``,
    RMSF.py:110).  With ``comm`` (a :class:`~mdanalysis_mpi_tpu_torch.
    parallel.distributed.Collectives`), the local sum is then
    all-reduced (SUM) across the process group's ranks."""
    dev = _tree_device(parts[0])
    acc = _tree_to(parts[0], dev)
    for p in parts[1:]:
        acc = tree_add(acc, _tree_to(p, dev))
    if comm is not None:
        acc = comm.all_reduce_tree(acc)
    return acc


def to_numpy(value):
    """A tensor (on any device) → NumPy; anything else as given."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


class Deferred:
    """A result computed (and cached) on first attribute access.

    ``_conclude`` stores one of these instead of fetching device values,
    so ``run()`` performs no device→host read; the fetch happens when
    the user touches ``.results.<key>``.
    """

    __slots__ = ("thunk",)

    def __init__(self, thunk):
        self.thunk = thunk


def _materialize(value):
    if isinstance(value, Deferred):
        return _materialize(value.thunk())
    return to_numpy(value)


def deferred_group(finalize):
    """Deferreds over the keys of one shared memoized ``finalize()``.

    ``finalize`` computes a dict of results in a single (device-fetching)
    pass; ``deferred_group(finalize)["key"]`` is a :class:`Deferred`
    that runs it at most once and picks out ``key``.  The common
    ``_conclude`` shape: several result keys, one readback.
    """
    state = {}

    def _run():
        if not state:
            state.update(finalize())
        return state

    return _DeferredGroup(_run)


class _DeferredGroup(dict):
    """:func:`deferred_group`'s mapping: one class for every group (a
    class made per call is a reference cycle, which would keep the
    results it reaches alive until the cyclic collector runs)."""

    def __init__(self, run):
        super().__init__()
        self._run = run

    def __missing__(self, key):
        run = self._run
        d = Deferred(lambda: run()[key])
        self[key] = d
        return d


def reject_updating_groups(*groups, owner: str) -> None:
    """Loud static-snapshot contract for analyses that read
    ``ag.indices`` at CONSTRUCTION time (and may not retain the group):
    the run()-time scan cannot see a group that was dropped after
    snapshotting, so such constructors must call this first."""
    from mdanalysis_mpi_tpu_torch.core.groups import UpdatingAtomGroup

    for g in groups:
        if isinstance(g, UpdatingAtomGroup):
            raise TypeError(
                f"{owner} snapshots its groups into static index arrays "
                "at construction and cannot track an UpdatingAtomGroup's "
                "per-frame membership; pass a static group")


class Results(dict):
    """Attribute-accessible results container (the ``.results`` idiom of
    the serial oracle, RMSF.py:9-15).

    Attribute access *materializes*: tensors are fetched to NumPy and
    :class:`Deferred` thunks are evaluated, then cached back.  Plain
    ``results["key"]`` indexing returns the raw stored value (device
    tensors stay resident — what multi-pass pipelines want).
    """

    def __getattr__(self, key):
        try:
            value = self[key]
        except KeyError:
            raise AttributeError(
                f"no result {key!r}; available: {sorted(self)}") from None
        materialized = _materialize(value)
        if materialized is not value:
            self[key] = materialized
        return materialized

    def __setattr__(self, key, value):
        self[key] = value

    def materialize(self):
        """Force every entry: evaluate Deferreds, fetch device tensors,
        recurse into nested Results.  Returns self.  One deliberate
        readback point for callers that need plain host values."""
        for key in list(self):
            value = getattr(self, key)
            if isinstance(value, Results):
                value.materialize()
        return self


class AnalysisBase:
    """Template for trajectory analyses with pluggable backends."""

    #: analyses snapshot their selection into a static index array in
    #: _prepare, so a per-frame-re-evaluating UpdatingAtomGroup would
    #: silently freeze at its current membership; run() refuses it
    _accepts_updating_groups = False

    # module-level (total, partials) -> total merge executed on the
    # device once per batch; None → partials are concatenated instead
    _device_fold_fn = None

    # module-level (parts, comm) -> partials merge of the per-device
    # partials of one batch on the mesh backend; None → time series
    _device_combine = None

    # True when the batch function is an atom-sharded ring over the
    # mesh's devices and therefore cannot run on the single-device
    # backend
    _mesh_only = False

    # the backend run() takes when the caller names none
    _default_backend = "torch"

    # True when the batch function waits on the device from the host
    # (GNM's batched eigh checks its solver status): no CUDA graph can
    # capture it, so its cached groups always run eagerly
    _host_waits_in_batch = False

    def __init__(self, universe, verbose: bool = False):
        self._universe = universe
        self._verbose = verbose
        self.results = Results()

    # ---- hooks (see module docstring) ----

    def _prepare(self):
        pass

    def _single_frame(self, ts):
        raise NotImplementedError

    def _serial_summary(self):
        raise NotImplementedError

    def _batch_fn(self):
        raise NotImplementedError(
            f"{type(self).__name__} has no batch kernel; use backend='serial'")

    def _batch_params(self):
        return ()

    def _batch_select(self):
        return None

    def _batch_specs(self):
        """None (the default: frames are sharded over the mesh), or the
        atom-sharded (ring) layout ``(params_specs, batch_spec,
        boxes_spec, mask_spec)``: each the axis a device's block is cut
        along, or None for an array every device holds whole."""
        return None

    def _identity_partials(self):
        raise NotImplementedError

    def _conclude(self, total):
        raise NotImplementedError

    # ---- run ----

    def _refuse_updating_groups(self):
        from mdanalysis_mpi_tpu_torch.core.groups import UpdatingAtomGroup

        # a loop, not a recursive closure: a closure that names itself
        # and ``self`` is a reference cycle that keeps the analysis (its
        # results, device blocks and graphs) alive until the cyclic
        # collector runs, whose pause then lands in a later run
        stack = list(vars(self).values())
        while stack:
            value = stack.pop()
            if isinstance(value, UpdatingAtomGroup):
                raise TypeError(
                    f"{type(self).__name__} snapshots its selection into "
                    "a static index array at _prepare time and cannot "
                    "track an UpdatingAtomGroup's per-frame membership; "
                    "pass a static group")
            if isinstance(value, (tuple, list)):
                stack.extend(value)

    def _frames(self, start, stop, step, frames=None):
        n = self._universe.trajectory.n_frames
        if frames is not None:
            if start is not None or stop is not None or step is not None:
                raise ValueError(
                    "pass either frames= or start/stop/step, not both")
            idx = np.asarray(frames)
            if idx.ndim != 1:
                raise ValueError(f"frames must be 1-D, got shape {idx.shape}")
            if idx.dtype == bool:
                if len(idx) != n:
                    raise ValueError(
                        f"boolean frames mask has {len(idx)} entries for a "
                        f"{n}-frame trajectory")
                return np.flatnonzero(idx).tolist()
            if not np.issubdtype(idx.dtype, np.integer):
                raise TypeError(
                    f"frames must be integer indices or a boolean mask, "
                    f"got dtype {idx.dtype}")
            if len(idx) and (int(idx.min()) < -n or int(idx.max()) >= n):
                raise IndexError(
                    f"frames out of range for {n}-frame trajectory")
            return (idx.astype(np.int64) % n).tolist()
        return range(*slice(start, stop, step).indices(n))

    def _warmup_analyses(self):
        """The analyses whose programs a run of this one dispatches
        (:func:`~mdanalysis_mpi_tpu_torch.parallel.executors.
        warmup_analysis`): this one; multi-pass analyses list their
        passes."""
        return [self]

    def run(self, start=None, stop=None, step=None, frames=None,
            backend: str | None = None, batch_size: int | None = None,
            resilient=False, **executor_kwargs):
        """Iterate frames [start:stop:step] — or an explicit ``frames``
        index list — on the chosen backend (None: the class's
        ``_default_backend``): ``"torch"`` (the default but for
        :class:`AnalysisFromFunction`:
        single-device batches on ``cuda`` unless ``device="cpu"`` is
        passed; executor keywords such as ``device``, ``transfer_dtype``,
        ``block_cache``, ``scan_k`` and ``prestage`` pass through),
        ``"mesh"``, ``"serial"`` (the float64 NumPy oracle), or an
        executor instance.  Returns ``self``
        (``RMSF(ag).run().results.rmsf``).

        ``resilient``: ``True`` (the default policy) or a
        :class:`~mdanalysis_mpi_tpu_torch.reliability.ReliabilityPolicy`
        runs fault-tolerant (the JAX package's ``run(resilient=...)``):
        retry with backoff around staging, copies and dispatch,
        corrupt-frame re-read → skip-with-count → abort, Mesh → Torch →
        Serial degradation on a classified device failure, and — for
        reduction analyses on a batch backend — checkpointing through
        :mod:`~mdanalysis_mpi_tpu_torch.utils.checkpoint`, so the same
        call after a crash resumes from the last folded partials.  The
        run's report lands in ``results.reliability``."""
        if backend is None:
            backend = self._default_backend
        if resilient:
            from mdanalysis_mpi_tpu_torch.reliability.policy import (
                ReliabilityPolicy, run_resilient)

            policy = (resilient if isinstance(resilient, ReliabilityPolicy)
                      else ReliabilityPolicy())
            return run_resilient(
                self, policy, start=start, stop=stop, step=step,
                frames=frames, backend=backend, batch_size=batch_size,
                **executor_kwargs)
        import time

        from mdanalysis_mpi_tpu_torch import obs
        from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

        obs.maybe_enable_from_env()
        cap = obs.start_run_capture()
        t0 = time.perf_counter()
        try:
            if not self._accepts_updating_groups:
                self._refuse_updating_groups()
            frames = list(self._frames(start, stop, step, frames))
            self.n_frames = len(frames)
            self._frame_indices = frames
            executor = get_executor(backend, **executor_kwargs)
            backend_name = getattr(executor, "name",
                                   type(executor).__name__)
            # the run's device (None on the serial backend), for
            # analyses whose engine choice depends on it
            self._run_device = getattr(executor, "device", None)
            with obs.span("run", analysis=type(self).__name__,
                          backend=backend_name, n_frames=self.n_frames):
                with TIMERS.phase("prepare"):
                    self._prepare()
                with TIMERS.phase("execute"):
                    total = executor.execute(
                        self, self._universe.trajectory, frames,
                        batch_size=batch_size)
                # raw partials handle: a fetch-free synchronization point
                self._last_total = total
                with TIMERS.phase("conclude"):
                    self._conclude(total)
        except BaseException:
            # a raising run never reaches finish_run_capture: release
            # its phase window or every failed job would leak one into
            # the process-global registry (obs/report.py)
            obs.abandon_run_capture(cap)
            raise
        obs.METRICS.inc("mdtpu_runs_total", backend=backend_name)
        self.results.observability = obs.finish_run_capture(
            cap, analysis=type(self).__name__, backend=backend_name,
            n_frames=self.n_frames)
        if obs.trace_path():
            # file-backed tracing: keep the trace on disk current after
            # every run (atomic rewrite), so a crash or kill still
            # leaves a loadable timeline of everything completed
            obs.export_trace()
        if getattr(self, "_verbose", False):
            from mdanalysis_mpi_tpu_torch.utils.log import log_event

            wall = time.perf_counter() - t0
            log_event("run", analysis=type(self).__name__,
                      backend=backend_name, n_frames=self.n_frames,
                      wall_s=round(wall, 4),
                      fps=round(self.n_frames / wall, 2) if wall > 0
                      else None)
        return self

    def run_streaming(self, window: int | None = None,
                      backend: str = "torch",
                      batch_size: int | None = None,
                      poll_interval_s: float = 0.02,
                      flush_timeout_s: float = 0.25,
                      stall_timeout_s: float = 30.0,
                      snapshot_cb=None, clock=None, sleep=None,
                      **executor_kwargs):
        """Incremental run over a (possibly still growing) trajectory,
        emitting a digest-stamped partial snapshot every ``window``
        frames (docs/STREAMING.md).

        The driver processes the frame prefix ``[0, n_frames)`` in
        ``window``-sized slices as frames become available; on a
        follow-mode :class:`~mdanalysis_mpi_tpu_torch.io.store.
        StoreReader` it re-polls the tail manifest between slices and
        keeps going until the feed seals.  After every slice the carry
        is folded forward, ``_conclude`` refreshes ``self.results``, and
        a snapshot record (frames so far, ingest epoch, result digest via
        ``utils/integrity.py``, the materialized result arrays) is
        appended to ``results.stream_snapshots`` (and passed to
        ``snapshot_cb``).  Snapshots are MONOTONE: snapshot *k* is the
        closed-file result over its frame prefix, so the final one
        matches ``run()`` over the sealed trajectory.

        Backends: ``"serial"`` streams every analysis exactly (the
        accumulators live in the analysis object); the batch backends
        (``"torch"``, the default, on ``cuda`` unless ``device="cpu"``
        is passed; ``"mesh"``) fold per-window partials with
        ``_device_fold_fn`` (reductions) or concatenate them (per-frame
        series).  Each snapshot materializes the results on the host.
        Analyses that override ``run()`` (``AlignedRMSF``) are streamed
        by recompute-over-prefix: each snapshot re-runs the closed-file
        path over ``[0, done)`` — O(n²/W) total work, exact results.

        A feed that stops growing for ``stall_timeout_s`` while unsealed
        raises :class:`StreamFeedStalled` with all progress preserved;
        calling ``run_streaming`` again resumes.  Slices flush early when
        the feed trickles (``flush_timeout_s`` since the last snapshot
        with frames waiting).  ``clock``/``sleep`` are injectable for
        deterministic tests.  Returns ``self``.
        """
        import time

        from mdanalysis_mpi_tpu_torch import obs
        from mdanalysis_mpi_tpu_torch.utils import integrity as _integrity
        from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

        clock = clock or time.monotonic
        sleep = sleep or time.sleep
        traj = self._universe.trajectory
        window = int(window or getattr(traj, "chunk_frames", 0) or 64)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        override = type(self).run is not AnalysisBase.run
        executor = (None if override
                    else get_executor(backend, **executor_kwargs))
        backend_name = (backend if override else
                        getattr(executor, "name",
                                type(executor).__name__))
        obs.maybe_enable_from_env()
        st = getattr(self, "_stream_state", None)
        if st is not None and st.get("backend") != backend_name:
            raise ValueError(
                f"streaming run started on backend "
                f"{st['backend']!r}; resume must use it too, not "
                f"{backend_name!r} (the fold carry is backend-shaped)")
        cap = obs.start_run_capture()
        try:
            if st is None:
                if not self._accepts_updating_groups:
                    self._refuse_updating_groups()
                st = {"backend": backend_name, "done": 0,
                      "epoch": int(getattr(traj, "epoch", 0) or 0),
                      "total": None, "seq": 0}
                self.n_frames = 0
                self._frame_indices = []
                if not override:
                    self._run_device = getattr(executor, "device", None)
                    with TIMERS.phase("prepare"):
                        self._prepare()
                self.results.stream_snapshots = []
                self._stream_state = st

            def emit():
                st["seq"] += 1
                if not override:
                    total = st["total"]
                    self._last_total = total
                    with TIMERS.phase("conclude"):
                        self._conclude(total)
                arrays = {}
                for k, v in self.results.items():
                    if k in ("stream_snapshots", "observability",
                             "reliability"):
                        continue
                    try:
                        a = np.asarray(_materialize(v))
                    except Exception:
                        continue
                    if a.dtype != object:
                        arrays[k] = a
                snap = {
                    "seq": st["seq"], "frames": st["done"],
                    "epoch": st["epoch"],
                    "analysis": type(self).__name__,
                    "digest": _integrity.digest_arrays(arrays),
                    "values": arrays,
                }
                self.results.stream_snapshots.append(snap)
                st["last_emit"] = clock()
                obs.METRICS.inc("mdtpu_stream_snapshots_total")
                obs.METRICS.set_gauge(
                    "mdtpu_stream_snapshot_age_seconds", 0.0)
                obs.span_event("stream_snapshot",
                               analysis=type(self).__name__,
                               frames=st["done"], epoch=st["epoch"])
                if snapshot_cb is not None:
                    snapshot_cb(snap)

            st.setdefault("last_emit", clock())
            last_nf = st["done"]
            last_growth = clock()
            with obs.span("run", analysis=type(self).__name__,
                          backend=backend_name, streaming=True):
                while True:
                    nf = traj.n_frames
                    if nf > last_nf:
                        last_nf = nf
                        last_growth = clock()
                    epoch = int(getattr(traj, "epoch", 0) or 0)
                    if epoch > st["epoch"]:
                        obs.METRICS.inc("mdtpu_stream_epochs_total",
                                        epoch - st["epoch"])
                        st["epoch"] = epoch
                    sealed = bool(getattr(traj, "sealed", True))
                    avail = nf - st["done"]
                    if avail > 0 and (
                            avail >= window or sealed
                            or clock() - st["last_emit"]
                            >= flush_timeout_s):
                        lo = st["done"]
                        hi = min(nf, lo + window)
                        if override:
                            st["done"] = hi
                            self.run(stop=hi, backend=backend,
                                     batch_size=batch_size,
                                     **executor_kwargs)
                        else:
                            self.n_frames = hi
                            self._frame_indices = list(range(hi))
                            with TIMERS.phase("execute"):
                                part = executor.execute(
                                    self, traj, list(range(lo, hi)),
                                    batch_size=batch_size)
                            st["total"] = (
                                part
                                if not executor.per_call_partials
                                or st["total"] is None
                                else _fold_stream_partials(
                                    self, st["total"], part))
                            st["done"] = hi
                        obs.METRICS.inc("mdtpu_stream_frames_total",
                                        hi - lo)
                        emit()
                        continue
                    if sealed and avail <= 0:
                        break
                    waited = clock() - last_growth
                    obs.METRICS.set_gauge(
                        "mdtpu_stream_snapshot_age_seconds",
                        max(0.0, clock() - st["last_emit"]))
                    if waited >= stall_timeout_s:
                        obs.span_event("stream_stalled",
                                       analysis=type(self).__name__,
                                       frames=st["done"],
                                       waited_s=round(waited, 3))
                        raise StreamFeedStalled(
                            f"feed for {type(self).__name__} stuck at "
                            f"{st['done']} frames for {waited:.2f}s "
                            f"(unsealed store, stall_timeout_s="
                            f"{stall_timeout_s})",
                            frames_done=st["done"], waited_s=waited)
                    sleep(poll_interval_s)
                    if hasattr(traj, "refresh"):
                        traj.refresh()
        except BaseException:
            obs.abandon_run_capture(cap)
            raise
        # clean completion: the feed sealed and every frame is folded
        # in — a fresh run_streaming call starts a new run from frame 0
        self._stream_state = None
        obs.METRICS.inc("mdtpu_runs_total", backend=backend_name)
        self.results.observability = obs.finish_run_capture(
            cap, analysis=type(self).__name__, backend=backend_name,
            n_frames=self.n_frames)
        if obs.trace_path():
            obs.export_trace()
        return self


def _fold_stream_partials(analysis, total, part):
    """Fold one streaming window's partials into the carry: the
    analysis' own ``_device_fold_fn`` (reduction shapes), else
    leaf-wise concatenation (per-frame series — the same axis the
    executors concatenate per-batch series along)."""
    fold = analysis._device_fold_fn
    if fold is not None:
        return fold(total, part)

    def cat(a, b):
        if isinstance(a, (tuple, list)):
            return type(a)(cat(x, y) for x, y in zip(a, b))
        if getattr(a, "ndim", 0) == 0:
            return b                      # scalar leaf: latest wins
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            ref = a if isinstance(a, torch.Tensor) else b
            return torch.cat([torch.as_tensor(x, dtype=ref.dtype,
                                              device=ref.device)
                              for x in (a, b)])
        return np.concatenate([np.asarray(a), np.asarray(b)])

    return cat(total, part)


def real_frames(x, mask, n: int):
    """The rows of a per-frame series whose ``mask`` is set, in frame
    order.  On a tensor this reads nothing back from the device: a
    stable sort of the mask puts the ``n`` real rows (``n`` known on
    the host) first, and the gather keeps them."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)[np.asarray(mask) > 0.5]
    order = torch.argsort((mask <= 0.5).to(torch.int32), stable=True)
    return x[order[:n]]


def series_of(x, mask, n: int, dtype=np.float64):
    """A :class:`Deferred` of :func:`real_frames` as a host array of
    ``dtype`` (the frames are picked on the device; the copy to the
    host waits for the first read)."""
    return Deferred(lambda: np.asarray(to_numpy(real_frames(x, mask, n)),
                                       dtype))


class AnalysisFromFunction(AnalysisBase):
    """Wrap a per-frame function into an analysis (upstream
    ``analysis.base.AnalysisFromFunction``)::

        rg = AnalysisFromFunction(
            lambda ag: ag.radius_of_gyration(), ca).run()
        rg.results.timeseries          # (n_frames, ...) stacked values

    ``function(*args, **kwargs)`` is called once per frame with the
    trajectory positioned there (upstream contract: AtomGroup arguments
    read their universe's CURRENT frame).  Arbitrary Python has no batch
    function: ``run()`` takes the serial backend when none is named,
    and a batch backend raises; write a subclass with a batch function
    when the math should run on the device.
    """

    # the per-frame function reads its AtomGroup arguments at call time,
    # so an UpdatingAtomGroup's re-evaluation is seen every frame
    _accepts_updating_groups = True

    _default_backend = "serial"

    def __init__(self, function, *args, verbose: bool = False, **kwargs):
        from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
        from mdanalysis_mpi_tpu_torch.core.universe import Universe

        u = None
        for a in args:
            if isinstance(a, AtomGroup):
                u = a.universe
                break
            if isinstance(a, Universe):
                u = a
                break
        if u is None:
            raise ValueError(
                "pass at least one AtomGroup or Universe argument so the "
                "analysis knows which trajectory to iterate")
        super().__init__(u, verbose)
        self._function = function
        self._args = args
        self._kwargs = kwargs

    def _prepare(self):
        self._values = []

    def _single_frame(self, ts):
        self._values.append(self._function(*self._args, **self._kwargs))

    def _serial_summary(self):
        return self._values

    def _conclude(self, values):
        self.results.frames = np.asarray(self._frame_indices)
        self.results.timeseries = (
            np.stack([np.asarray(v) for v in values]) if values
            else np.empty(0))


def analysis_class(function):
    """Decorator turning a per-frame function into an Analysis class
    (upstream ``analysis.base.analysis_class``)::

        @analysis_class
        def com_z(ag):
            return ag.center_of_mass()[2]

        com_z(ca).run().results.timeseries
    """
    import functools

    class _Wrapped(AnalysisFromFunction):
        @functools.wraps(function, updated=())
        def __init__(self, *args, **kwargs):
            super().__init__(function, *args, **kwargs)

    _Wrapped.__name__ = getattr(function, "__name__", "AnalysisFromFunction")
    return _Wrapped


# ---- AnalysisCollection (upstream analysis.base.AnalysisCollection) ----

def needs_solo_on_batch(analysis) -> bool:
    """True for analyses that cannot consume a collection's union
    block on the batch backends: ring (atom-sharded) functions — custom
    shard specs — and mesh-only analyses.  The one definition of
    batch-path collection ineligibility, for :class:`AnalysisCollection`
    and for a request coalescer."""
    return (getattr(analysis, "_mesh_only", False)
            or type(analysis)._batch_specs is not AnalysisBase._batch_specs)


class UncoalescableAnalysisError(ValueError):
    """An analysis whose algorithm lives in a ``run()`` override
    (AlignedRMSF, PCA, AlignTraj, ...) cannot be driven through a
    collection's per-frame/batch hooks — the collection never calls the
    override.

    A typed subclass of ``ValueError`` so a request coalescer can route
    on it: a job carrying such an analysis is submitted per-job
    (non-coalesced, its own solo pass) instead of failing the whole
    merged batch.  ``analysis`` carries the offending instance."""

    def __init__(self, message, analysis=None):
        super().__init__(message)
        self.analysis = analysis


@functools.lru_cache(maxsize=None)
def _collection_kernel_for(fns):
    """One batch function running every child's on its slice of the
    staged union block.  ``params`` is a tuple of ``(slots,
    child_params)``: ``slots`` gathers the child's selection out of the
    union on the device (None: the child takes the block as it is).
    One identity per tuple of child functions, so a repeated collection
    finds its cached group programs (CUDA graphs) again."""

    def kernel(params, batch, boxes, mask):
        outs = []
        for fn, (slots, p) in zip(fns, params):
            b = batch if slots is None else batch[:, slots]
            outs.append(fn(p, b, boxes, mask))
        return tuple(outs)

    kernel.__name__ = "collection_" + "_".join(f.__name__ for f in fns)
    return kernel


@functools.lru_cache(maxsize=None)
def _collection_fold_for(folds):
    def fold(tot, part):
        return tuple(f(t, p) for f, t, p in zip(folds, tot, part))

    return fold


@functools.lru_cache(maxsize=None)
def _collection_combine_for(combines):
    def combine(parts, comm=None):
        return tuple(c([p[i] for p in parts], comm)
                     for i, c in enumerate(combines))

    return combine


class AnalysisCollection(AnalysisBase):
    """Run several analyses over the same trajectory in one pass
    (upstream 2.8's ``analysis.base.AnalysisCollection``)::

        coll = AnalysisCollection(RMSF(ca), RadiusOfGyration(protein))
        coll.run(device="cuda")
        coll.analyses[0].results.rmsf

    A collection stages each frame block once for all children: the
    union of the children's selections is gathered on the host, and
    each child's batch function slices its atoms back out on the
    device.  Host staging sets the wall of a run on the card, so N
    children cost about one pass, not N.

    Constraints: children must be hook-driven — an analysis whose class
    overrides ``run()`` is rejected at construction
    (:class:`UncoalescableAnalysisError`), and collections do not nest.
    On the batch and MPI backends the children must be either all
    reductions (a device fold: RMSF, AverageStructure, ...) or all time
    series (RMSD, RadiusOfGyration, ...), not a mix; ``backend='serial'``
    runs any mix.  Ring (atom-sharded) analyses cannot join a
    collection's batch path.  ``run()`` with no backend takes the
    serial backend if any child does (:class:`AnalysisFromFunction`),
    else ``'torch'``.
    """

    def __init__(self, *analyses, verbose: bool = False):
        if not analyses:
            raise ValueError("AnalysisCollection needs at least one analysis")
        traj = analyses[0]._universe.trajectory
        for a in analyses[1:]:
            if a._universe.trajectory is not traj:
                raise ValueError(
                    "all analyses in a collection must share one "
                    "trajectory (upstream contract); got distinct "
                    "readers — run them separately")
        for a in analyses:
            if isinstance(a, AnalysisCollection):
                raise ValueError(
                    "collections do not nest; pass the inner "
                    "collection's analyses directly")
            if type(a).run is not AnalysisBase.run:
                raise UncoalescableAnalysisError(
                    f"{type(a).__name__} overrides run() (its "
                    "algorithm or signature lives there) and cannot "
                    "join a collection; run it separately — in a "
                    "serving layer, submit it as its own per-job "
                    "(non-coalesced) request", analysis=a)
        super().__init__(analyses[0]._universe, verbose)
        self.analyses = list(analyses)
        # batch-path eligibility is resolved lazily (properties below):
        # the serial backend never reads folds or combines, so any mix
        # runs there; the batch and MPI backends get the error
        folds = tuple(a._device_fold_fn for a in analyses)
        self._mixed_folds = (any(f is not None for f in folds)
                             and not all(f is not None for f in folds))
        self._folds = folds
        self._combines = tuple(a._device_combine for a in analyses)
        self._ring_children = [
            type(a).__name__ for a in analyses if needs_solo_on_batch(a)]

    @property
    def _host_waits_in_batch(self):
        return any(a._host_waits_in_batch for a in self.analyses)

    @property
    def _default_backend(self):
        return ("serial" if any(a._default_backend == "serial"
                                for a in self.analyses) else "torch")

    def _mix_error(self):
        red = [type(a).__name__ for a, f in zip(self.analyses, self._folds)
               if f is not None]
        ser = [type(a).__name__ for a, f in zip(self.analyses, self._folds)
               if f is None]
        return ValueError(
            "a collection's batch/MPI path needs all-reduction or "
            f"all-time-series children, not a mix (reductions: {red}; "
            f"series: {ser}); split into two collections or run with "
            "backend='serial'")

    @property
    def _device_fold_fn(self):
        if self._mixed_folds:
            raise self._mix_error()
        if all(f is not None for f in self._folds):
            return _collection_fold_for(self._folds)
        return None

    @property
    def _device_combine(self):
        if self._mixed_folds:
            raise self._mix_error()
        if all(c is not None for c in self._combines):
            return _collection_combine_for(self._combines)
        if any(c is not None for c in self._combines):
            mixed = [type(a).__name__
                     for a, c in zip(self.analyses, self._combines)
                     if c is None]
            raise ValueError(
                "a mesh collection needs every child to declare a "
                f"_device_combine merge; missing on: {mixed} — run "
                "those children separately or add the combine")
        return None

    def _check_ring_children(self):
        if self._ring_children:
            raise ValueError(
                f"{self._ring_children} use atom-sharded (ring) "
                "kernels and cannot consume a collection's union "
                "block; run them separately (serial runs of a "
                "collection never hit this)")

    def _prepare(self):
        for a in self.analyses:
            if not a._accepts_updating_groups:
                a._refuse_updating_groups()
            a.n_frames = self.n_frames
            a._frame_indices = self._frame_indices
            a._run_device = getattr(self, "_run_device", None)
            a._prepare()
        self._compute_union()

    def _single_frame(self, ts):
        for a in self.analyses:
            a._single_frame(ts)

    def _serial_summary(self):
        return tuple(a._serial_summary() for a in self.analyses)

    def _identity_partials(self):
        return tuple(a._identity_partials() for a in self.analyses)

    def _compute_union(self):
        """Union selection + per-child slot arrays, computed once at
        _prepare time (the executors may read _batch_params before
        _batch_select)."""
        sels = [a._batch_select() for a in self.analyses]
        if any(s is None for s in sels):
            # some child consumes whole frames: stage full frames, each
            # selected child gathers its absolute indices on the device
            self._union = None
            self._slots = tuple(
                None if s is None else np.asarray(s) for s in sels)
            return
        union = np.unique(np.concatenate([np.asarray(s) for s in sels]))
        slots = []
        for s in sels:
            pos = np.searchsorted(union, np.asarray(s))
            if len(pos) == len(union) and np.array_equal(
                    pos, np.arange(len(union))):
                pos = None          # the child's selection IS the union
            slots.append(pos)
        self._union = union
        self._slots = tuple(slots)

    def _batch_select(self):
        return self._union

    def _batch_specs(self):
        self._check_ring_children()
        return None

    def _batch_fn(self):
        self._check_ring_children()
        return _collection_kernel_for(
            tuple(a._batch_fn() for a in self.analyses))

    def _batch_params(self):
        return tuple(
            (None if s is None else torch.as_tensor(s, dtype=torch.int64),
             a._batch_params())
            for s, a in zip(self._slots, self.analyses))

    def _conclude(self, total):
        for a, t in zip(self.analyses, total):
            a._last_total = t
            a._conclude(t)
        self.results.analyses = [a.results for a in self.analyses]
