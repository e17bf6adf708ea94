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
``_identity_partials()``  empty-trajectory partials
``_conclude(total)``   partials → ``self.results``
=====================  ========================================================
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.parallel.executors import get_executor


def tree_add(a, b):
    """Elementwise sum over matching tuples/lists — the generic
    ``_device_fold_fn`` for analyses whose partials merge by addition."""
    if isinstance(a, (tuple, list)):
        return type(a)(tree_add(x, y) for x, y in zip(a, b))
    return a + b


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

    class _Group(dict):
        def __missing__(self, key):
            d = Deferred(lambda: _run()[key])
            self[key] = d
            return d

    return _Group()


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


class AnalysisBase:
    """Template for trajectory analyses with pluggable backends."""

    #: analyses snapshot their selection into a static index array in
    #: _prepare, so a per-frame-re-evaluating UpdatingAtomGroup would
    #: silently freeze at its current membership; run() refuses it
    _accepts_updating_groups = False

    # module-level (total, partials) -> total merge executed on the
    # device once per batch; None → partials are concatenated instead
    _device_fold_fn = None

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

    def _identity_partials(self):
        raise NotImplementedError

    def _conclude(self, total):
        raise NotImplementedError

    # ---- run ----

    def _refuse_updating_groups(self):
        from mdanalysis_mpi_tpu_torch.core.groups import UpdatingAtomGroup

        def scan(value):
            if isinstance(value, UpdatingAtomGroup):
                raise TypeError(
                    f"{type(self).__name__} snapshots its selection into "
                    "a static index array at _prepare time and cannot "
                    "track an UpdatingAtomGroup's per-frame membership; "
                    "pass a static group")
            if isinstance(value, (tuple, list)):
                for v in value:
                    scan(v)

        for v in vars(self).values():
            scan(v)

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

    def run(self, start=None, stop=None, step=None, frames=None,
            backend: str = "torch", batch_size: int | None = None,
            **executor_kwargs):
        """Iterate frames [start:stop:step] — or an explicit ``frames``
        index list — on the chosen backend: ``"torch"`` (the default:
        single-device batches on ``cuda`` unless ``device="cpu"`` is
        passed; executor keywords such as ``device``, ``transfer_dtype``
        and ``block_cache`` pass through), ``"serial"`` (the float64
        NumPy oracle), or an executor instance.
        Returns ``self`` (``RMSF(ag).run().results.rmsf``)."""
        if not self._accepts_updating_groups:
            self._refuse_updating_groups()
        frames = list(self._frames(start, stop, step, frames))
        self.n_frames = len(frames)
        self._frame_indices = frames
        executor = get_executor(backend, **executor_kwargs)
        # the run's device (None on the serial backend), for analyses
        # whose engine choice depends on it
        self._run_device = getattr(executor, "device", None)
        self._prepare()
        total = executor.execute(self, self._universe.trajectory, frames,
                                 batch_size=batch_size)
        # raw partials handle: a fetch-free synchronization point
        self._last_total = total
        self._conclude(total)
        return self
