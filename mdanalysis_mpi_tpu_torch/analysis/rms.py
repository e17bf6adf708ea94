"""RMSF / RMSD analyses.

- :class:`RMSF` — per-atom root-mean-square fluctuation of an AtomGroup's
  coordinates as given (stock ``rms.RMSF`` oracle, RMSF.py:14-15: the
  user aligns first).
- :class:`RMSD` — per-frame RMSD time series to a reference frame with
  optional least-squares superposition (BASELINE config 3; the qcprot
  use case), and the one-shot :func:`rmsd`.
- :class:`AlignedRMSF` — the entire reference program in one analysis
  (RMSF.py:53-149): pass 1 average structure, pass 2 aligned Welford
  moments, Chan merge, ``sqrt(M2.sum(xyz)/T)`` finalize.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.align import (
    AverageStructure, _f32, _reference_sel_coords)
from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    real_frames as _real_frames,
                                                    to_numpy)
from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
from mdanalysis_mpi_tpu_torch.ops import host
from mdanalysis_mpi_tpu_torch.ops.moments import (merge_moments,
                                                  psum_moments,
                                                  rmsf_from_moments)


# ---- module-level batch functions ----

def _moments_kernel(params, batch, boxes, mask):
    """Plain batched moments of the staged selection (stock RMSF)."""
    del boxes, params
    from mdanalysis_mpi_tpu_torch.ops.moments import batch_moments

    return batch_moments(batch, mask)


def _aligned_moments_kernel(params, batch, boxes, mask):
    """Superpose the selection onto fixed reference coords, then batched
    moments — the reference's pass-2 body (RMSF.py:124-138)."""
    del boxes
    from mdanalysis_mpi_tpu_torch.ops.align import superpose_selection_batch
    from mdanalysis_mpi_tpu_torch.ops.moments import batch_moments

    w, ref_c, ref_com = params
    aligned = superpose_selection_batch(batch, w, ref_c, ref_com)
    return batch_moments(aligned, mask)


def _rmsd_kernel(params, batch, boxes, mask):
    """Per-frame RMSD with superposition (BASELINE config 3)."""
    del boxes
    from mdanalysis_mpi_tpu_torch.ops.rmsd import rmsd_batch

    masses, rot_w, rmsd_w, ref_c = params
    vals = rmsd_batch(batch, masses, ref_c, superposition=True,
                      rot_weights=rot_w, rmsd_weights=rmsd_w)
    return (vals * mask, mask)


def _rmsd_groups_kernel(params, batch, boxes, mask):
    """Main-selection superposed RMSD + per-group RMSDs (upstream
    ``RMSD(groupselections=[...])``): the rotation fitted on the MAIN
    selection is applied to every group (no per-group fitting), each
    group compared to its reference coords about the main reference
    COM.  batch is the staged UNION; slots gather main/groups.  Groups
    are padded to a common width with 0/1 weights."""
    from mdanalysis_mpi_tpu_torch.ops.align import (kabsch_rotation_batch,
                                                    weighted_center)

    del boxes
    (main_slots, masses, rot_w, rmsd_w, ref_main_c, group_slots,
     group_w, ref_groups_c) = params
    x_main = batch[:, main_slots]
    # ONE weighted COM + Kabsch solve serves both the main RMSD and the
    # group transforms (rmsd_batch would redo the same solve)
    com = weighted_center(x_main, masses)                 # (B, 3)
    main_c = x_main - com[:, None]
    r = kabsch_rotation_batch(main_c, ref_main_c, rot_w)
    aligned = torch.einsum("bni,bij->bnj", main_c, r)
    w = rmsd_w / rmsd_w.sum()
    d2m = ((aligned - ref_main_c[None]) ** 2).sum(-1)
    vals = torch.sqrt(d2m @ w)
    xg = batch[:, group_slots.reshape(-1)].reshape(
        (batch.shape[0],) + tuple(group_slots.shape) + (3,))  # (B, K, G, 3)
    xg_c = torch.einsum("bkgi,bij->bkgj", xg - com[:, None, None, :], r)
    d2 = ((xg_c - ref_groups_c[None]) ** 2).sum(-1)       # (B, K, G)
    wsum = group_w.sum(dim=1)                             # (K,)
    gvals = torch.sqrt((d2 * group_w[None]).sum(-1) / wsum[None])
    return (vals * mask, gvals * mask[:, None], mask)


def _rmsd_nofit_kernel(params, batch, boxes, mask):
    """Per-frame RMSD without superposition."""
    del boxes
    from mdanalysis_mpi_tpu_torch.ops.rmsd import rmsd_batch

    masses, _, rmsd_w, ref_c = params
    vals = rmsd_batch(batch, masses, ref_c, superposition=False,
                      rmsd_weights=rmsd_w)
    return (vals * mask, mask)


def _psum_moments_partials(parts, comm=None):
    """The mesh merge of per-device moment partials (law of total
    variance, ``ops.moments.psum_moments``)."""
    return psum_moments(parts, comm)


def center_reference(ref, masses):
    """``(ref − com, com)`` of reference coordinates under ``masses``
    (the JAX package's ``_center_ref_jit``): a reference that came out
    of a device pass stays on its device (float32), a host one is
    centred in float64."""
    if isinstance(ref, torch.Tensor):
        from mdanalysis_mpi_tpu_torch.ops.align import weighted_center

        ref32 = ref.to(torch.float32)
        com = weighted_center(ref32, _f32(masses).to(ref.device))
        return ref32 - com, com
    ref = np.asarray(ref, np.float64)
    com = host.weighted_center(ref, masses)
    return ref - com, com


def rmsd(a, b, weights=None, center: bool = False,
         superposition: bool = False) -> float:
    """One-shot RMSD between two (N, 3) coordinate sets (upstream
    ``rms.rmsd``): optionally remove the (weighted) centroids
    (``center``) and/or the optimal rotation (``superposition``, which
    implies centering — upstream semantics).  Host float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(
            f"a and b must both be (N, 3), got {a.shape} vs {b.shape}")
    w = (np.ones(len(a)) if weights is None
         else np.asarray(weights, np.float64))
    if len(w) != len(a):
        raise ValueError(
            f"weights has {len(w)} entries for {len(a)} atoms")
    if center or superposition:
        a = a - (w[:, None] * a).sum(0) / w.sum()
        b = b - (w[:, None] * b).sum(0) / w.sum()
    if superposition:
        a = a @ host.qcp_rotation(a, b, None if weights is None else w)
    d2 = ((a - b) ** 2).sum(axis=1)
    return float(np.sqrt((w @ d2) / w.sum()))


class RMSF(AnalysisBase):
    """Per-atom RMSF of an AtomGroup: ``RMSF(ag).run().results.rmsf``.

    Streaming mean/M2 of the group's coordinates over frames (the
    reference's pass-2 accumulation, RMSF.py:137-138, minus the
    alignment).  Results: ``rmsf`` (S,), ``mean`` (S,3), ``m2`` (S,3).
    """

    def __init__(self, atomgroup: AtomGroup, verbose: bool = False):
        super().__init__(atomgroup.universe, verbose)
        self._ag = atomgroup

    def _prepare(self):
        self._idx = self._ag.indices
        self._stream = host.StreamingMoments((len(self._idx), 3))

    def _single_frame(self, ts):
        self._stream.update(ts.positions[self._idx].astype(np.float64))

    def _serial_summary(self):
        return self._stream.summary

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _moments_kernel

    _device_fold_fn = staticmethod(merge_moments)
    _device_combine = staticmethod(_psum_moments_partials)

    def _identity_partials(self):
        z = np.zeros((len(self._idx), 3))
        return (0.0, z, z.copy())

    def _conclude(self, total):
        t, mean, m2 = total
        # device tensors stay resident; Results fetches on user access
        self.results.mean = mean
        self.results.m2 = m2
        self.results.n_frames = self.n_frames
        self.results.rmsf = rmsf_from_moments(t, m2)


class RMSD(AnalysisBase):
    """Per-frame RMSD to a reference frame: ``.results.rmsd`` (n_frames,).

    ``superposition=True`` (default) removes the optimal rigid-body
    rotation+translation first (the reference's qcprot machinery,
    RMSF.py:43-51, as used by BASELINE config 3); ``weights="mass"``
    mass-weights both the fit and the RMSD.

    ``groupselections=[sel, ...]`` (upstream): each extra selection's
    unweighted RMSD is computed per frame in the MAIN selection's
    fitted frame (no per-group fitting — the domain-motion recipe) →
    ``results.group_rmsd`` (n_frames, K).  Upstream packs these as
    extra columns of ``results.rmsd``; here the main series stays
    (n_frames,) and the groups get their own key (as in the JAX
    package).

    On the torch backend both series stay on the run's device:
    ``results["rmsd"]`` is the tensor, ``results.rmsd`` fetches it.
    """

    def __init__(self, mobile, reference=None, select: str = "all",
                 ref_frame: int = 0, superposition: bool = True,
                 weights: str | None = None, groupselections=None,
                 verbose: bool = False):
        universe = mobile.universe if isinstance(mobile, AtomGroup) else mobile
        super().__init__(universe, verbose)
        self._mobile = mobile
        self._reference = reference if reference is not None else universe
        self._select = select
        self._ref_frame = ref_frame
        self._superposition = superposition
        if weights not in (None, "mass"):
            raise ValueError(f"weights must be None or 'mass', got {weights!r}")
        self._weights_mode = weights
        self._groupselections = (list(groupselections)
                                 if groupselections else None)
        if self._groupselections and not superposition:
            raise ValueError(
                "groupselections need superposition=True (their RMSD "
                "is defined in the main selection's fitted frame)")

    def _prepare(self):
        if isinstance(self._mobile, AtomGroup):
            # refine within the group — RMSD(u.select_atoms('segid A'),
            # select='name CA') must stay restricted to segid A
            ag = (self._mobile if self._select == "all"
                  else self._mobile.select_atoms(self._select))
        else:
            ag = self._universe.select_atoms(self._select)
        if ag.n_atoms == 0:
            raise ValueError(f"selection {self._select!r} matched no atoms")
        self._idx = ag.indices
        self._masses = ag.masses
        self._rmsd_w = (self._masses if self._weights_mode == "mass"
                        else np.ones(len(self._idx)))
        self._ref_sel_c, self._ref_com = _reference_sel_coords(
            self._reference, self._idx, self._masses, self._ref_frame)
        self._serial_vals: list[float] = []
        if self._groupselections:
            self._prepare_groups()

    def _prepare_groups(self):
        gids = []
        for gsel in self._groupselections:
            g = self._universe.select_atoms(gsel)
            if g.n_atoms == 0:
                raise ValueError(f"groupselection {gsel!r} matched no atoms")
            gids.append(g.indices)
        # groups padded to a common width with 0/1 weights (one
        # rectangular gather for the batch function)
        gmax = max(len(g) for g in gids)
        k = len(gids)
        self._gslots_global = np.zeros((k, gmax), np.int64)
        self._gw = np.zeros((k, gmax), np.float64)
        for j, g in enumerate(gids):
            self._gslots_global[j, :len(g)] = g
            self._gw[j, :len(g)] = 1.0
        # reference group coords about the main-selection ref COM; the
        # reference cursor is saved and restored (RMSF.py:80-87), so a
        # user iterating the reference universe is not rewound
        ref_traj = self._reference.trajectory
        prev = ref_traj.ts.frame
        try:
            rp = ref_traj[self._ref_frame].positions.astype(np.float64)
        finally:
            ref_traj[prev]
        self._ref_groups_c = np.stack(
            [rp[self._gslots_global[j]] - self._ref_com for j in range(k)])
        self._serial_gvals: list[np.ndarray] = []
        # stage the union; np.unique sorts it, so searchsorted IS the
        # global-index → slot map
        self._union = np.unique(np.concatenate(
            [self._idx, self._gslots_global.ravel()]))
        self._main_slots = np.searchsorted(
            self._union, self._idx).astype(np.int64)
        self._gslots = np.searchsorted(
            self._union, self._gslots_global).astype(np.int64)

    # -- serial path --

    def _single_frame(self, ts):
        sel = ts.positions[self._idx].astype(np.float64)
        com = host.weighted_center(sel, self._masses)
        sel_c = sel - com
        r = None
        if self._superposition:
            rot_w = self._masses if self._weights_mode == "mass" else None
            r = host.qcp_rotation(sel_c, self._ref_sel_c, rot_w)
            sel_c = sel_c @ r
        w = self._rmsd_w / self._rmsd_w.sum()
        d2 = ((sel_c - self._ref_sel_c) ** 2).sum(axis=1)
        self._serial_vals.append(float(np.sqrt(d2 @ w)))
        if self._groupselections:
            pos = ts.positions.astype(np.float64)
            gv = np.empty(len(self._gslots_global))
            for j in range(len(gv)):
                xg = (pos[self._gslots_global[j]] - com) @ r
                diff2 = ((xg - self._ref_groups_c[j]) ** 2).sum(-1)
                wj = self._gw[j]
                gv[j] = np.sqrt((diff2 * wj).sum() / wj.sum())
            self._serial_gvals.append(gv)

    def _serial_summary(self):
        vals = np.asarray(self._serial_vals)
        if self._groupselections:
            g = (np.stack(self._serial_gvals) if self._serial_gvals
                 else np.empty((0, len(self._gslots_global))))
            return (vals, g, np.ones(len(vals)))
        return (vals, np.ones(len(vals)))

    # -- batch path --

    def _batch_select(self):
        return self._union if self._groupselections else self._idx

    def _batch_fn(self):
        if self._groupselections:
            return _rmsd_groups_kernel
        return _rmsd_kernel if self._superposition else _rmsd_nofit_kernel

    def _batch_params(self):
        masses = _f32(self._masses)
        rot_w = masses if self._weights_mode == "mass" else None
        if self._groupselections:
            return (torch.as_tensor(self._main_slots), masses, rot_w,
                    _f32(self._rmsd_w), _f32(self._ref_sel_c),
                    torch.as_tensor(self._gslots), _f32(self._gw),
                    _f32(self._ref_groups_c))
        return (masses, rot_w, _f32(self._rmsd_w), _f32(self._ref_sel_c))

    # no _device_fold_fn: the executor concatenates the per-batch
    # (vals, mask) series in frame order on the device
    _device_combine = None

    def _identity_partials(self):
        if self._groupselections:
            return (np.empty(0),
                    np.empty((0, len(self._gslots_global))), np.empty(0))
        return (np.empty(0), np.empty(0))

    def _conclude(self, total):
        mask = total[-1]
        self.results.rmsd = _real_frames(total[0], mask, self.n_frames)
        if self._groupselections:
            self.results.group_rmsd = _real_frames(total[1], mask,
                                                   self.n_frames)


class AlignedRMSF(AnalysisBase):
    """The reference program end-to-end: average structure, then RMSF of
    the selection after superposition onto that average
    (RMSF.py:53-149; serial oracle RMSF.py:1-18).

    ``engine``: ``None``/``'auto'`` run the generic form (dequant,
    Kabsch by QCP, batched moments — torch ops); ``'fused'`` runs both
    passes through the fused aligned-moments kernel on int16, int8 or
    delta staging (float32 staging keeps the generic form).

    Results: ``rmsf`` (S,), ``average`` (S, 3) — the average selection
    structure, ``mean``/``m2`` moment arrays.
    """

    def __init__(self, universe, select: str = "protein and name CA",
                 ref_frame: int = 0, verbose: bool = False,
                 engine: str | None = None):
        super().__init__(universe, verbose)
        self._select = select
        self._ref_frame = ref_frame
        from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import validate_engine

        validate_engine(engine)
        self._engine = engine

    def _setup_backend(self, backend, kwargs):
        """Resolve the backend and attach the shared device block cache:
        both passes iterate the same frames with the same selection, so
        pass 2 reads the blocks pass 1 left on the device instead of
        re-staging them (the reference re-decodes every frame in pass
        2, RMSF.py:124).  Returns (executor or 'serial', kwargs)."""
        from mdanalysis_mpi_tpu_torch.parallel.executors import (
            DeviceBlockCache, get_executor)

        if isinstance(backend, str) and backend != "serial":
            cache = kwargs.pop("block_cache", None) or DeviceBlockCache()
            backend = get_executor(backend, block_cache=cache, **kwargs)
            kwargs = {}
        elif getattr(backend, "block_cache", False) is None:
            # executor instance without a cache: attach one so pass 2
            # still reuses pass 1's staged blocks
            backend.block_cache = DeviceBlockCache()
        return backend, kwargs

    def _make_pass1(self):
        # Pass 1 (RMSF.py:76-113): average of aligned selection coords.
        return AverageStructure(
            self._universe, select=self._select,
            ref_frame=self._ref_frame, select_only=True,
            verbose=self._verbose, engine=self._engine)

    def _make_pass2(self, avg):
        # raw dict access keeps the average on the device between passes
        self._avg_sel = avg.results["positions"]        # (S, 3)
        # Pass 2 (RMSF.py:115-143): moments of coords aligned to the average
        return _MomentsToReference(
            self._universe, self._select, self._avg_sel, self._verbose,
            engine=self._engine)

    def _finalize(self, moments_pass):
        t, mean, m2 = moments_pass._total
        self._last_total = moments_pass._total    # fetch-free sync point
        self.n_frames = moments_pass.n_frames
        self.results.average = self._avg_sel
        self.results.mean = mean
        self.results.m2 = m2
        # RMSF.py:146: sqrt(M2.sum(axis=xyz)/T)
        self.results.rmsf = rmsf_from_moments(t, m2)
        return self

    def _warmup_analyses(self):
        """Both passes (the JAX package's ``_warmup_analyses``).  Pass
        2's reference is an input of its batch function, so zeros of
        the selection's shape stand in for the average not yet
        computed."""
        sel = self._universe.select_atoms(self._select)
        zeros = np.zeros((len(sel), 3), dtype=np.float32)
        return [self._make_pass1(),
                _MomentsToReference(self._universe, self._select, zeros,
                                    self._verbose, engine=self._engine)]

    def run(self, start=None, stop=None, step=None, frames=None,
            backend: str = "torch", batch_size: int | None = None,
            **kwargs):
        # resilient= applies PER PASS (the JAX package's AlignedRMSF):
        # each pass is its own reduction with its own checkpoint
        # fingerprint and degradation chain, so it rides the child
        # run() calls, never the executor constructor
        from mdanalysis_mpi_tpu_torch import obs

        resilient = kwargs.pop("resilient", False)
        backend, kwargs = self._setup_backend(backend, kwargs)
        backend_name = (backend if isinstance(backend, str)
                        else getattr(backend, "name",
                                     type(backend).__name__))
        obs.maybe_enable_from_env()
        cap = obs.start_run_capture()
        try:
            with obs.span("run", analysis=type(self).__name__,
                          backend=backend_name):
                with obs.span("pass", index=1,
                              analysis="AverageStructure"):
                    avg = self._make_pass1().run(
                        start, stop, step, frames=frames,
                        backend=backend, batch_size=batch_size,
                        resilient=resilient, **kwargs)
                moments_pass = self._make_pass2(avg)
                with obs.span("pass", index=2,
                              analysis="_MomentsToReference"):
                    moments_pass.run(
                        start, stop, step, frames=frames,
                        backend=backend, batch_size=batch_size,
                        resilient=resilient, **kwargs)
            self._finalize(moments_pass)
        except BaseException:
            # same leak guard as AnalysisBase.run: a failed pass must
            # release the outer capture's phase window
            obs.abandon_run_capture(cap)
            raise
        # the multi-pass RunReport covers both passes (the child runs
        # attach their own per-pass reports to internal analyses)
        self.results.observability = obs.finish_run_capture(
            cap, analysis=type(self).__name__, backend=backend_name,
            n_frames=self.n_frames)
        if obs.trace_path():
            # the child runs' exports happened before the outer run and
            # pass spans closed; re-export so the file carries them
            obs.export_trace()
        if resilient:
            # the per-pass reports land on the internal pass analyses;
            # merge them onto the surface the user reads
            from mdanalysis_mpi_tpu_torch.reliability.policy import (
                merge_reliability_results)

            self.results.reliability = merge_reliability_results(
                avg.results.get("reliability"),
                moments_pass.results.get("reliability"))
        return self

    def _run_checkpointed_multipass(self, path=None, chunk_frames=4096,
                                    start=None, stop=None, step=None,
                                    frames=None, backend="torch",
                                    batch_size=None, checkpoint_dir=None,
                                    delete_on_success=True,
                                    **executor_kwargs):
        """``utils.checkpoint.run_checkpointed`` for the two passes (the
        JAX package's ``_run_checkpointed_multipass``): pass 1's
        coordinate sums and pass 2's moments are both mergeable, so
        each pass checkpoints under its own fingerprint.  Pass 1's file
        survives its own completion, so a crash in pass 2 resumes pass
        1 from its summary (one load, no recompute); both files go when
        the run completes.  Chunk boundaries fall between executor
        calls, so a scan group never spans a checkpoint."""
        import os as _os_mod

        from mdanalysis_mpi_tpu_torch.utils.checkpoint import (
            checkpoint_path, run_checkpointed)

        backend, executor_kwargs = self._setup_backend(
            backend, executor_kwargs)
        window = dict(start=start, stop=stop, step=step, frames=frames)
        # an explicit path hosts pass 2 (the pass whose partials are
        # the result); pass 1 gets a sibling.  path=None derives both
        # (distinct class-name fingerprints)
        p1_path = None if path is None else path + ".pass1"
        avg = self._make_pass1()
        run_checkpointed(
            avg, path=p1_path, chunk_frames=chunk_frames,
            backend=backend, batch_size=batch_size,
            checkpoint_dir=checkpoint_dir, delete_on_success=False,
            **window, **executor_kwargs)
        if p1_path is None:
            p1_path = checkpoint_path(
                avg, list(avg._frame_indices),
                checkpoint_dir=checkpoint_dir)
        moments_pass = self._make_pass2(avg)
        run_checkpointed(
            moments_pass, path=path, chunk_frames=chunk_frames,
            backend=backend, batch_size=batch_size,
            checkpoint_dir=checkpoint_dir,
            delete_on_success=delete_on_success,
            **window, **executor_kwargs)
        self._finalize(moments_pass)
        # delete_on_success=False keeps BOTH pass files: the whole
        # resumable state
        if delete_on_success and _os_mod.path.exists(p1_path):
            _os_mod.remove(p1_path)
        return self


class _MomentsToReference(AnalysisBase):
    """Pass 2 of the reference: superpose the selection onto fixed
    reference coords, accumulate Welford moments (RMSF.py:115-143)."""

    def __init__(self, universe, select, ref_sel_positions, verbose=False,
                 engine: str | None = None):
        super().__init__(universe, verbose)
        self._select = select
        self._ref_sel_positions = ref_sel_positions
        self._engine = engine

    def _prepare(self):
        ag = self._universe.select_atoms(self._select)
        self._idx = ag.indices
        self._masses = ag.masses
        # center the average-structure reference (RMSF.py:116-118); a
        # reference that came out of a device pass 1 is centred on its
        # device
        self._ref_sel_c, self._ref_com = center_reference(
            self._ref_sel_positions, self._masses)
        # _single_frame caches the host copy of the centered reference;
        # it must not survive a re-run
        self._ref_np = None
        self._stream = host.StreamingMoments((len(self._idx), 3))

    def _single_frame(self, ts):
        if self._ref_np is None:
            self._ref_np = (
                np.asarray(to_numpy(self._ref_sel_c), np.float64),
                np.asarray(to_numpy(self._ref_com), np.float64))
        host.superpose_moments_frame(
            ts.positions, self._idx, self._masses,
            self._ref_np[0], self._ref_np[1], self._stream)

    def _serial_summary(self):
        return self._stream.summary

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _aligned_moments_kernel

    def _quantized_batch(self, transfer_dtype: str):
        """Fused quantized-native pass 2 (executors._quantized_native).
        Shares pass 1's padded selection, so the device block cache
        serves both passes."""
        from mdanalysis_mpi_tpu_torch.ops import fused_rmsf

        return fused_rmsf.quantized_batch(
            "moments", self._engine, transfer_dtype, self._idx,
            self._ref_sel_c, self._ref_com, self._masses)

    def _batch_params(self):
        return (_f32(self._masses), _f32(self._ref_sel_c),
                _f32(self._ref_com))

    _device_fold_fn = staticmethod(merge_moments)
    _device_combine = staticmethod(_psum_moments_partials)

    def _identity_partials(self):
        z = np.zeros((len(self._idx), 3))
        return (0.0, z, z.copy())

    def _conclude(self, total):
        self._total = total
