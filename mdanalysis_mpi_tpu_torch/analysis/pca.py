"""Principal component analysis of trajectory coordinates.

Upstream-API mirror (``MDAnalysis.analysis.pca.PCA``): fit principal
components of the (3S)-dimensional coordinate distribution of a
selection over frames — ``PCA(u, select=...).run()`` →
``results.p_components`` (3S, k), ``results.variance``,
``results.cumulated_variance``, ``results.mean`` — plus
``transform(ag)`` to project frames onto the components.  The reference
program itself has no PCA, but its capability envelope (AnalysisBase
over pluggable executors, SURVEY.md §3.5 / BASELINE north_star) is
exactly what this plugs into.

The covariance accumulation is a batched rank-B update ``Σ xᵀx`` —
one (B, 3S)ᵀ·(B, 3S) float32 matmul per staged block (TF32 stays off,
``device.py``) — merged across batches with the device fold and across
devices with a sum.  The mean rides in the same partial tuple, so a
single sweep yields (T, Σx, Σxᵀx) and the covariance
``(Σxᵀx − Σx·Σxᵀ/T)/(T−1)`` needs no second pass.  With ``align=True``
the fit runs as two passes like AlignedRMSF (RMSF.py:76-143): pass 1
computes the average structure of the selection (the generic torch-op
form over a device block cache that pass 2 reads again), pass 2
least-squares-superposes every frame onto it before accumulating —
rigid-body motion must not masquerade as variance.  The
eigendecomposition (``torch.linalg.eigh``, descending) runs on the
device at the first read of a result, so ``run()`` waits on nothing.
The JAX package's ``analysis/pca.py``; here ``run()`` takes the
``'torch'`` backend when none is named (the JAX package's PCA takes
``'serial'``).
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    deferred_group, to_numpy,
                                                    tree_add, tree_psum)
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.ops import host


# ---- module-level batch functions ----

def _cov_partials(batch, mask):
    b = batch.shape[0]
    x = batch.reshape(b, -1)
    xm = x * mask[:, None]
    return (mask.sum(), xm.sum(dim=0), xm.T @ x)


def _cov_kernel(params, batch, boxes, mask):
    """Partials (T, Σx (3S,), Σxᵀx (3S, 3S)) of the staged selection."""
    del boxes, params
    return _cov_partials(batch, mask)


def _aligned_cov_kernel(params, batch, boxes, mask):
    """Superpose the selection onto the average structure, then the
    covariance partials (align=True path)."""
    del boxes
    from mdanalysis_mpi_tpu_torch.ops.align import superpose_selection_batch

    w, ref_c, ref_com = params
    return _cov_partials(
        superpose_selection_batch(batch, w, ref_c, ref_com), mask)


def _eig(t, sx, sxx):
    """Device covariance → eigendecomposition in descending order
    (``torch.linalg.eigh``; on a CUDA device it waits for the solver's
    status, which is why it runs at the first read of a result)."""
    t = t.to(sx.dtype)
    mean = sx / t
    cov = (sxx - torch.outer(sx, sx) / t) / (t - 1.0)
    vals, vecs = torch.linalg.eigh(cov)
    return mean, cov, torch.flip(vals, dims=(0,)), torch.flip(vecs,
                                                              dims=(1,))


class PCA(AnalysisBase):
    """``PCA(u, select='name CA', align=True).run()``.

    Results: ``p_components`` (3S, k), ``variance`` (descending
    eigenvalues, Å²), ``cumulated_variance`` (fractions of total),
    ``mean`` (S, 3), ``cov`` (3S, 3S).  ``transform(ag)`` projects
    frames onto the fitted components.  The covariance is (3S)² — size
    the selection accordingly (upstream's practical contract too: PCA
    is for Cα/backbone-scale selections, not full solvated systems).
    """

    def __init__(self, universe: Universe, select: str = "all",
                 align: bool = False, ref_frame: int = 0,
                 n_components: int | None = None, verbose: bool = False):
        super().__init__(universe, verbose)
        self._select = select
        self._align = align
        self._ref_frame = ref_frame
        self._n_components = n_components
        self._ref_sel = None          # set by run() on the align path

    def run(self, start=None, stop=None, step=None, frames=None,
            backend: str = "torch", batch_size: int | None = None,
            **kwargs):
        if not self._align:
            return super().run(start, stop, step, frames=frames,
                               backend=backend, batch_size=batch_size,
                               **kwargs)
        # two passes over the same frames/selection → share one device
        # block cache, exactly like AlignedRMSF (pass 2 reads
        # device-resident blocks instead of re-staging)
        #
        # resilient= rides the child run() calls, never the executor
        # constructor (same per-pass contract as AlignedRMSF.run)
        resilient = kwargs.pop("resilient", False)
        if isinstance(backend, str) and backend != "serial":
            from mdanalysis_mpi_tpu_torch.parallel.executors import (
                DeviceBlockCache, get_executor)

            cache = kwargs.pop("block_cache", None) or DeviceBlockCache()
            backend = get_executor(backend, block_cache=cache, **kwargs)
            kwargs = {}
        from mdanalysis_mpi_tpu_torch.analysis.align import AverageStructure

        avg = AverageStructure(
            self._universe, select=self._select, ref_frame=self._ref_frame,
            select_only=True, verbose=self._verbose,
        ).run(start, stop, step, frames=frames, backend=backend,
              batch_size=batch_size, resilient=resilient, **kwargs)
        # raw dict access: keep a device-resident average on device
        self._ref_sel = avg.results["positions"]
        out = super().run(start, stop, step, frames=frames,
                          backend=backend, batch_size=batch_size,
                          resilient=resilient, **kwargs)
        if resilient:
            # pass 2 overwrote results.reliability with its own report;
            # merge pass 1's back in (the average the components were
            # fit against may have dropped frames or run degraded)
            from mdanalysis_mpi_tpu_torch.reliability.policy import (
                merge_reliability_results,
            )

            self.results.reliability = merge_reliability_results(
                avg.results.get("reliability"),
                self.results.get("reliability"))
        return out

    def _prepare(self):
        u = self._universe
        ag = u.select_atoms(self._select)
        if ag.n_atoms == 0:
            raise ValueError(f"selection {self._select!r} matched no atoms")
        self._idx = ag.indices
        self._weights = ag.masses
        dim = 3 * len(self._idx)
        if dim > 24_000:
            raise ValueError(
                f"selection spans {len(self._idx)} atoms -> a "
                f"{dim}x{dim} covariance; PCA is meant for "
                "Cα/backbone-scale selections (reduce the selection)")
        if self._align:
            from mdanalysis_mpi_tpu_torch.analysis.rms import \
                center_reference

            # a device pass 1 leaves the average on the device: it is
            # centred there
            self._ref_c, self._ref_com = center_reference(
                self._ref_sel, self._weights)
        self._t = 0.0
        self._sx = np.zeros(dim, dtype=np.float64)
        self._sxx = np.zeros((dim, dim), dtype=np.float64)
        # the serial path caches the host copy of the centered reference
        # in _single_frame; a second run() recomputes _ref_c/_ref_com
        # above, so the cache must not survive into it
        self._ref_np = None

    # -- serial path --

    def _single_frame(self, ts):
        x = ts.positions[self._idx].astype(np.float64)
        if self._align:
            ref_np = getattr(self, "_ref_np", None)
            if ref_np is None:
                ref_np = (np.asarray(to_numpy(self._ref_c), np.float64),
                          np.asarray(to_numpy(self._ref_com), np.float64))
                self._ref_np = ref_np
            com = host.weighted_center(x, self._weights)
            xc = x - com
            r = host.qcp_rotation(xc, ref_np[0])
            x = xc @ r + ref_np[1]
        v = x.reshape(-1)
        self._t += 1.0
        self._sx += v
        self._sxx += np.outer(v, v)

    def _serial_summary(self):
        return (self._t, self._sx, self._sxx)

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        return _aligned_cov_kernel if self._align else _cov_kernel

    def _batch_params(self):
        if not self._align:
            return None
        return tuple(torch.as_tensor(x, dtype=torch.float32)
                     for x in (self._weights, self._ref_c, self._ref_com))

    _device_combine = staticmethod(tree_psum)
    _device_fold_fn = staticmethod(tree_add)

    def _identity_partials(self):
        dim = 3 * len(self._idx)
        return (0.0, np.zeros(dim), np.zeros((dim, dim)))

    def _conclude(self, total):
        t, sx, sxx = total
        if self.n_frames < 2:
            raise ValueError("PCA needs at least 2 frames")
        k = self._n_components or 3 * len(self._idx)
        n_sel = len(self._idx)
        if isinstance(sxx, torch.Tensor):
            def _finalize():
                mean, cov, vals, vecs = _eig(
                    torch.as_tensor(t, device=sxx.device), sx, sxx)
                c = torch.cumsum(vals, dim=0)
                return {"mean": mean.reshape(n_sel, 3), "cov": cov,
                        "variance": vals[:k],
                        "cumulated_variance": (c / c[-1])[:k],
                        "p_components": vecs[:, :k]}

            g = deferred_group(_finalize)
            for key in ("mean", "cov", "variance", "cumulated_variance",
                        "p_components"):
                self.results[key] = g[key]
            return
        mean = (sx / t).reshape(n_sel, 3)
        cov = (sxx - np.outer(sx, sx) / t) / (t - 1.0)
        vals, vecs = np.linalg.eigh(cov)
        vals = vals[::-1].copy()
        vecs = vecs[:, ::-1].copy()
        c = np.cumsum(vals)
        cumulated = (c / c[-1])[:k]
        self.results.mean = mean
        self.results.cov = cov
        self.results.variance = vals[:k]
        self.results.cumulated_variance = cumulated
        self.results.p_components = vecs[:, :k]

    def transform(self, atomgroup, n_components: int | None = None,
                  start=None, stop=None, step=None,
                  batch_size: int = 64, device=None) -> np.ndarray:
        """Project ``atomgroup``'s frames onto the fitted components →
        (n_frames, k) float32.  One (B, 3S)·(3S, k) matmul per block on
        ``device`` (``cuda`` unless given); frames are aligned the same
        way the fit was."""
        if "p_components" not in self.results:
            raise RuntimeError("run() the PCA before transform()")
        u = atomgroup.universe
        idx = atomgroup.indices
        if len(idx) != len(self._idx):
            raise ValueError(
                f"atomgroup has {len(idx)} atoms, PCA was fitted on "
                f"{len(self._idx)}")
        from mdanalysis_mpi_tpu_torch.device import resolve_device

        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        comps = f32(self.results.p_components)
        k = n_components or comps.shape[1]
        comps = comps[:, :k]
        mean_flat = f32(self.results.mean).reshape(-1)
        align = self._align
        if align:
            from mdanalysis_mpi_tpu_torch.ops.align import (
                superpose_selection_batch)

            params = tuple(f32(x) for x in (self._weights, self._ref_c,
                                            self._ref_com))

        def project(batch):
            if align:
                batch = superpose_selection_batch(batch, *params)
            x = batch.reshape(batch.shape[0], -1) - mean_flat
            return x @ comps

        traj = u.trajectory
        # window over the TARGET group's trajectory (which may differ
        # from the fitted universe's)
        frames = list(range(*slice(start, stop, step).indices(traj.n_frames)))
        out = np.empty((len(frames), k), dtype=np.float32)
        for a in range(0, len(frames), batch_size):
            chunk = frames[a:a + batch_size]
            if chunk and chunk[-1] - chunk[0] + 1 == len(chunk):
                block, _ = traj.read_block(chunk[0], chunk[-1] + 1, sel=idx)
            else:
                block = np.stack([traj[i].positions[idx] for i in chunk])
            out[a:a + len(chunk)] = to_numpy(project(f32(block)))
        return out


def cosine_content(pca_space: np.ndarray, i: int) -> float:
    """Cosine content of PCA projection ``i`` (upstream
    ``analysis.pca.cosine_content``):

        c_i = (2/T) · ( Σ_t cos(π·i'·t/T)·p_i(t) )² / Σ_t p_i(t)²

    with i' = i+1 (the first projection compares against a half
    cosine).  Values near 1 indicate random-diffusion-like sampling
    (Hess 2000); near 0, converged sampling along that mode.
    """
    p = np.asarray(pca_space, np.float64)
    if p.ndim != 2:
        raise ValueError(
            f"pca_space must be (n_frames, n_components), got {p.shape}")
    if not 0 <= i < p.shape[1]:
        raise IndexError(
            f"component {i} out of range for {p.shape[1]} components")
    t = p.shape[0]
    if t < 3:
        raise ValueError("cosine content needs at least 3 frames")
    series = p[:, i]
    cos = np.cos(np.pi * (i + 1) * np.arange(t) / t)
    # upstream integrates with Simpson's rule (scipy.integrate.simps);
    # composite Simpson here, last interval by trapezoid when the
    # sample count is even (documented O(1/T³)-class divergence from
    # scipy's even='avg' treatment — far below sampling noise)
    num = _simpson(cos * series)
    denom = _simpson(series ** 2)
    if denom == 0.0:
        return 0.0
    return float(2.0 / t * num ** 2 / denom)


def _simpson(y: np.ndarray) -> float:
    """Composite Simpson integral of unit-spaced samples; even sample
    counts close with one trapezoid panel (see cosine_content note)."""
    n = len(y)
    end = n if n % 2 == 1 else n - 1
    s = float(y[0] + y[end - 1]
              + 4.0 * y[1:end - 1:2].sum() + 2.0 * y[2:end - 1:2].sum()) / 3.0
    if n % 2 == 0:
        s += 0.5 * float(y[-2] + y[-1])
    return s
