"""InterRDF: radial distribution function between two AtomGroups
(BASELINE config 4: O-O RDF of a TIP3P water box).

API mirrors upstream ``MDAnalysis.analysis.rdf.InterRDF``:
``InterRDF(g1, g2, nbins=75, range=(0, 15)).run()`` →
``.results.bins / .results.rdf / .results.count``.

Normalization: ``g(r) = counts / (T · N_pairs · ρ_pair · V_shell)``
with ρ_pair = 1/⟨V_box⟩ per pair — i.e. the standard
``g(r) = ⟨V⟩ · counts / (T · N_A · N_B · V_shell)`` with self-pairs
excluded when the groups are identical.

Engines keep the JAX package's names, so user code ports unchanged:
``'pallas'`` is the hand-written CUDA pair-histogram kernel
(:mod:`mdanalysis_mpi_tpu_torch.ops.fused_distances`; its plain torch
version on the CPU), ``'xla'`` the generic torch-op engine
(:mod:`mdanalysis_mpi_tpu_torch.ops.distances`), ``'auto'`` picks
between them, and ``'ring'`` is the atom-sharded multi-device engine
(:mod:`mdanalysis_mpi_tpu_torch.ops.ring`; ``backend='mesh'`` only,
float32 staging).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase,
                                                    _materialize,
                                                    deferred_group, to_numpy,
                                                    tree_add, tree_psum)
from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
from mdanalysis_mpi_tpu_torch.ops import host
from mdanalysis_mpi_tpu_torch.ops._boxmat import batch_box_volumes


@functools.lru_cache(maxsize=None)
def _rdf_kernel(exclude_self: bool, tile: int, engine: str,
                exclusion_block: tuple | None = None):
    """Batch function of one engine: ``'pallas'`` (the CUDA kernel —
    orthorhombic boxes; ``tile`` unused, the kernel has its own tiling)
    or ``'xla'`` (generic searchsorted + scatter-add).  Params are
    ``(loc_a, loc_b, edges)``, the groups' positions in the staged union
    and the float32 bin edges."""
    def kernel(params, batch, boxes, mask):
        loc_a, loc_b, edges = params
        if engine == "pallas":
            from mdanalysis_mpi_tpu_torch.ops import fused_distances

            counts, vol_sum, t = fused_distances.pair_histogram_batch(
                batch[:, loc_a], batch[:, loc_b], boxes, mask, edges,
                exclude_self=exclude_self)
        else:
            from mdanalysis_mpi_tpu_torch.ops.distances import (
                pair_histogram_batch)

            counts, vol_sum, t = pair_histogram_batch(
                batch[:, loc_a], batch[:, loc_b], boxes, mask, edges,
                exclude_self=exclude_self, tile=tile,
                exclusion_block=exclusion_block)
        # n_boxed: frames carrying a real (non-zero-volume) box.  A frame
        # without a box is staged as a zero box, which would silently
        # deflate <V> and unwrap distances — _conclude rejects runs where
        # n_boxed != T (the batch-path image of the serial per-frame check).
        vols = batch_box_volumes(boxes)
        n_boxed = ((vols > 0.0) * mask).sum()
        return counts, vol_sum, t, n_boxed

    return kernel


# Ring-engine atom padding: the union atom array is padded to a multiple
# of this so it divides evenly across any power-of-two device count
# (padded entries carry weight 0 and vanish).
_RING_PAD = 512


@functools.lru_cache(maxsize=None)
def _rdf_ring_kernel(exclude_self: bool, tile: int):
    """Atom-sharded ring engine (ops.ring): each device holds a block of
    the staged union; group membership travels as weights; the B side
    rotates around the devices.  Ring convention: every argument is a
    list with one entry per local device, plus the process group's
    collectives (or None); returns one partials tuple per device."""
    def kernel(params, batch, boxes, mask, comm):
        from mdanalysis_mpi_tpu_torch.ops.ring import ring_rdf_batch

        w_a, w_b, edges = zip(*params)
        return ring_rdf_batch(list(batch), list(w_a), list(w_b),
                              list(boxes), list(mask), list(edges),
                              exclude_self=exclude_self, tile=tile,
                              comm=comm)

    return kernel


class InterRDF(AnalysisBase):
    """Radial distribution function g(r) between two groups."""

    def __init__(self, g1: AtomGroup, g2: AtomGroup, nbins: int = 75,
                 range: tuple[float, float] = (0.0, 15.0),
                 tile: int = 1024, engine: str = "auto",
                 exclusion_block: tuple[int, int] | None = None,
                 norm: str = "rdf", verbose: bool = False):
        if g1.universe is not g2.universe:
            raise ValueError("g1 and g2 must belong to the same Universe")
        if norm not in ("rdf", "density", "none"):
            raise ValueError(
                f"norm must be 'rdf', 'density' or 'none', got {norm!r}")
        if engine not in ("auto", "pallas", "xla", "ring"):
            raise ValueError(
                f"engine must be 'auto', 'pallas', 'xla' or 'ring', "
                f"got {engine!r}")
        if exclusion_block is not None:
            p, q = (int(exclusion_block[0]), int(exclusion_block[1]))
            if p < 1 or q < 1:
                raise ValueError(
                    f"exclusion_block entries must be >= 1, got "
                    f"{exclusion_block}")
            if g1.n_atoms % p or g2.n_atoms % q:
                raise ValueError(
                    f"exclusion_block {(p, q)} does not tile the groups "
                    f"({g1.n_atoms}, {g2.n_atoms} atoms)")
            if engine in ("pallas", "ring"):
                raise ValueError(
                    "exclusion_block is implemented on the 'xla' engine "
                    "(auto resolves there automatically)")
            exclusion_block = (p, q)
        super().__init__(g1.universe, verbose)
        self._g1 = g1
        self._g2 = g2
        self._nbins = int(nbins)
        self._range = (float(range[0]), float(range[1]))
        self._tile = int(tile)
        self._engine = engine
        self._norm = norm
        self._exclusion_block = exclusion_block

    def _prepare(self):
        if self._g1.n_atoms == 0 or self._g2.n_atoms == 0:
            raise ValueError("InterRDF groups must be non-empty")
        if self._universe.trajectory.ts.dimensions is None:
            raise ValueError(
                "InterRDF requires a periodic box (trajectory has none)")
        self._edges = np.linspace(self._range[0], self._range[1],
                                  self._nbins + 1)
        # union staging: both groups gathered once, local indices within
        union = np.union1d(self._g1.indices, self._g2.indices)
        if self._engine == "ring":
            # pad the union so it divides across any power-of-two device
            # count; padded slots restage atom 0 with weight 0 (ops.ring)
            pad = (-len(union)) % _RING_PAD
            self._union = np.concatenate(
                [union, np.zeros(pad, dtype=union.dtype)])
            w_a = np.zeros(len(self._union), dtype=np.float32)
            w_b = np.zeros(len(self._union), dtype=np.float32)
            w_a[np.searchsorted(union, self._g1.indices)] = 1.0
            w_b[np.searchsorted(union, self._g2.indices)] = 1.0
            self._ring_weights = (w_a, w_b)
        else:
            self._union = union
        self._loc_a = np.searchsorted(union, self._g1.indices)
        self._loc_b = np.searchsorted(union, self._g2.indices)
        self._identical = (len(self._g1.indices) == len(self._g2.indices)
                           and np.array_equal(self._g1.indices,
                                              self._g2.indices))
        self._counts = np.zeros(self._nbins, dtype=np.float64)
        self._vol_sum = 0.0
        self._t = 0
        self._resolved_engine = None     # per-run; see _resolve_engine

    def _resolve_engine(self) -> str:
        """Pick the batch histogram engine, once per run (the batch
        function and its params must agree).  ``'auto'`` takes the CUDA
        kernel (``'pallas'``) on a CUDA device when the current frame's
        box is orthorhombic (atol 1e-4 degrees, rtol 0), there is no
        ``exclusion_block``, ``nbins <= MAX_NBINS`` and the edges are
        uniform; otherwise, and on the CPU, the generic ``'xla'`` engine.
        Frames that turn triclinic later are NaN-poisoned by the kernel
        route and rejected in ``_conclude`` rather than mis-wrapped.
        Before a run the device is the default one (``cuda`` when
        present)."""
        cached = getattr(self, "_resolved_engine", None)
        if cached is not None:
            return cached
        if self._engine != "auto":
            self._resolved_engine = self._engine
            return self._engine
        from mdanalysis_mpi_tpu_torch.ops import fused_distances

        dev = getattr(self, "_run_device", None)
        on_cuda = (dev.type == "cuda" if dev is not None
                   else torch.cuda.is_available())
        dims = self._universe.trajectory.ts.dimensions
        # rtol=0: the default rtol adds ~9e-4 deg of slack at 90 deg,
        # 10x looser than minimum_image's 1e-4 ortho classification
        ortho = dims is None or np.allclose(dims[3:], 90.0,
                                            rtol=0.0, atol=1e-4)
        self._resolved_engine = (
            "pallas" if (on_cuda and ortho
                         and self._exclusion_block is None
                         and self._nbins <= fused_distances.MAX_NBINS
                         and fused_distances.uniform_edges(self._edges))
            else "xla")
        return self._resolved_engine

    # -- serial path --

    def _single_frame(self, ts):
        from mdanalysis_mpi_tpu_torch.core.box import box_to_vectors

        box = ts.dimensions
        vol = (0.0 if box is None
               else abs(np.linalg.det(box_to_vectors(box))))
        if vol == 0.0:
            raise ValueError(
                f"InterRDF: frame {ts.frame} has no periodic box; every "
                "frame must carry one for g(r) normalization")
        a = ts.positions[self._g1.indices].astype(np.float64)
        b = ts.positions[self._g2.indices].astype(np.float64)
        self._counts += host.pair_histogram(
            a, b, self._edges, box=box.astype(np.float64),
            exclude_self=self._identical,
            exclusion_block=self._exclusion_block)
        self._vol_sum += vol
        self._t += 1

    def _serial_summary(self):
        # serial path raises per frame on a missing box, so n_boxed == T
        return (self._counts, self._vol_sum, float(self._t), float(self._t))

    # -- batch path --

    def _batch_select(self):
        return self._union

    def _batch_fn(self):
        if self._resolve_engine() == "ring":
            return _rdf_ring_kernel(self._identical, self._tile)
        return _rdf_kernel(self._identical, self._tile,
                           self._resolve_engine(), self._exclusion_block)

    def _batch_params(self):
        if self._resolve_engine() == "ring":
            w_a, w_b = self._ring_weights
            return (w_a, w_b, self._edges.astype(np.float32))
        return (self._loc_a, self._loc_b, self._edges.astype(np.float32))

    @property
    def _mesh_only(self):
        return self._engine == "ring"

    def _batch_specs(self):
        if self._resolve_engine() != "ring":
            return None
        # params (w_a, w_b, edges) cut along the union's atom axis but
        # the edges; batch (B, N, 3) along its atom axis; boxes and
        # mask whole on every device
        return ((0, 0, None), 1, None, None)

    _device_fold_fn = staticmethod(tree_add)
    _device_combine = staticmethod(tree_psum)

    def _identity_partials(self):
        return (np.zeros(self._nbins), 0.0, 0.0, 0.0)

    def _conclude(self, total):
        if self.n_frames == 0:
            raise ValueError("InterRDF over zero frames")
        edges = self._edges
        self.results.bins = 0.5 * (edges[1:] + edges[:-1])
        self.results.edges = edges

        # The normalization needs the histogram on the host — a device
        # fetch that must not happen inside run() (base.Deferred), so the
        # whole finalize (including its diagnostics) runs on first
        # access of .results.count / .results.rdf.
        resolved_engine = getattr(self, "_resolved_engine", None)
        identical = self._identical
        norm = self._norm
        n_a, n_b = self._g1.n_atoms, self._g2.n_atoms
        # pairs the kernels never count must leave the normalization too
        # (upstream subtracts xA·xB·nblocks); computed exactly, including
        # the diagonal/block overlap when the groups are identical
        n_excluded = n_a if identical else 0
        if self._exclusion_block is not None:
            p, q = self._exclusion_block
            ia = np.arange(n_a) // p
            ib = np.arange(n_b) // q
            m = min(ia[-1], ib[-1]) + 1
            ca = np.bincount(ia, minlength=m)[:m]
            cb = np.bincount(ib, minlength=m)[:m]
            block_pairs = int((ca * cb).sum())
            if identical:
                # diagonal pairs not already inside a block exclusion
                diag_extra = int(np.sum(ia != ib[:n_a]))
                n_excluded = block_pairs + diag_extra
            else:
                n_excluded = block_pairs

        def _finalize():
            counts = np.asarray(to_numpy(total[0]), np.float64)
            vol_sum, t = float(to_numpy(total[1])), float(to_numpy(total[2]))
            if t == 0:
                raise ValueError("InterRDF over zero frames")
            if not np.isfinite(counts).all():
                if resolved_engine == "pallas":
                    raise ValueError(
                        "InterRDF: non-finite histogram counts — the "
                        "'pallas' engine (the CUDA pair-histogram kernel) "
                        "NaN-poisons frames with triclinic boxes (its "
                        "minimum-image wrap is orthorhombic-only); rerun "
                        "with engine='xla'")
                raise ValueError(
                    "InterRDF: non-finite histogram counts — check the "
                    "trajectory for NaN/inf coordinates or box "
                    "dimensions")
            n_boxed = float(to_numpy(total[3]))
            if n_boxed != t:
                raise ValueError(
                    f"InterRDF: {int(t - n_boxed)} of {int(t)} frames "
                    "have no periodic box; every frame must carry one "
                    "for g(r) normalization")
            vols = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
            n_pairs = n_a * n_b - n_excluded
            density = n_pairs / (vol_sum / t)
            if norm == "rdf":
                rdf = counts / (density * vols * t)
            elif norm == "density":
                # pair count per shell volume per frame (upstream
                # norm='density': the un-normalized pair density)
                rdf = counts / (vols * t)
            else:
                rdf = counts.copy()
            return {"count": counts, "rdf": rdf}

        group = deferred_group(_finalize)
        self.results.count = group["count"]
        self.results.rdf = group["rdf"]


# ---- site-resolved RDF (upstream InterRDF_s) ----

def _rdf_s_kernel(params, batch, boxes, mask):
    """Per-SITE-pair histograms: every (i, j) site combination of every
    ags pair is one row of a flat pair list, so the whole analysis is
    P scalar distances per frame + one scatter — static shapes, any
    number of ags pairs in one batch function."""
    from mdanalysis_mpi_tpu_torch.ops.distances import _sq_norm
    from mdanalysis_mpi_tpu_torch.ops.distances import minimum_image as mi

    loc_a, loc_b, edges = params
    p = loc_a.shape[0]
    nb = edges.shape[0] - 1
    base = torch.arange(p, device=batch.device) * (nb + 1)

    def per_frame(x, box6):
        d = torch.sqrt(_sq_norm(mi(x[loc_a] - x[loc_b], box6)))   # (P,)
        k = torch.searchsorted(edges, d, right=True) - 1
        inside = (d >= edges[0]) & (d < edges[-1]) & (k >= 0) & (k < nb)
        flat = base + torch.where(inside, k, nb)
        return torch.zeros(p * (nb + 1), dtype=torch.float32,
                           device=batch.device).index_add_(
            0, flat, torch.ones(p, dtype=torch.float32,
                                device=batch.device))

    hists = torch.stack([per_frame(x, box6) for x, box6 in zip(batch, boxes)])
    m = mask.to(torch.float32)
    counts = (hists * m[:, None]).sum(0)
    vols = batch_box_volumes(boxes)
    vol_sum = (vols * m).sum()
    n_boxed = ((vols > 0.0) * m).sum()
    return counts, vol_sum, m.sum(), n_boxed


class InterRDF_s(AnalysisBase):
    """Site-resolved RDF (upstream ``rdf.InterRDF_s``): one g(r) per
    ATOM PAIR for each ``(g1, g2)`` entry of ``ags``.

    ``InterRDF_s(u, [(s1, s2), ...]).run()`` → ``results.rdf`` /
    ``results.count``: lists, entry k of shape (len(g1ₖ), len(g2ₖ),
    nbins); ``results.bins`` / ``results.edges`` shared.  Norms match
    :class:`InterRDF` with N_pairs = 1 per site pair.  ``get_cdf()``
    returns the per-pair cumulative ⟨count within r⟩ (upstream method).
    """

    def __init__(self, universe, ags, nbins: int = 75,
                 range: tuple[float, float] = (0.0, 15.0),
                 norm: str = "rdf", verbose: bool = False):
        if norm not in ("rdf", "density", "none"):
            raise ValueError(
                f"norm must be 'rdf', 'density' or 'none', got {norm!r}")
        pairs = list(ags)
        if not pairs:
            raise ValueError("InterRDF_s needs at least one (g1, g2) pair")
        for k, entry in enumerate(pairs):
            if (not isinstance(entry, (tuple, list)) or len(entry) != 2
                    or not all(isinstance(g, AtomGroup) for g in entry)):
                raise ValueError(
                    f"ags[{k}] must be an (AtomGroup, AtomGroup) pair")
            if any(g.universe is not universe for g in entry):
                raise ValueError(
                    f"ags[{k}] does not belong to the given universe")
            if any(g.n_atoms == 0 for g in entry):
                raise ValueError(f"ags[{k}] contains an empty group")
        super().__init__(universe, verbose)
        self._ags = pairs
        self._nbins = int(nbins)
        self._range = (float(range[0]), float(range[1]))
        self._norm = norm

    def _prepare(self):
        if self._universe.trajectory.ts.dimensions is None:
            raise ValueError(
                "InterRDF_s requires a periodic box (trajectory has none)")
        self._edges = np.linspace(self._range[0], self._range[1],
                                  self._nbins + 1)
        self._shapes = [(g1.n_atoms, g2.n_atoms) for g1, g2 in self._ags]
        total_pairs = int(sum(a * b for a, b in self._shapes))
        if total_pairs * (self._nbins + 1) > 20_000_000:
            raise ValueError(
                f"{total_pairs} site pairs x {self._nbins} bins exceeds "
                "the per-pair histogram budget; InterRDF_s is for small "
                "site groups (use InterRDF for bulk g(r))")
        union = np.union1d(
            np.concatenate([np.concatenate([g1.indices, g2.indices])
                            for g1, g2 in self._ags]), [])
        self._union = union.astype(np.int64)
        loc_a, loc_b = [], []
        for g1, g2 in self._ags:
            a = np.searchsorted(union, g1.indices)
            b = np.searchsorted(union, g2.indices)
            loc_a.append(np.repeat(a, len(b)))
            loc_b.append(np.tile(b, len(a)))
        self._loc_a = np.concatenate(loc_a).astype(np.int64)
        self._loc_b = np.concatenate(loc_b).astype(np.int64)
        p = len(self._loc_a)
        self._counts = np.zeros(p * (self._nbins + 1), dtype=np.float64)
        self._vol_sum = 0.0
        self._t = 0
        self._n_boxed = 0

    # -- serial path --

    def _single_frame(self, ts):
        if ts.dimensions is None:
            raise ValueError(
                f"frame {ts.frame} has no box; every frame must carry "
                "one for g(r) normalization")
        x = ts.positions[self._union].astype(np.float64)
        disp = host.minimum_image(x[self._loc_a] - x[self._loc_b],
                                  ts.dimensions)
        d = np.sqrt((disp ** 2).sum(-1))
        nb = self._nbins
        k = np.searchsorted(self._edges, d, side="right") - 1
        inside = (d >= self._edges[0]) & (d < self._edges[-1]) \
            & (k >= 0) & (k < nb)
        flat = (np.arange(len(d)) * (nb + 1)
                + np.where(inside, k, nb))
        np.add.at(self._counts, flat, 1.0)
        from mdanalysis_mpi_tpu_torch.lib.mdamath import box_volume

        vol = float(box_volume(ts.dimensions))
        if vol <= 0.0:
            # same contract as InterRDF's serial path and this class's
            # own batch n_boxed guard: a zero-volume box must fail, not
            # silently deflate <V>
            raise ValueError(
                f"frame {ts.frame} has a zero-volume box; every frame "
                "must carry a real box for g(r) normalization")
        self._vol_sum += vol
        self._t += 1
        self._n_boxed += 1

    def _serial_summary(self):
        return (self._counts, self._vol_sum, float(self._t),
                float(self._n_boxed))

    # -- batch path --

    def _batch_select(self):
        return self._union

    def _batch_fn(self):
        return _rdf_s_kernel

    def _batch_params(self):
        return (self._loc_a, self._loc_b, self._edges.astype(np.float32))

    _device_fold_fn = staticmethod(tree_add)
    _device_combine = staticmethod(tree_psum)

    def _identity_partials(self):
        return (np.zeros(len(self._loc_a) * (self._nbins + 1)),
                0.0, 0.0, 0.0)

    def _conclude(self, total):
        edges = self._edges
        nb = self._nbins
        shapes = self._shapes
        norm = self._norm
        self.results.edges = edges
        self.results.bins = 0.5 * (edges[:-1] + edges[1:])

        def _finalize():
            counts = np.asarray(to_numpy(total[0]), np.float64)
            vol_sum, t, n_boxed = (float(to_numpy(total[1])),
                                   float(to_numpy(total[2])),
                                   float(to_numpy(total[3])))
            if t == 0:
                raise ValueError("InterRDF_s over zero frames")
            if n_boxed != t:
                raise ValueError(
                    f"InterRDF_s: {int(t - n_boxed)} of {int(t)} frames "
                    "have no periodic box; every frame must carry one "
                    "for g(r) normalization")
            per_pair = counts.reshape(-1, nb + 1)[:, :nb]
            vols = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
            if norm == "rdf":
                flat = per_pair * (vol_sum / t) / (vols * t)
            elif norm == "density":
                flat = per_pair / (vols * t)
            else:
                flat = per_pair.copy()
            count_list, rdf_list, lo = [], [], 0
            for n1, n2 in shapes:
                count_list.append(
                    per_pair[lo:lo + n1 * n2].reshape(n1, n2, nb))
                rdf_list.append(
                    flat[lo:lo + n1 * n2].reshape(n1, n2, nb))
                lo += n1 * n2
            return {"count": count_list, "rdf": rdf_list, "t": t}

        group = deferred_group(_finalize)
        self.results.count = group["count"]
        self.results.rdf = group["rdf"]
        self._t_deferred = group["t"]

    def get_cdf(self):
        """Per-pair cumulative mean count within r (upstream method):
        list of (n1, n2, nbins) arrays, entry k for ags[k]."""
        counts = self.results.count          # shares the one finalize
        t = float(_materialize(self._t_deferred))
        return [c.cumsum(axis=-1) / t for c in counts]
