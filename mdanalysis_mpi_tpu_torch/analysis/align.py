"""Structure alignment: AverageStructure and AlignTraj.

The serial-oracle API of the reference docstring:
``align.AverageStructure(u, u, select=..., ref_frame=0).run()`` →
``.results.universe`` (RMSF.py:9-10) and ``align.AlignTraj(u, ref,
select=..., in_memory=True).run()`` (RMSF.py:12), re-implemented as
batched analyses on torch tensors (the reference's pass 1,
RMSF.py:76-113); plus the one-frame ``alignto``, ``rotation_matrix``
and ``sequence_alignment`` of upstream's ``align`` module.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase, Deferred,
                                                    to_numpy, tree_add,
                                                    tree_psum)
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.ops import host
from mdanalysis_mpi_tpu_torch.parallel.partition import iter_batches, pad_batch


# ---- module-level batch functions ----

def _avg_all_kernel(params, batch, boxes, mask):
    """Aligned all-atom masked sum: partials (T, Σ aligned) — pass 1 wide
    path (RMSF.py:89-103)."""
    del boxes
    from mdanalysis_mpi_tpu_torch.ops.align import superpose_batch

    sel_idx, w, ref_c, ref_com = params
    aligned = superpose_batch(batch, sel_idx, w, ref_c, ref_com)
    return mask.sum(), torch.einsum("b,bni->ni", mask, aligned)


def _avg_sel_kernel(params, batch, boxes, mask):
    """Aligned selection-only masked sum (lean pass-1 path)."""
    del boxes
    from mdanalysis_mpi_tpu_torch.ops.align import superpose_selection_batch

    w, ref_c, ref_com = params
    aligned = superpose_selection_batch(batch, w, ref_c, ref_com)
    return mask.sum(), torch.einsum("b,bni->ni", mask, aligned)


def _reference_sel_coords(reference: Universe, sel_idx, weights,
                          ref_frame: int):
    """Centered float64 selection coords + COM of ``ref_frame``, with the
    cursor save/restore the reference wraps in try/finally
    (RMSF.py:80-87)."""
    traj = reference.trajectory
    current = traj.ts.frame
    try:
        ts = traj[ref_frame]
        sel = ts.positions[sel_idx].astype(np.float64)
        com = host.weighted_center(sel, weights)
        return sel - com, com
    finally:
        traj[current]


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


class AverageStructure(AnalysisBase):
    """Time-averaged structure after per-frame superposition.

    The reference's pass 1 (RMSF.py:76-113): superpose every frame onto
    ``ref_frame`` of ``reference`` using ``select`` (rotation fit on the
    selection, applied to all atoms — quirk Q5), average, and expose the
    result as ``.results.positions`` plus an in-memory
    ``.results.universe`` (the RMSF.py:113 rebuild).

    ``select_only=True`` averages just the selection (lean path: enough
    for a downstream RMSF of the same selection).  ``engine='fused'``
    (select_only only) consumes the quantized staged block directly
    through the fused kernel (ops/fused_rmsf.py).
    """

    def __init__(self, mobile: Universe, reference: Universe | None = None,
                 select: str = "all", ref_frame: int = 0,
                 select_only: bool = False, verbose: bool = False,
                 engine: str | None = None):
        super().__init__(mobile, verbose)
        self._reference = reference if reference is not None else mobile
        self._select = select
        self._ref_frame = ref_frame
        self._select_only = select_only
        from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import validate_engine

        validate_engine(engine)
        if engine == "fused" and not select_only:
            raise ValueError(
                "engine='fused' requires select_only=True (the wide "
                "all-atom path has no fused kernel)")
        self._engine = engine

    def _prepare(self):
        u = self._universe
        ag = u.select_atoms(self._select)
        if ag.n_atoms == 0:
            raise ValueError(f"selection {self._select!r} matched no atoms")
        self._sel_idx = ag.indices
        self._weights = ag.masses
        self._ref_sel_c, self._ref_com = _reference_sel_coords(
            self._reference, self._sel_idx, self._weights, self._ref_frame)
        n_out = len(self._sel_idx) if self._select_only else u.topology.n_atoms
        self._acc = np.zeros((n_out, 3), dtype=np.float64)
        self._count = 0

    # -- serial path --

    def _single_frame(self, ts):
        aligned = host.superpose_frame(
            ts.positions, self._sel_idx, self._weights,
            self._ref_sel_c, self._ref_com)
        self._acc += aligned[self._sel_idx] if self._select_only else aligned
        self._count += 1

    def _serial_summary(self):
        return (float(self._count), self._acc)

    # -- batch path --

    def _batch_select(self):
        return self._sel_idx if self._select_only else None

    def _batch_fn(self):
        return _avg_sel_kernel if self._select_only else _avg_all_kernel

    def _quantized_batch(self, transfer_dtype: str):
        """Fused quantized-native path (executors._quantized_native):
        lean pass-1 average straight off the staged block.  Only the
        select_only form qualifies."""
        if not self._select_only:
            return None
        from mdanalysis_mpi_tpu_torch.ops import fused_rmsf

        return fused_rmsf.quantized_batch(
            "avg", self._engine, transfer_dtype, self._sel_idx,
            self._ref_sel_c, self._ref_com, self._weights)

    def _batch_params(self):
        params = (_f32(self._weights), _f32(self._ref_sel_c),
                  _f32(self._ref_com))
        if self._select_only:
            return params
        return (torch.as_tensor(self._sel_idx),) + params

    _device_fold_fn = staticmethod(tree_add)
    _device_combine = staticmethod(tree_psum)

    def _identity_partials(self):
        return (0.0, np.zeros_like(self._acc))

    def _conclude(self, total):
        t, s = total
        # zero-frame guard via the host-known frame count: reading the
        # device count would synchronize
        if self.n_frames == 0:
            raise ValueError("AverageStructure over zero frames")
        avg = s / t
        self.results.positions = avg
        if self._select_only:
            self.results.universe = None
        else:
            # RMSF.py:113: rebuild a single-frame in-memory universe —
            # deferred, because the rebuild reads the average back
            topology = self._universe.topology

            def _build_universe():
                avg_np = np.asarray(to_numpy(avg), np.float64)
                return Universe(topology, avg_np[None].astype(np.float32))

            self.results.universe = Deferred(_build_universe)


class AlignTraj(AnalysisBase):
    """Align a whole trajectory to a reference frame.

    Serial-oracle API: ``AlignTraj(u, ref, select=..., in_memory=True)
    .run()`` (RMSF.py:12).  With ``in_memory=True`` the mobile
    Universe's trajectory is replaced by an aligned in-memory copy; with
    ``in_memory=False`` (the upstream default workflow) the aligned
    frames are **streamed to ``filename``** in batches through
    :class:`~mdanalysis_mpi_tpu_torch.io.writer.TrajectoryWriter` —
    never more than one batch on the host — and ``.results.universe``
    opens the written file (``filename`` defaults to ``prefix`` + the
    mobile trajectory's basename, upstream convention).  Per-frame old
    RMSD values are not tracked (use
    :class:`~mdanalysis_mpi_tpu_torch.analysis.rms.RMSD`).

    This is a *map* (frame→frame), not a reduction, so it drives the
    batch function directly rather than through the executors:
    ``backend="torch"`` (the default) superposes each batch on
    ``device`` (``cuda`` unless told otherwise) and brings it back to
    the host; ``"serial"`` uses the host QCP path.
    """

    def __init__(self, mobile: Universe, reference: Universe | None = None,
                 select: str = "all", ref_frame: int = 0,
                 in_memory: bool = True, filename: str | None = None,
                 prefix: str = "rmsfit_", verbose: bool = False):
        super().__init__(mobile, verbose)
        self._reference = reference if reference is not None else mobile
        self._select = select
        self._ref_frame = ref_frame
        self._in_memory = in_memory
        if not in_memory and filename is None:
            src = getattr(mobile.trajectory, "filename", None)
            if src is None:
                raise ValueError(
                    "in_memory=False needs filename= (the mobile "
                    "trajectory is not file-backed, so there is no name "
                    f"to derive from {prefix!r})")
            head, tail = os.path.split(src)
            filename = os.path.join(head, prefix + tail)
        self.filename = filename

    def _open_writer(self, n_atoms: int, n_frames: int):
        """The streaming writer of ``in_memory=False``, after the guard
        against writing over the source trajectory."""
        if not n_frames:
            raise ValueError(
                "AlignTraj(in_memory=False) selected zero frames — "
                "nothing to write")
        traj = self._universe.trajectory
        sources = [getattr(traj, "filename", None)]
        # chained trajectories expose their segments as .filenames
        sources += list(getattr(traj, "filenames", ()) or ())
        target = os.path.abspath(self.filename)
        if any(s is not None and os.path.abspath(s) == target
               for s in sources):
            raise ValueError(
                f"output filename {self.filename!r} is (part of) the "
                "source trajectory itself — opening it for writing "
                "would destroy the input")
        from mdanalysis_mpi_tpu_torch.io.writer import TrajectoryWriter

        return TrajectoryWriter(self.filename, n_atoms=n_atoms)

    def run(self, start=None, stop=None, step=None, frames=None,
            backend: str = "torch", batch_size: int | None = 64,
            device=None):
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        if backend not in ("torch", "serial"):
            raise ValueError(
                f"unknown backend {backend!r}; available: "
                "['serial', 'torch']")
        u = self._universe
        frames = list(self._frames(start, stop, step, frames))
        self.n_frames = len(frames)
        ag = u.select_atoms(self._select)
        if ag.n_atoms == 0:
            raise ValueError(f"selection {self._select!r} matched no atoms")
        sel_idx = ag.indices
        weights = ag.masses
        ref_sel_c, ref_com = _reference_sel_coords(
            self._reference, sel_idx, weights, self._ref_frame)
        n = u.topology.n_atoms
        writer = None
        if self._in_memory:
            out = np.empty((len(frames), n, 3), dtype=np.float32)
        else:
            writer = self._open_writer(n, len(frames))
        dims = np.zeros((len(frames), 6), dtype=np.float32)
        have_dims = False

        def emit(a, b, aligned, boxes):
            # writer times/steps keep the writer's running 0..n-1 default
            # so file-backed output matches the in-memory MemoryReader's
            # frame numbering (the two modes must be interchangeable)
            nonlocal have_dims
            if writer is None:
                if boxes is not None:
                    dims[a:b] = boxes
                    have_dims = True
                out[a:b] = aligned
            else:
                writer.write(aligned, dimensions=boxes)

        try:
            if backend == "serial":
                self._run_serial(frames, sel_idx, weights, ref_sel_c,
                                 ref_com, emit, n)
            else:
                self._run_torch(frames, sel_idx, weights, ref_sel_c,
                                ref_com, emit, batch_size or 64, device)
        except BaseException:
            if writer is not None:
                # never leave a truncated-but-self-consistent file behind:
                # close() patches the DCD frame count, which would make a
                # partial alignment indistinguishable from a complete one
                writer.close()
                if os.path.exists(self.filename):
                    os.remove(self.filename)
            raise
        else:
            if writer is not None:
                writer.close()

        if self._in_memory:
            u.trajectory = MemoryReader(
                out, dimensions=dims if have_dims else None)
            self.results.universe = u
        else:
            from mdanalysis_mpi_tpu_torch.io import trajectory_files

            self.results.filename = self.filename
            self.results.universe = Universe(
                u.topology, trajectory_files.open(self.filename))
        return self

    def _run_serial(self, frames, sel_idx, weights, ref_sel_c, ref_com,
                    emit, n):
        """Host float64 superposition, frame by frame; output goes out
        in windows of up to 256 frames (one temp-file splice per window
        on the file path, not one per frame)."""
        traj = self._universe.trajectory
        flush = min(256, len(frames))
        buf = np.empty((flush, n, 3), np.float32)
        bboxes = np.zeros((flush, 6), np.float32)
        any_box = False
        lo = 0
        for j, i in enumerate(frames):
            ts = traj[i]
            if ts.dimensions is not None:
                bboxes[j - lo] = ts.dimensions
                any_box = True
            buf[j - lo] = host.superpose_frame(
                ts.positions, sel_idx, weights, ref_sel_c, ref_com)
            if j - lo + 1 == flush or j == len(frames) - 1:
                emit(lo, j + 1, buf[: j - lo + 1],
                     bboxes[: j - lo + 1] if any_box else None)
                lo = j + 1
                any_box = False
                bboxes[:] = 0   # no stale boxes next window

    def _run_torch(self, frames, sel_idx, weights, ref_sel_c, ref_com,
                   emit, bs, device):
        """Each batch of all-atom frames to ``device``, superposed there
        (``ops/align.superpose_batch``, float32), and back to the host."""
        from mdanalysis_mpi_tpu_torch.device import resolve_device
        from mdanalysis_mpi_tpu_torch.ops.align import superpose_batch
        from mdanalysis_mpi_tpu_torch.parallel.executors import _array_to

        dev = resolve_device(device)
        traj = self._universe.trajectory
        idx_d = torch.as_tensor(sel_idx, device=dev)
        w_d = _f32(weights).to(dev)
        refc_d = _f32(ref_sel_c).to(dev)
        com_d = _f32(ref_com).to(dev)
        for a, b in iter_batches(0, len(frames), bs):
            chunk = frames[a:b]
            if chunk[-1] - chunk[0] + 1 == len(chunk):
                block, boxes = traj.read_block(chunk[0], chunk[-1] + 1)
            else:
                tss = [traj[i] for i in chunk]
                block = np.stack([ts.positions for ts in tss])
                if any(ts.dimensions is not None for ts in tss):
                    # frames without a box contribute zeros (the same
                    # value the readers map to dims=None)
                    boxes = np.stack([
                        ts.dimensions if ts.dimensions is not None
                        else np.zeros(6, np.float32) for ts in tss])
                else:
                    boxes = None
            padded, _ = pad_batch(np.asarray(block, np.float32), bs)
            aligned = superpose_batch(_array_to(padded, dev), idx_d, w_d,
                                      refc_d, com_d)
            emit(a, b, aligned[: b - a].cpu().numpy(), boxes)


def rotation_matrix(mobile: np.ndarray, reference: np.ndarray,
                    weights: np.ndarray | None = None):
    """Optimal least-squares rotation of ``mobile`` onto ``reference``.

    The public form of the reference's ``get_rotation_matrix`` wrapper
    (RMSF.py:43-51, upstream ``align.rotation_matrix``): both inputs are
    (N, 3) coordinates, ALREADY CENTERED on their (weighted) origins as
    upstream requires.  Returns ``(R, rmsd)`` in the upstream
    convention — ``R`` acts on column vectors (``x' = R·x``), so the
    row-vector application is ``mobile @ R.T`` — and ``rmsd`` is the
    minimal (weighted) RMSD after rotation.  Host float64.
    """
    mobile = np.asarray(mobile, np.float64)
    reference = np.asarray(reference, np.float64)
    if mobile.shape != reference.shape or mobile.ndim != 2 \
            or mobile.shape[1] != 3:
        raise ValueError(
            f"mobile/reference must both be (N, 3), got {mobile.shape} "
            f"vs {reference.shape}")
    r = host.qcp_rotation(mobile, reference, weights)
    diff = mobile @ r - reference
    if weights is None:
        rmsd = float(np.sqrt((diff ** 2).sum() / len(mobile)))
    else:
        w = np.asarray(weights, np.float64)
        rmsd = float(np.sqrt((w @ (diff ** 2).sum(axis=1)) / w.sum()))
    return r.T, rmsd


def _fit_group(obj, select: str):
    """Universe-or-AtomGroup → the selection to fit on, respecting group
    membership (``select`` refines WITHIN a passed group, upstream
    semantics)."""
    from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup

    if isinstance(obj, AtomGroup):
        return obj if select == "all" else obj.select_atoms(select)
    return obj.select_atoms(select)


def alignto(mobile, reference, select: str = "all",
            weights: str | None = None):
    """Superpose the mobile Universe/AtomGroup's CURRENT frame onto the
    reference (upstream ``align.alignto``): fit on ``select`` (refined
    within passed AtomGroups), apply the transform to ALL of the mobile
    universe's atoms in place (the reference's per-frame body,
    RMSF.py:99-101, as a one-shot).  Returns ``(old_rmsd, new_rmsd)``
    over the selection.  ``reference`` is required — aligning a frame
    onto itself is always a silent no-op.  ``weights=None`` (upstream
    default): unweighted centering, fit, and RMSD; ``weights="mass"``
    mass-weights all three.  (The trajectory-level classes
    AlignTraj/AverageStructure keep the reference script's own
    convention instead: mass COM + unweighted rotation, RMSF.py:84,48.)
    Host float64.
    """
    from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup

    mob_u = mobile.universe if isinstance(mobile, AtomGroup) else mobile
    ag = _fit_group(mobile, select)
    ref_ag = _fit_group(reference, select)
    if ag.n_atoms == 0:
        raise ValueError(f"selection {select!r} matched no atoms")
    if ref_ag.n_atoms != ag.n_atoms:
        raise ValueError(
            f"selection {select!r} sizes differ: mobile {ag.n_atoms} vs "
            f"reference {ref_ag.n_atoms}")
    if weights not in (None, "mass"):
        raise ValueError(f"weights must be None or 'mass', got {weights!r}")
    w = ag.masses if weights == "mass" else None
    wv = w if w is not None else np.ones(ag.n_atoms)
    ref_sel = ref_ag.positions.astype(np.float64)
    ref_com = host.weighted_center(ref_sel, wv)
    ref_c = ref_sel - ref_com
    ts = mob_u.trajectory.ts
    mob_sel = ts.positions[ag.indices].astype(np.float64)
    mob_c = mob_sel - host.weighted_center(mob_sel, wv)

    def _rmsd(x):
        d2 = ((x - ref_c) ** 2).sum(axis=1)
        return float(np.sqrt((wv @ d2) / wv.sum()))

    old = _rmsd(mob_c)
    _, new = rotation_matrix(mob_c, ref_c, w)
    # the one superposition pipeline (COM, QCP rotation, apply-to-all)
    ts.positions = host.superpose_frame(
        ts.positions, ag.indices, wv, ref_c, ref_com,
        rot_weights=w).astype(np.float32)
    return old, new


#: three-letter → one-letter residue codes (sequence_alignment)
_AA_CODES = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
    "HSD": "H", "HSE": "H", "HSP": "H", "HID": "H", "HIE": "H",
    "HIP": "H", "CYX": "C", "CYM": "C", "MSE": "M",
}


def _residue_letters(ag) -> tuple:
    """(one-letter string, per-residue resindices) for a protein group."""
    t = ag.universe.topology
    res = t.resindices[ag.indices]
    _, first = np.unique(res, return_index=True)
    order = np.sort(first)
    rows = res[order]
    letters = []
    for a in ag.indices[order]:
        rn = str(t.resnames[a]).upper()
        letters.append(_AA_CODES.get(rn, "X"))
    return "".join(letters), rows


def sequence_alignment(mobile, reference, match: float = 2.0,
                       mismatch: float = -1.0, gap_open: float = -2.0,
                       gap_extend: float = -0.1):
    """Global (Needleman–Wunsch, AFFINE gaps — full Gotoh, including
    the cross-gap X↔Y transitions so adjacent insertion+deletion paths
    are representable under any scoring) alignment of two groups'
    residue sequences (upstream ``align.sequence_alignment``,
    reimplemented without Biopython; upstream's default scoring:
    match 2, mismatch −1, gap open −2, gap extend −0.1).  Returns
    ``(seq_mobile, seq_reference, pairs)`` — the two gapped sequences
    and the (K, 2) array of ALIGNED residue index pairs
    ``[mobile_resindex, reference_resindex]`` (matched columns only).

    The DP runs one vectorized row at a time (the in-row Y recurrence
    is a prefix max), and the traceback re-derives each step with
    EXACT float comparisons against the forward pass's own arithmetic.
    Host code.
    """
    s1, r1 = _residue_letters(mobile)
    s2, r2 = _residue_letters(reference)
    if not s1 or not s2:
        raise ValueError("both groups need at least one residue")
    n, m = len(s1), len(s2)
    neg = -1e18
    M = np.full((n + 1, m + 1), neg)
    X = np.full((n + 1, m + 1), neg)   # gap in reference (consumes s1)
    Y = np.full((n + 1, m + 1), neg)   # gap in mobile (consumes s2)
    M[0, 0] = 0.0
    X[1:, 0] = gap_open + np.arange(n) * gap_extend
    Y[0, 1:] = gap_open + np.arange(m) * gap_extend
    s2b = np.frombuffer(s2.encode(), np.uint8)
    for i in range(1, n + 1):
        sub = np.where(s2b == ord(s1[i - 1]), match, mismatch)
        prev_best = np.maximum(np.maximum(M[i - 1], X[i - 1]), Y[i - 1])
        M[i, 1:] = prev_best[:-1] + sub
        X[i] = np.maximum(np.maximum(M[i - 1], Y[i - 1]) + gap_open,
                          X[i - 1] + gap_extend)
        X[i, 0] = gap_open + (i - 1) * gap_extend
        # Y's in-row recurrence Y[j] = max(base[j-1]+open, Y[j-1]+ext)
        # as a prefix max of (candidate - j*ext)
        base = np.maximum(M[i], X[i]) + gap_open
        cand = np.full(m + 1, neg)
        cand[1:] = base[:-1] - np.arange(1, m + 1) * gap_extend
        cand[0] = Y[i, 0]
        Y[i] = np.maximum.accumulate(cand) \
            + np.arange(m + 1) * gap_extend

    # traceback — every comparison recomputes the forward pass's exact
    # float expression, so abs-1e-9 equality is bit-safe
    def _eq(a, b):
        return abs(a - b) <= 1e-9

    a1, a2, pairs = [], [], []
    i, j = n, m
    state = int(np.argmax([M[n, m], X[n, m], Y[n, m]]))
    while i > 0 or j > 0:
        if state == 0 and i > 0 and j > 0:
            a1.append(s1[i - 1])
            a2.append(s2[j - 1])
            pairs.append((int(r1[i - 1]), int(r2[j - 1])))
            i -= 1
            j -= 1
            state = int(np.argmax([M[i, j], X[i, j], Y[i, j]]))
        elif state == 1 and i > 0:
            a1.append(s1[i - 1])
            a2.append("-")
            if _eq(X[i, j], M[i - 1, j] + gap_open):
                state = 0
            elif _eq(X[i, j], Y[i - 1, j] + gap_open):
                state = 2
            else:
                state = 1                       # extension
            i -= 1
        elif state == 2 and j > 0:
            a1.append("-")
            a2.append(s2[j - 1])
            if _eq(Y[i, j], M[i, j - 1] + gap_open):
                state = 0
            elif _eq(Y[i, j], X[i, j - 1] + gap_open):
                state = 1
            else:
                state = 2
            j -= 1
        else:                     # boundary: only one direction remains
            state = 1 if i > 0 else 2
    return ("".join(reversed(a1)), "".join(reversed(a2)),
            np.asarray(list(reversed(pairs)), np.int64).reshape(-1, 2))
