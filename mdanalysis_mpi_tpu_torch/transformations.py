"""On-the-fly trajectory transformations.

Upstream-API mirror (``MDAnalysis.transformations``): callables applied
to every Timestep as it is read —
``u.trajectory.add_transformations(translate([1,0,0]), wrap(ag))`` —
so every consumer (per-frame iteration, ``read_block`` staging, every
analysis backend) sees the transformed coordinates.  The reference
program transforms frames *imperatively* inside its loop (the in-place
translate/rotate/translate at RMSF.py:99-101); this module is that
pattern made composable and declarative.

Execution model: transformations are host-side, frame-wise NumPy — they
run where the decode runs, before selection gather and device staging
(a transformation may need atoms outside the staged selection, e.g.
centering on the protein while staging water).  Readers with
transformations attached automatically fall back from their fused
decode→gather fast paths to the generic read-transform-gather loop;
attach none and the fast paths are untouched.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.ops import host


class TransformationBase:
    """A callable ``ts -> ts`` that edits ``ts.positions`` in place
    (upstream convention).

    ``stateful = True`` marks transformations whose output depends on
    the SEQUENCE of frames they saw (PositionAverager): those are
    sequential-cursor-only — block staging refuses them (block/cache
    schedules would silently change their numbers), ``Universe.copy()``
    refuses to share them across cursors, and attaching one resets its
    state (``reset()``)."""

    stateful = False

    def __call__(self, ts):
        raise NotImplementedError

    def reset(self) -> None:            # stateful subclasses override
        pass


def _require_box(ts, who: str):
    """Strict per-frame box validation (core.box.valid_box_matrix —
    the one shared validator): a partially degenerate box must raise
    here, not write NaN positions downstream.  Returns ``(dims, m)``
    — the validator already built the (3, 3) cell matrix, so per-frame
    callers must not rebuild it."""
    from mdanalysis_mpi_tpu_torch.core.box import valid_box_matrix

    m = valid_box_matrix(ts.dimensions, f"{who} (frame {ts.frame})")
    return ts.dimensions.astype(np.float64), m


def _group_center(ag, positions: np.ndarray, center: str) -> np.ndarray:
    sub = positions[ag.indices].astype(np.float64)
    if center == "mass":
        w = ag.masses
        return (w[:, None] * sub).sum(axis=0) / w.sum()
    if center == "geometry":
        return sub.mean(axis=0)
    raise ValueError(f"center must be 'geometry' or 'mass', got {center!r}")


class translate(TransformationBase):
    """Shift every atom by a constant vector."""

    def __init__(self, vector):
        self._v = np.asarray(vector, dtype=np.float32)
        if self._v.shape != (3,):
            raise ValueError(f"vector must be (3,), got {self._v.shape}")

    def __call__(self, ts):
        ts.positions += self._v
        return ts


class rotateby(TransformationBase):
    """Rotate every atom by ``angle`` degrees about the axis along
    ``direction`` through ``point`` — or through the center of ``ag``,
    recomputed per frame (upstream ``transformations.rotate.rotateby``).
    Exactly one of ``point``/``ag`` must be given."""

    def __init__(self, angle, direction, point=None, ag=None,
                 center: str = "geometry"):
        if (point is None) == (ag is None):
            raise ValueError("rotateby needs exactly one of point= or ag=")
        from mdanalysis_mpi_tpu_torch.lib.transformations import rotation_matrix

        # one Rodrigues implementation for the whole package
        self._rot = rotation_matrix(np.radians(float(angle)),
                                    direction)[:3, :3]
        self._point = None if point is None else np.asarray(point,
                                                            np.float64)
        self._ag = ag
        self._center = center
        if center not in ("geometry", "mass"):      # fail at build time
            raise ValueError(
                f"center must be 'geometry' or 'mass', got {center!r}")
        if ag is None and center != "geometry":
            raise ValueError("center= applies only with ag=")

    def __call__(self, ts):
        p = (self._point if self._point is not None
             else _group_center(self._ag, ts.positions, self._center))
        x = ts.positions.astype(np.float64) - p
        ts.positions = (x @ self._rot.T + p).astype(np.float32)
        return ts


class center_in_box(TransformationBase):
    """Translate each frame so ``ag``'s center sits at the box center
    (or at ``point``).  ``wrap=True`` wraps the group into the primary
    cell before computing its center (upstream semantics)."""

    def __init__(self, ag, center: str = "geometry", point=None,
                 wrap: bool = False):
        if center not in ("geometry", "mass"):
            raise ValueError(
                f"center must be 'geometry' or 'mass', got {center!r}")
        self._ag = ag
        self._center = center
        self._point = (None if point is None
                       else np.asarray(point, np.float64))
        self._wrap = wrap

    def __call__(self, ts):
        from mdanalysis_mpi_tpu_torch.core.box import wrap_positions

        dim, m = _require_box(ts, "center_in_box")
        pos = ts.positions
        if self._wrap:
            # wrap affects only the CENTER COMPUTATION (upstream
            # inplace=False semantics) — atom positions themselves keep
            # their image, so molecules never break across the boundary
            sub = wrap_positions(pos[self._ag.indices], m)
            if self._center == "mass":
                w = self._ag.masses
                center = (w[:, None] * sub).sum(axis=0) / w.sum()
            else:
                center = sub.mean(axis=0)
        else:
            center = _group_center(self._ag, pos, self._center)
        target = (self._point if self._point is not None
                  else m.sum(axis=0) / 2.0)
        shift = target - center
        ts.positions = (pos.astype(np.float64) + shift).astype(np.float32)
        return ts


class fit_translation(TransformationBase):
    """Translate each frame so ``ag``'s center matches the reference
    group's center (captured from the reference universe's CURRENT
    frame at construction).  ``plane`` ('xy' | 'yz' | 'xz') restricts
    the shift to that plane."""

    _PLANES = {"xy": (0, 1), "yz": (1, 2), "xz": (0, 2)}

    def __init__(self, ag, reference, plane: str | None = None,
                 weights: str | None = None):
        if plane is not None and plane not in self._PLANES:
            raise ValueError(
                f"plane must be one of {sorted(self._PLANES)}, got {plane!r}")
        if weights not in (None, "mass"):
            raise ValueError(f"weights must be None or 'mass', got {weights!r}")
        self._ag = ag
        self._center = "mass" if weights == "mass" else "geometry"
        ref_u = reference.universe
        self._ref_center = _group_center(
            reference, ref_u.trajectory.ts.positions, self._center)
        self._dims = (self._PLANES[plane] if plane is not None
                      else (0, 1, 2))

    def __call__(self, ts):
        shift = np.zeros(3)
        full = self._ref_center - _group_center(
            self._ag, ts.positions, self._center)
        for d in self._dims:
            shift[d] = full[d]
        ts.positions = (ts.positions.astype(np.float64) + shift
                        ).astype(np.float32)
        return ts


class fit_rot_trans(TransformationBase):
    """Least-squares-superpose each frame onto a reference: rotation fit
    on ``ag``, transform applied to ALL atoms — the reference program's
    per-frame body (RMSF.py:94-101) as a reusable transformation.
    Reference coordinates are captured from the reference universe's
    CURRENT frame at construction."""

    def __init__(self, ag, reference, weights: str | None = None):
        if weights not in (None, "mass"):
            raise ValueError(f"weights must be None or 'mass', got {weights!r}")
        if reference.n_atoms != ag.n_atoms:
            raise ValueError(
                f"fit group has {ag.n_atoms} atoms, reference "
                f"{reference.n_atoms}")
        self._ag = ag
        w = ag.masses if weights == "mass" else np.ones(ag.n_atoms)
        self._w = w
        ref_u = reference.universe
        ref = ref_u.trajectory.ts.positions[reference.indices].astype(
            np.float64)
        com = host.weighted_center(ref, w)
        self._ref_c = ref - com
        self._ref_com = com

    def __call__(self, ts):
        ts.positions = host.superpose_frame(
            ts.positions, self._ag.indices, self._w,
            self._ref_c, self._ref_com).astype(np.float32)
        return ts


class unwrap(TransformationBase):
    """Make molecules whole across periodic boundaries every frame
    (upstream ``transformations.unwrap``): walk each molecule's bond
    spanning tree and place every atom at the minimum-image position
    relative to its tree parent.  Requires bonds in the topology
    (load a PSF or call ``ag.guess_bonds()`` first).

    The walk is vectorized by BFS DEPTH: the tree is computed once at
    construction and stored as per-level (parents, children) index
    arrays, so a frame costs one minimum-image pass per tree level —
    not per atom — regardless of molecule count."""

    def __init__(self, ag):
        t = ag.universe.topology
        if t.bonds is None or len(t.bonds) == 0:
            raise ValueError(
                "unwrap needs bonds in the topology (load a PSF or call "
                "ag.guess_bonds() first)")
        members = set(int(i) for i in ag.indices)
        adj: dict[int, list[int]] = {}
        for x, y in t.bonds:
            x, y = int(x), int(y)
            if x in members and y in members:
                adj.setdefault(x, []).append(y)
                adj.setdefault(y, []).append(x)
        # BFS forest over the group, one root per connected component
        seen = set()
        levels: list[tuple[list[int], list[int]]] = []
        for root in sorted(members):
            if root in seen or root not in adj:
                seen.add(root)
                continue
            seen.add(root)
            frontier = [root]
            depth = 0
            while frontier:
                nxt: list[int] = []
                if depth >= len(levels):
                    levels.append(([], []))
                parents, children = levels[depth]
                for p in frontier:
                    for c in adj.get(p, ()):
                        if c not in seen:
                            seen.add(c)
                            parents.append(p)
                            children.append(c)
                            nxt.append(c)
                frontier = nxt
                depth += 1
        self._levels = [(np.asarray(p, np.int64), np.asarray(c, np.int64))
                        for p, c in levels if p]

    def __call__(self, ts):
        from mdanalysis_mpi_tpu_torch.ops.host import minimum_image

        dim, _m = _require_box(ts, "unwrap")
        pos = ts.positions.astype(np.float64)
        for parents, children in self._levels:
            d = minimum_image(pos[children] - pos[parents], dim)
            pos[children] = pos[parents] + d
        ts.positions = pos.astype(np.float32)
        return ts


class wrap(TransformationBase):
    """Wrap ``ag``'s atoms into the primary unit cell every frame
    (upstream ``transformations.wrap``; per-atom, like
    ``AtomGroup.wrap``)."""

    def __init__(self, ag):
        self._ag = ag

    def __call__(self, ts):
        from mdanalysis_mpi_tpu_torch.core.box import wrap_positions

        dim, m = _require_box(ts, "wrap")
        idx = self._ag.indices
        ts.positions[idx] = wrap_positions(
            ts.positions[idx], m).astype(np.float32)
        return ts


class PositionAverager(TransformationBase):
    """Sliding-window position averaging (upstream
    ``transformations.positionaveraging.PositionAverager``): each
    emitted frame's positions become the mean of the last
    ``avg_frames`` frames read (fewer at the start of iteration) — a
    smoothing filter for noisy trajectories.

    Stateful BY DESIGN (upstream too): it assumes SEQUENTIAL frame
    reads on ONE cursor.  With ``check_reset=True`` (default) a
    non-consecutive frame jump clears the window, so random access
    degrades to plain positions instead of averaging unrelated frames;
    ``check_reset=False`` reproduces upstream's trust-the-caller mode.
    Block staging (batch backends / transfer_to_memory) and
    ``Universe.copy()`` refuse stateful transformations loudly — their
    schedules/cursor sharing would silently change the averages.
    ``current_avg`` reports how many frames the current window held.
    """

    stateful = True

    def __init__(self, avg_frames: int, check_reset: bool = True):
        if avg_frames < 1:
            raise ValueError(
                f"avg_frames must be >= 1, got {avg_frames}")
        from collections import deque

        self._avg_frames = int(avg_frames)
        self._check_reset = bool(check_reset)
        self._buf = deque(maxlen=self._avg_frames)
        self._sum: np.ndarray | None = None    # float64 running sum
        self._last_frame: int | None = None
        self.current_avg = 0

    def reset(self) -> None:
        self._buf.clear()
        self._sum = None
        self._last_frame = None
        self.current_avg = 0

    def __call__(self, ts):
        if (self._check_reset and self._last_frame is not None
                and ts.frame != self._last_frame + 1):
            self.reset()
        x = ts.positions.astype(np.float64)
        if self._sum is None:
            self._sum = np.zeros_like(x)
        if len(self._buf) == self._buf.maxlen:
            self._sum -= self._buf[0]          # deque evicts it below
        self._buf.append(x)
        self._sum += x
        self.current_avg = len(self._buf)
        ts.positions = (self._sum / self.current_avg).astype(np.float32)
        self._last_frame = ts.frame
        return ts


class set_dimensions(TransformationBase):
    """Assign fixed box dimensions to every frame (upstream
    ``transformations.boxdimensions.set_dimensions``) — the standard
    fix for trajectories whose format carries no box (XYZ, some DCDs)
    before PBC-dependent analyses (RDF, minimum-image distances)."""

    def __init__(self, dimensions):
        dims = np.asarray(dimensions, dtype=np.float32).reshape(-1)
        if dims.shape != (6,):
            raise ValueError(
                "set_dimensions needs [lx, ly, lz, alpha, beta, gamma], "
                f"got shape {np.asarray(dimensions).shape}")
        # the ONE shared validator (core.box): an unphysical box —
        # including geometrically impossible angle combinations with no
        # volume — must fail here, at build time, not mid-analysis
        from mdanalysis_mpi_tpu_torch.core.box import valid_box_matrix

        valid_box_matrix(dims, "set_dimensions")
        self._dims = dims

    def __call__(self, ts):
        ts.dimensions = self._dims.copy()
        return ts


class NoJump(TransformationBase):
    """Remove box jumps frame-over-frame (upstream
    ``transformations.nojump.NoJump``): each atom's displacement since
    the previous read frame is minimum-imaged, so a particle drifting
    out of the box keeps its continuous (unwrapped-in-time) trajectory
    instead of teleporting to the other side.  The first frame read is
    the anchor.

    Stateful BY DESIGN like :class:`PositionAverager` (the output
    depends on the previous frame read on this cursor): sequential
    reads on one cursor only; a non-consecutive jump with
    ``check_continuity=True`` (default) re-anchors at the new frame
    (upstream warns and does the same); block staging and
    ``Universe.copy()`` refuse stateful transformations loudly.
    Orthorhombic boxes only — the displacement wrap is per-axis
    (upstream supports triclinic via the lambda-matrix form; this port
    refuses non-90 angles rather than silently mis-unwrapping).
    """

    stateful = True

    def __init__(self, check_continuity: bool = True):
        self._check = bool(check_continuity)
        self._prev_raw: np.ndarray | None = None
        self._prev_out: np.ndarray | None = None
        self._last_frame: int | None = None

    def reset(self) -> None:
        self._prev_raw = None
        self._prev_out = None
        self._last_frame = None

    def __call__(self, ts):
        box, _ = _require_box(ts, "NoJump")
        if not np.allclose(box[3:], 90.0, atol=1e-3):
            raise ValueError(
                f"NoJump supports orthorhombic boxes only, got angles "
                f"{box[3:].tolist()}")
        if (self._check and self._last_frame is not None
                and ts.frame != self._last_frame + 1):
            import warnings

            warnings.warn(
                f"NoJump: non-sequential read (frame {self._last_frame} "
                f"-> {ts.frame}); re-anchoring — strided/random access "
                "yields RAW wrapped positions, not a continuous "
                "trajectory (iterate sequentially for unwrapping)",
                stacklevel=2)
            self.reset()
        x = ts.positions.astype(np.float64)
        if self._prev_raw is None:
            self._prev_raw = x
            self._prev_out = x.copy()
        else:
            from mdanalysis_mpi_tpu_torch.ops.host import minimum_image

            d = minimum_image(x - self._prev_raw, box)
            self._prev_out = self._prev_out + d
            self._prev_raw = x
        ts.positions = self._prev_out.astype(np.float32)
        self._last_frame = ts.frame
        return ts
