"""AtomGroup: an ordered set of atoms bound to a Universe.

Covers the reference's AtomGroup API surface (SURVEY.md §2.2):
``.positions`` (RMSF.py:85,95), ``.n_atoms`` (RMSF.py:97,120),
``.center_of_mass()`` (RMSF.py:84,94 — mass-weighted), plus the set
algebra and attribute views a framework user expects.  The group's
``indices`` array is the static gather map handed to TPU kernels.
"""

from __future__ import annotations

import numpy as np


class AtomGroup:
    """Ordered atom subset of a Universe, defined by an index array."""

    def __init__(self, universe, indices: np.ndarray):
        self._universe = universe
        self._indices = np.asarray(indices, dtype=np.int64)
        if self._indices.ndim != 1:
            raise ValueError("indices must be 1-D")

    # ---- identity ----

    @property
    def universe(self):
        return self._universe

    @property
    def indices(self) -> np.ndarray:
        return self._indices

    @property
    def n_atoms(self) -> int:
        return len(self._indices)

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, item) -> "AtomGroup":
        return AtomGroup(self._universe, np.atleast_1d(self._indices[item]))

    def __repr__(self):
        return f"<AtomGroup with {self.n_atoms} atoms>"

    # ---- static attributes (gathered from topology) ----

    @property
    def names(self) -> np.ndarray:
        return self._universe.topology.names[self._indices]

    @property
    def resnames(self) -> np.ndarray:
        return self._universe.topology.resnames[self._indices]

    @property
    def resids(self) -> np.ndarray:
        return self._universe.topology.resids[self._indices]

    @property
    def segids(self) -> np.ndarray:
        return self._universe.topology.segids[self._indices]

    @property
    def elements(self) -> np.ndarray:
        return self._universe.topology.elements[self._indices]

    @property
    def masses(self) -> np.ndarray:
        return self._universe.topology.masses[self._indices]

    @property
    def charges(self) -> np.ndarray:
        ch = self._universe.topology.charges
        if ch is None:
            raise AttributeError("topology has no charges")
        return ch[self._indices]

    @property
    def radii(self) -> np.ndarray:
        r = self._universe.topology.radii
        if r is None:
            raise AttributeError("topology has no radii (PQR-style)")
        return r[self._indices]

    # ---- dynamic attributes (gathered from the current Timestep) ----

    @property
    def positions(self) -> np.ndarray:
        """float32 (n_atoms, 3) positions at the Universe's current frame
        (reference: ``ag.positions``, RMSF.py:85,95,137)."""
        return self._universe.trajectory.ts.positions[self._indices]

    @positions.setter
    def positions(self, value):
        self._universe.trajectory.ts.positions[self._indices] = value

    @property
    def velocities(self) -> np.ndarray:
        """float32 (n_atoms, 3) velocities (Å/ps) at the current frame;
        raises if the trajectory format carries none (upstream
        ``ag.velocities`` contract — TRR has them, XTC/DCD do not)."""
        v = self._universe.trajectory.ts.velocities
        if v is None:
            raise AttributeError(
                "this trajectory's frames carry no velocities")
        return v[self._indices]

    @property
    def forces(self) -> np.ndarray:
        """float32 (n_atoms, 3) forces (kJ/(mol·Å)) at the current
        frame; raises if the format carries none."""
        f = self._universe.trajectory.ts.forces
        if f is None:
            raise AttributeError("this trajectory's frames carry no forces")
        return f[self._indices]

    def _compound_keys(self, compound: str) -> np.ndarray:
        if compound == "residues":
            return self.resindices
        if compound == "segments":
            return self.segids
        raise ValueError(
            f"compound must be 'group', 'residues' or 'segments', "
            f"got {compound!r}")

    def _segmented_center(self, weights: np.ndarray | None,
                          compound: str) -> np.ndarray:
        """Per-compound (weighted) centers in first-occurrence order
        (the split() convention) — one segmented reduction, no Python
        loop over compounds."""
        keys = self._compound_keys(compound)
        uniq, first, inverse = np.unique(keys, return_index=True,
                                         return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[order] = np.arange(len(uniq))
        seg = rank[inverse]                   # first-occurrence compound id
        w = (np.ones(len(self._indices)) if weights is None
             else np.asarray(weights, np.float64))
        pos = self.positions.astype(np.float64)
        num = np.zeros((len(uniq), 3))
        np.add.at(num, seg, pos * w[:, None])
        den = np.zeros(len(uniq))
        np.add.at(den, seg, w)
        if (den == 0.0).any():
            raise ValueError(
                "a compound has zero total weight; cannot compute center")
        return num / den[:, None]

    def center_of_mass(self, compound: str = "group") -> np.ndarray:
        """Mass-weighted center, float64 (reference RMSF.py:84,94).

        ``compound='group'`` (default) → (3,); ``'residues'`` /
        ``'segments'`` → (n_compounds, 3), one center per residue/
        segment of THIS group in first-occurrence order (upstream
        ``compound=`` semantics)."""
        m = self.masses
        if compound != "group":
            return self._segmented_center(m, compound)
        tot = m.sum()
        if tot == 0.0:
            raise ValueError("total mass is zero; cannot compute center_of_mass")
        return (self.positions.astype(np.float64) * m[:, None]).sum(axis=0) / tot

    def center_of_geometry(self, compound: str = "group") -> np.ndarray:
        """Unweighted centroid, float64; ``compound`` as in
        :meth:`center_of_mass`."""
        if compound != "group":
            return self._segmented_center(None, compound)
        return self.positions.astype(np.float64).mean(axis=0)

    centroid = center_of_geometry

    def total_mass(self) -> float:
        return float(self.masses.sum())

    def total_charge(self) -> float:
        """Sum of partial charges, e (upstream ``ag.total_charge()``)."""
        return float(self.charges.sum())

    def dipole_moment(self) -> float:
        """|Σ qᵢ·(rᵢ − COM)| in e·Å (upstream ``ag.dipole_moment``
        convention: charge-weighted displacement about the mass-weighted
        center).  For a non-neutral group the value depends on that
        reference point, as upstream documents."""
        return float(np.linalg.norm(self.dipole_vector()))

    def dipole_vector(self) -> np.ndarray:
        """Σ qᵢ·(rᵢ − COM), e·Å (upstream ``ag.dipole_vector``)."""
        q = self.charges.astype(np.float64)
        x = self.positions.astype(np.float64)
        com = self.center_of_mass()
        return (q[:, None] * (x - com)).sum(axis=0)

    def radius_of_gyration(self) -> float:
        """Mass-weighted radius of gyration, float64 (upstream
        ``AtomGroup.radius_of_gyration``): sqrt(Σ mᵢ·|rᵢ−COM|² / Σ mᵢ)."""
        m = self.masses
        d = self.positions.astype(np.float64) - self.center_of_mass()
        return float(np.sqrt((m * (d ** 2).sum(axis=1)).sum() / m.sum()))

    def moment_of_inertia(self) -> np.ndarray:
        """Mass-weighted inertia tensor about the COM, float64 (3, 3)
        (upstream ``AtomGroup.moment_of_inertia``):
        ``I = Σ mᵢ (|rᵢ|²·E − rᵢrᵢᵀ)`` with rᵢ COM-relative."""
        m = self.masses
        r = self.positions.astype(np.float64) - self.center_of_mass()
        r2 = (r ** 2).sum(axis=1)
        return (np.eye(3) * (m * r2).sum()
                - np.einsum("i,ij,ik->jk", m, r, r))

    def principal_axes(self) -> np.ndarray:
        """Principal axes of inertia as ROWS, ordered from the axis
        with the HIGHEST moment to the lowest (upstream convention:
        ``principal_axes()[0]`` is the axis about which rotation is
        hardest; for a linear molecule that is any axis perpendicular
        to it, and ``[2]`` is the molecular axis)."""
        vals, vecs = np.linalg.eigh(self.moment_of_inertia())
        axes = vecs[:, ::-1].T            # rows, descending eigenvalue
        # deterministic sign: make each axis' largest component positive
        for a in axes:
            k = int(np.argmax(np.abs(a)))
            if a[k] < 0:
                a *= -1.0
        return axes

    # ---- residue/segment structure ----

    @property
    def resindices(self) -> np.ndarray:
        return self._universe.topology.resindices[self._indices]

    @property
    def residues(self) -> "ResidueGroup":
        """The residues these atoms belong to (upstream idiom)."""
        return ResidueGroup(self._universe, self.resindices)

    @property
    def segments(self) -> "SegmentGroup":
        """Segments containing this group's atoms (upstream idiom)."""
        return SegmentGroup(self._universe, self.segids)

    @property
    def fragindices(self) -> np.ndarray:
        """Per-atom bonded-fragment (molecule) index (upstream
        ``fragindices``; needs bonds — PSF or ``guess_bonds``)."""
        return self._universe.topology.fragindices[self._indices]

    @property
    def n_fragments(self) -> int:
        return len(np.unique(self.fragindices))

    @property
    def fragments(self) -> list["AtomGroup"]:
        """The FULL bonded fragments containing any atom of this group
        (upstream semantics: whole molecules, not intersections), in
        fragment-index order."""
        frag = self._universe.topology.fragindices
        return [AtomGroup(self._universe, np.flatnonzero(frag == f))
                for f in np.unique(frag[self._indices])]

    def split(self, level: str = "residue") -> list["AtomGroup"]:
        """Split into per-residue or per-segment AtomGroups (upstream
        ``AtomGroup.split``), preserving this group's atom order within
        each part — e.g. per-residue RMSF aggregation::

            parts = u.select_atoms("protein").split("residue")
        """
        if level == "residue":
            keys = self.resindices
        elif level == "segment":
            keys = self.segids
        else:
            raise ValueError(
                f"level must be 'residue' or 'segment', got {level!r}")
        uniq, first, inverse = np.unique(keys, return_index=True,
                                         return_inverse=True)
        # parts in order of first occurrence (upstream split semantics),
        # not np.unique's sorted-label order — matters for segids, which
        # need not appear alphabetically
        order = np.argsort(first, kind="stable")
        return [AtomGroup(self._universe, self._indices[inverse == k])
                for k in order]

    # ---- refinement & set algebra ----

    def select_atoms(self, selection: str,
                     updating: bool = False) -> "AtomGroup":
        """Select within this group (indices stay sorted/unique).

        ``updating=True`` returns an :class:`UpdatingAtomGroup` that
        RE-EVALUATES the selection whenever the universe's current
        frame changes (upstream semantics — the general form of the
        reference's in-loop ``select_atoms``, RMSF.py:126).

        The whole string is evaluated against the group (upstream
        semantics): geometric keywords' inner selections see only group
        atoms, so ``waters.select_atoms("around 3 protein")`` is empty
        when the group holds no protein.

        Topology-only selections are memoized on the Universe: the
        topology is immutable, so a parse that never touched the current
        frame's coordinates yields the same mask forever.  The lazy
        coords callable doubles as the purity witness — geometric
        selections resolve it and are never cached (they must see the
        current frame, upstream semantics).  Spares the per-``run()``
        re-parse of multi-pass analyses at large atom counts (the
        run-level echo of quirk Q3).
        """
        from mdanalysis_mpi_tpu_torch.core.selection import select_mask_info

        if updating:
            n_all = self._universe.topology.n_atoms
            # exact whole-universe test (length alone would misread a
            # duplicate-bearing group of coincidental length n_all and
            # leak atoms outside the base scope); an updating BASE is
            # kept as the group itself so nested updating selections
            # track it per frame instead of freezing its creation-frame
            # membership
            if isinstance(self, UpdatingAtomGroup):
                base = self
            elif np.array_equal(self._indices, np.arange(n_all)):
                base = None
            else:
                base = self
            return UpdatingAtomGroup(self._universe, selection, base=base)
        top = self._universe.topology
        n = top.n_atoms
        whole = len(self._indices) == n
        udict = self._universe.__dict__
        cache = udict.setdefault("_selection_cache", {})
        # strings whose parse provably never consulted a group scope:
        # their masks are shared by every subgroup under (selection, None)
        insensitive = udict.setdefault("_selection_scope_insensitive",
                                       set())
        # exact bytes as the scope key (a 64-bit hash could collide and
        # silently serve another subgroup's mask).  The topology's
        # attr_version joins the key because the topology — and thus a
        # cached mask's validity — is SHARED across Universe.copy()
        # clones: mutators (add_TopologyAttr, guess_bonds) bump it, so
        # every sharer misses cleanly instead of serving a stale mask.
        key = (selection, top._derived.get("attr_version", 0),
               None if whole or selection in insensitive
               else self._indices.tobytes())
        mask = cache.get(key)
        if mask is None:
            if whole:
                scope = None             # whole universe: no restriction
            else:
                scope = np.zeros(n, dtype=bool)
                scope[self._indices] = True
            touched_frame = []

            def coords():
                touched_frame.append(True)
                ts = self._universe.trajectory.ts
                return ts.positions, ts.dimensions

            mask, scope_consulted = select_mask_info(
                top, selection, positions=coords, scope=scope)
            if not touched_frame:
                if not whole and not scope_consulted:
                    insensitive.add(selection)
                    key = (selection, top._derived.get("attr_version", 0),
                           None)
                if len(cache) >= 256:    # bound stale-string buildup
                    cache.clear()
                if len(insensitive) >= 256:   # same bound, same reason
                    insensitive.clear()
                cache[key] = mask
        return AtomGroup(self._universe,
                         self._indices[mask[self._indices]])

    def wrap(self) -> np.ndarray:
        """Wrap this group's atoms into the primary unit cell (upstream
        ``AtomGroup.wrap(compound='atoms')``): positions map to
        fractional coordinates in [0, 1) and back, in place on the
        current Timestep.  Returns the wrapped positions.  Requires a
        box on the current frame."""
        ts = self._universe.trajectory.ts
        from mdanalysis_mpi_tpu_torch.core.box import (valid_box_matrix,
                                                 wrap_positions)

        # strict: a partially degenerate box would otherwise write NaN
        # positions back silently (core.box.valid_box_matrix rationale)
        m = valid_box_matrix(ts.dimensions, "wrap()")
        wrapped = wrap_positions(
            ts.positions[self._indices], m).astype(np.float32)
        ts.positions[self._indices] = wrapped
        return wrapped

    def unwrap(self, inplace: bool = True) -> np.ndarray:
        """Make this bonded group whole across periodic boundaries at
        the current frame (upstream ``AtomGroup.unwrap``); see
        :func:`mdanalysis_mpi_tpu_torch.lib.mdamath.make_whole`."""
        from mdanalysis_mpi_tpu_torch.lib.mdamath import make_whole

        return make_whole(self, inplace=inplace)

    def pack_into_box(self) -> np.ndarray:
        """Upstream ``AtomGroup.pack_into_box()`` — alias of
        :meth:`wrap` (map atoms into the primary unit cell)."""
        return self.wrap()

    # ---- connectivity groups (upstream TopologyGroup surface) ----

    @property
    def bonds(self):
        """Bonds with BOTH atoms in this group (upstream ``ag.bonds``),
        as a vectorized :class:`~mdanalysis_mpi_tpu_torch.core.
        topologyobjects.TopologyGroup` — ``.values()`` gives lengths Å.
        """
        return self._universe.bonds.atomgroup_intersection(self)

    @property
    def angles(self):
        """Angles fully inside this group; ``.values()`` in degrees."""
        return self._universe.angles.atomgroup_intersection(self)

    @property
    def dihedrals(self):
        """Proper dihedrals fully inside this group (degrees)."""
        return self._universe.dihedrals.atomgroup_intersection(self)

    @property
    def impropers(self):
        """Improper dihedrals fully inside this group (degrees)."""
        return self._universe.impropers.atomgroup_intersection(self)

    def guess_bonds(self, fudge_factor: float = 0.55,
                    lower_bound: float = 0.1,
                    engine: str = "auto", device=None) -> np.ndarray:
        """Distance-based bond perception over THIS group's atoms
        (upstream ``AtomGroup.guess_bonds``): atoms i, j bond when
        ``lower_bound < d(i,j) < fudge_factor·(r_vdw(i)+r_vdw(j))``
        on the current frame (minimum image under the frame's box).
        The guessed bonds are merged into the universe topology —
        ``bonded`` selections and HydrogenBondAnalysis donor pairing
        work afterwards — and returned as an (n_bonds, 2) global-index
        array.  Elements without a tabulated radius raise.

        ``engine`` selects the pair-pruning backend
        (``lib.distances.capped_distance``); the default 'auto' uses
        the O(N) cell list at scale — the bond-search cutoff is a few
        Å, so perception over a 100k-atom frame is grid territory —
        with brute force as the selectable/degenerate-box fallback;
        'torch' runs the torch cell list on ``device`` (``cuda`` unless
        given)."""
        from mdanalysis_mpi_tpu_torch.core import tables
        from mdanalysis_mpi_tpu_torch.lib.distances import self_capped_distance

        t = self._universe.topology
        if len(self._indices) < 2:
            return np.empty((0, 2), dtype=np.int64)
        elements = np.char.upper(t.elements[self._indices].astype("U2"))
        radii = np.empty(len(elements))
        for j, e in enumerate(elements):
            r = tables.VDW_RADII.get(e)
            if r is None:
                raise ValueError(
                    f"no van der Waals radius tabulated for element "
                    f"{e!r} (atom {int(self._indices[j])}); add it to "
                    "core.tables.VDW_RADII or set bonds explicitly")
            radii[j] = r
        ts = self._universe.trajectory.ts
        max_cut = fudge_factor * 2.0 * float(radii.max())
        pairs, d = self_capped_distance(
            self.positions, max_cut, min_cutoff=lower_bound,
            box=ts.dimensions, return_distances=True, engine=engine,
            device=device)
        keep = d < fudge_factor * (radii[pairs[:, 0]] + radii[pairs[:, 1]])
        bonds = self._indices[pairs[keep]]
        existing = t.bonds if t.bonds is not None else np.empty((0, 2),
                                                               np.int64)
        merged = {tuple(sorted(b)) for b in existing.tolist()}
        merged.update(tuple(sorted(b)) for b in bonds.tolist())
        t.bonds = np.array(sorted(merged), dtype=np.int64).reshape(-1, 2)
        # the selection memo assumes an immutable topology — adding
        # bonds invalidates any cached `bonded ...` mask, and the
        # fragment components derive from the bond graph too
        self._universe.__dict__.pop("_selection_cache", None)
        self._universe.__dict__.pop("_selection_scope_insensitive", None)
        t._derived.pop("fragindices", None)
        # copy() clones share this topology; their memoized `bonded`
        # masks go stale too — the version bump invalidates them
        t._derived["attr_version"] = t._derived.get("attr_version", 0) + 1
        return np.asarray(bonds, dtype=np.int64).reshape(-1, 2)

    def write(self, path: str) -> None:
        """Write this group's current-frame coordinates (+ subset
        topology) to ``path`` — format chosen by extension (.gro, .pdb,
        .psf), the upstream ``ag.write`` idiom.  Bonds internal to the
        group survive with remapped indices (``Topology.subset``)."""
        import os

        ext = os.path.splitext(path)[1].lstrip(".").lower()
        top = self._universe.topology.subset(self._indices)
        ts = self._universe.trajectory.ts
        dims = ts.dimensions
        if ext == "gro":
            from mdanalysis_mpi_tpu_torch.io.gro import write_gro

            vel = (None if ts.velocities is None
                   else ts.velocities[self._indices])
            write_gro(path, top, self.positions, dimensions=dims,
                      velocities=vel)
        elif ext == "pdb":
            from mdanalysis_mpi_tpu_torch.io.pdb import write_pdb

            write_pdb(path, top, self.positions, dimensions=dims)
        elif ext == "psf":
            from mdanalysis_mpi_tpu_torch.io.psf import write_psf

            write_psf(path, top)
        else:
            raise ValueError(
                f"unsupported extension {ext!r} for AtomGroup.write "
                "(supported: gro, pdb, psf)")

    def __and__(self, other: "AtomGroup") -> "AtomGroup":
        self._check(other)
        return AtomGroup(self._universe,
                         np.intersect1d(self._indices, other._indices))

    def __or__(self, other: "AtomGroup") -> "AtomGroup":
        self._check(other)
        return AtomGroup(self._universe,
                         np.union1d(self._indices, other._indices))

    def __sub__(self, other: "AtomGroup") -> "AtomGroup":
        self._check(other)
        return AtomGroup(self._universe,
                         np.setdiff1d(self._indices, other._indices))

    def _check(self, other):
        if other._universe is not self._universe:
            raise ValueError("AtomGroups belong to different Universes")


class UpdatingAtomGroup(AtomGroup):
    """A dynamic AtomGroup: membership re-evaluates per frame.

    Upstream's ``select_atoms(..., updating=True)``: the group holds a
    selection STRING, not a static index array, and re-runs it against
    the universe's CURRENT frame whenever the frame has changed since
    the last evaluation — the general form of the reference's in-loop
    ``select_atoms`` (RMSF.py:126; static there only because that
    selection is topology-only).  Geometric keywords (``around``,
    ``sphzone``, ``point``…) therefore track the trajectory:

        shell = u.select_atoms("name OW and around 3.5 protein",
                               updating=True)
        for ts in u.trajectory:       # len(shell) changes per frame
            ...

    Every inherited accessor (``indices``, ``positions``, ``n_atoms``,
    set algebra, ``center_of_mass``…) reads through the freshness
    check.  Re-evaluation keys on the current ``Timestep.frame``;
    in-place position edits *within* a frame do not trigger one
    (matching the upstream contract of evaluating once per frame).

    Batch/serial ANALYSES snapshot their selection once in
    ``_prepare`` (static gather maps are what TPU kernels compile
    against), so handing an updating group to an analysis raises
    loudly instead of silently freezing frame-0 membership
    (``analysis/base.py``); the supported dynamic-selection routes are
    per-frame selection strings (``SurvivalProbability``) and
    ``AnalysisFromFunction``, whose user function reads the group per
    frame and so sees every re-evaluation.
    """

    def __init__(self, universe, selection: str, base=None):
        # deliberately NOT calling AtomGroup.__init__: _indices is a
        # property here (assignment would clash), and validation happens
        # by evaluating the selection once below.  ``base`` may be an
        # AtomGroup (scope; an UpdatingAtomGroup base re-evaluates per
        # frame — nested updating selections track it) or None (whole
        # universe).
        self._universe = universe
        self._selection = selection
        self._base = base
        self._last_frame = None
        self._cached = None
        self._indices                    # validate selection eagerly

    @property
    def _indices(self) -> np.ndarray:
        ts = self._universe.trajectory.ts
        frame = getattr(ts, "frame", None)
        if self._cached is None or frame != self._last_frame:
            if self._base is None:
                base = self._universe.atoms
            else:
                # materialize the base's CURRENT membership as a static
                # group (an updating base re-evaluates right here)
                base = AtomGroup(self._universe, self._base.indices)
            self._cached = base.select_atoms(self._selection).indices
            self._last_frame = frame
        return self._cached

    @property
    def selection(self) -> str:
        return self._selection

    def __repr__(self):
        return (f"<UpdatingAtomGroup {self._selection!r}, currently "
                f"{self.n_atoms} atoms>")


class ResidueGroup:
    """Residue-level view over a set of residues (upstream's
    ``u.residues`` / ``AtomGroup.residues``): per-residue attribute
    arrays plus the way back down to atoms.

    Residues are identified by the topology's ``resindices`` (0-based,
    assigned in file order whenever (resid, segid) changes — the
    standard convention); attributes are taken from each residue's
    first atom.
    """

    def __init__(self, universe, resindices: np.ndarray):
        self._universe = universe
        self._resindices = np.unique(np.asarray(resindices, dtype=np.int64))
        top = universe.topology
        # first atom of every residue (cached on the topology)
        self._first_atom = top.residue_first_atom[self._resindices]

    @property
    def universe(self):
        return self._universe

    @property
    def resindices(self) -> np.ndarray:
        return self._resindices

    @property
    def n_residues(self) -> int:
        return len(self._resindices)

    def __len__(self) -> int:
        return self.n_residues

    def __repr__(self):
        return f"<ResidueGroup with {self.n_residues} residues>"

    @property
    def resids(self) -> np.ndarray:
        return self._universe.topology.resids[self._first_atom]

    @property
    def resnames(self) -> np.ndarray:
        return self._universe.topology.resnames[self._first_atom]

    @property
    def segids(self) -> np.ndarray:
        return self._universe.topology.segids[self._first_atom]

    @property
    def atoms(self) -> AtomGroup:
        """All atoms belonging to these residues, in topology order."""
        top = self._universe.topology
        mask = np.isin(top.resindices, self._resindices)
        return AtomGroup(self._universe, np.flatnonzero(mask))


class SegmentGroup:
    """Segment-level view (upstream's ``u.segments`` /
    ``AtomGroup.segments``): unique segment ids in first-occurrence
    order plus the way back down to atoms — completing the
    Atom/Residue/Segment hierarchy of the upstream data model
    (SURVEY.md §2.2 Universe row)."""

    def __init__(self, universe, segids: np.ndarray):
        self._universe = universe
        wanted = set(np.asarray(segids, dtype=np.str_).tolist())
        # normalize to TOPOLOGY first-occurrence order regardless of the
        # group's atom order, mirroring ResidueGroup's normalization —
        # so segids zip consistently with topology-ordered per-segment
        # views (e.g. segs.atoms.split("segment"))
        top_segids = universe.topology.segids
        _, first = np.unique(top_segids, return_index=True)
        order = top_segids[np.sort(first)]
        self._segids = np.array([s for s in order if s in wanted],
                                dtype=np.str_)

    @property
    def universe(self):
        return self._universe

    @property
    def segids(self) -> np.ndarray:
        return self._segids

    @property
    def n_segments(self) -> int:
        return len(self._segids)

    def __len__(self) -> int:
        return self.n_segments

    def __repr__(self):
        return f"<SegmentGroup with {self.n_segments} segments>"

    @property
    def atoms(self) -> AtomGroup:
        """All atoms of these segments, in topology order."""
        top = self._universe.topology
        mask = np.isin(top.segids, self._segids)
        return AtomGroup(self._universe, np.flatnonzero(mask))

    @property
    def residues(self) -> ResidueGroup:
        return self.atoms.residues
