"""Universe: binds a Topology to a trajectory Reader.

Covers the reference's Universe API surface (SURVEY.md §2.2):
``Universe(topology, trajectory)`` (RMSF.py:56), ``.copy()`` with an
independent reader cursor (RMSF.py:57), ``Universe(topology, ndarray)``
in-memory construction (RMSF.py:113), ``select_atoms`` (RMSF.py:77),
``.trajectory`` and ``.atoms``.
"""

from __future__ import annotations

import numpy as np

from mdanalysis_mpi_tpu_torch.core.groups import AtomGroup
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.io.base import ReaderBase
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader


def _load_topology(source) -> Topology:
    if isinstance(source, Topology):
        return source
    if isinstance(source, (str,)):
        from mdanalysis_mpi_tpu_torch.io import topology_files
        return topology_files.parse(source)
    raise TypeError(f"cannot build a Topology from {type(source).__name__}")


def _load_trajectory(source, n_atoms: int) -> ReaderBase:
    if isinstance(source, ReaderBase):
        return source
    if isinstance(source, np.ndarray):
        return MemoryReader(source)          # RMSF.py:113 path
    if isinstance(source, (str,)):
        from mdanalysis_mpi_tpu_torch.io import trajectory_files
        return trajectory_files.open(source, n_atoms=n_atoms)
    if isinstance(source, (list, tuple)):
        # upstream Universe(top, [part1.xtc, part2.xtc]) — restart
        # segments presented as one trajectory
        from mdanalysis_mpi_tpu_torch.io.chain import ChainReader
        return ChainReader(source, n_atoms=n_atoms)
    raise TypeError(f"cannot open a trajectory from {type(source).__name__}")


class Universe:
    """Topology + trajectory, the root object of the data model."""

    def __init__(self, topology, trajectory=None, **kwargs):
        self.topology = _load_topology(topology)
        if trajectory is None:
            # Topology-only universe: coordinates embedded in the
            # topology file (GRO/PDB) if present, else one zero frame.
            src = getattr(self.topology, "_coordinates", None)
            dims = getattr(self.topology, "_dimensions", None)
            vels = getattr(self.topology, "_velocities", None)
            if src is not None:
                trajectory = MemoryReader(src, dimensions=dims,
                                          velocities=vels)
            else:
                trajectory = np.zeros((1, self.topology.n_atoms, 3),
                                      dtype=np.float32)
        self.trajectory = _load_trajectory(trajectory, self.topology.n_atoms)
        if self.trajectory.n_atoms != self.topology.n_atoms:
            raise ValueError(
                f"topology has {self.topology.n_atoms} atoms but trajectory "
                f"has {self.trajectory.n_atoms}")
        transformations = kwargs.pop("transformations", None)
        if transformations is not None:
            # upstream Universe(..., transformations=[...]) convenience
            if callable(transformations):
                transformations = (transformations,)
            self.trajectory.add_transformations(*transformations)

    @property
    def atoms(self) -> AtomGroup:
        return AtomGroup(self, np.arange(self.topology.n_atoms))

    @property
    def residues(self):
        """All residues (upstream's ``u.residues``)."""
        from mdanalysis_mpi_tpu_torch.core.groups import ResidueGroup

        return ResidueGroup(self, self.topology.resindices)

    _GUESS_REMEDY = {
        "bonds": "u.topology.bonds = u.atoms.guess_bonds()",
        "angles": ("u.topology.angles = core.topologyobjects."
                   "guess_angles(u.topology.bonds, u.topology.n_atoms)"),
        "dihedrals": ("u.topology.dihedrals = core.topologyobjects."
                      "guess_dihedrals(u.topology.angles, "
                      "u.topology.bonds, u.topology.n_atoms)"),
        "impropers": ("u.topology.impropers = core.topologyobjects."
                      "guess_improper_dihedrals(u.topology.angles, "
                      "u.topology.bonds, u.topology.n_atoms)"),
    }

    def _topology_group(self, attr: str, kind: str):
        from mdanalysis_mpi_tpu_torch.core.topologyobjects import TopologyGroup

        tuples = getattr(self.topology, attr)
        if tuples is None:
            raise ValueError(
                f"this topology carries no {attr}; parse a format with "
                f"{attr} sections (PSF, ITP) or derive them: "
                f"{self._GUESS_REMEDY[attr]}")
        return TopologyGroup(self, tuples, kind)

    @property
    def bonds(self):
        """All bonds as a :class:`TopologyGroup` (upstream ``u.bonds``).
        """
        return self._topology_group("bonds", "bond")

    @property
    def angles(self):
        return self._topology_group("angles", "angle")

    @property
    def dihedrals(self):
        return self._topology_group("dihedrals", "dihedral")

    @property
    def impropers(self):
        return self._topology_group("impropers", "improper")

    @property
    def segments(self):
        """All segments (upstream's ``u.segments``)."""
        from mdanalysis_mpi_tpu_torch.core.groups import SegmentGroup

        return SegmentGroup(self, self.topology.segids)

    def select_atoms(self, selection: str,
                     updating: bool = False) -> AtomGroup:
        """Selection string → AtomGroup (RMSF.py:77 semantics).

        Parsed once per call; analyses cache the resulting index array in
        ``_prepare`` instead of re-selecting per frame (fixes quirk Q3).
        Geometric keywords (``around``) see the current frame — fetched
        lazily, so topology-only selections never decode one.
        ``updating=True`` returns an :class:`UpdatingAtomGroup` whose
        membership re-evaluates whenever the current frame changes.
        """
        return self.atoms.select_atoms(selection, updating=updating)

    #: attributes settable via add_TopologyAttr → Topology field.  Per-
    #: atom float arrays only; structural attributes (names, resids,
    #: bonds) define identity and are construction-time.
    _SETTABLE_ATTRS = {"charges": "charges", "masses": "masses",
                       "charge": "charges", "mass": "masses",
                       "radii": "radii", "radius": "radii"}

    def add_TopologyAttr(self, name: str, values=None) -> None:
        """Attach a per-atom topology attribute after construction
        (upstream ``Universe.add_TopologyAttr`` for the attributes that
        are data, not identity): ``charges`` / ``masses``, with
        ``values`` length n_atoms (default zeros — upstream's empty
        attr).  Selection caches keyed on the old values are busted —
        including those of ``copy()`` clones, which share the
        topology."""
        field = self._SETTABLE_ATTRS.get(name)
        if field is None:
            raise ValueError(
                f"cannot add topology attribute {name!r}; settable: "
                f"{sorted(set(self._SETTABLE_ATTRS.values()))} "
                "(structural attributes are construction-time)")
        n = self.topology.n_atoms
        arr = (np.zeros(n) if values is None
               else np.asarray(values, dtype=np.float64))
        if arr.shape != (n,):
            raise ValueError(
                f"{name} needs {n} per-atom values, got shape {arr.shape}")
        setattr(self.topology, field, arr)
        # prop mass/charge selections memoize against the old values;
        # the version bump invalidates every universe sharing this
        # topology (the memo key includes it)
        d = self.topology._derived
        d["attr_version"] = d.get("attr_version", 0) + 1

    def copy(self) -> "Universe":
        """Clone with an independent trajectory cursor (RMSF.py:57).

        The topology (immutable) is shared; the reader is re-opened (file
        readers) or re-wrapped over the same backing array (memory
        readers) so each copy seeks independently, as each MPI rank's
        ``universe.copy()`` does upstream.
        """
        traj = self.trajectory
        if not hasattr(traj, "reopen"):
            raise TypeError(f"{type(traj).__name__} does not support copy()")
        if any(getattr(t, "stateful", False)
               for t in traj.transformations):
            raise ValueError(
                "cannot copy() a universe with stateful transformations "
                "(PositionAverager): the copies would share one window "
                "buffer and corrupt each other — build a fresh "
                "transformation per universe instead")
        new = Universe(self.topology, traj.reopen())
        if traj.transformations:
            # the copy must see the same coordinates as the original
            # (each rank's universe.copy() upstream, RMSF.py:57)
            new.trajectory.add_transformations(*traj.transformations)
        return new

    def transfer_to_memory(self, start=None, stop=None, step=None) -> None:
        """Replace the trajectory with an in-memory copy (upstream's
        ``Universe.transfer_to_memory`` idiom, the explicit form of the
        serial oracle's ``in_memory=True``, RMSF.py:12).

        Decodes frames ``[start:stop:step]`` once via the bulk block
        reader; afterwards every pass is a RAM slice — the host-side
        analog of the HBM block cache used on the device path.
        """
        n = self.trajectory.n_frames
        frames = range(*slice(start, stop, step).indices(n))
        if len(frames) == 0:
            raise ValueError(
                f"transfer_to_memory[{start}:{stop}:{step}] selects no "
                f"frames (trajectory has {n})")
        coords, boxes = self.trajectory.read_block(
            frames.start, frames.stop, step=frames.step)
        times = self.trajectory.frame_times(frames)
        self.trajectory.close()
        self.trajectory = MemoryReader(coords, dimensions=boxes, times=times)

    @property
    def dimensions(self):
        return self.trajectory.ts.dimensions

    def __repr__(self):
        return (f"<Universe with {self.topology.n_atoms} atoms, "
                f"{self.trajectory.n_frames} frames>")


def Merge(*groups) -> "Universe":
    """Build a NEW single-frame Universe from AtomGroups' CURRENT
    coordinates (upstream ``MDAnalysis.Merge``): the groups'
    sub-topologies concatenate in argument order (bonds survive within
    each group, remapped) and the frame snapshots each group's
    positions at its universe's current trajectory cursor.

    Groups may come from different universes.  The box is taken from
    the first group's current frame (upstream behavior); an
    UpdatingAtomGroup contributes its current membership — Merge is a
    snapshot by definition.
    """
    from mdanalysis_mpi_tpu_torch.core.topology import concatenate

    if not groups:
        raise ValueError("Merge needs at least one AtomGroup")
    for g in groups:
        if not isinstance(g, AtomGroup):
            raise TypeError(
                f"Merge takes AtomGroups, got {type(g).__name__}")
        if g.n_atoms == 0:
            raise ValueError("cannot Merge an empty AtomGroup")
    tops = [g.universe.topology.subset(g.indices) for g in groups]
    top = tops[0] if len(tops) == 1 else concatenate(tops)
    pos = np.concatenate([g.positions for g in groups])[None]
    dims = groups[0].universe.trajectory.ts.dimensions
    return Universe(top, MemoryReader(pos.astype(np.float32),
                                      dimensions=dims))
