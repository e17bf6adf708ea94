"""Distance functions mirroring ``MDAnalysis.lib.distances`` (the
C/Cython layer in upstream — SURVEY.md §2.2; BASELINE config 5 names
``distances.self_distance_array``).

``backend="numpy"`` (default) runs the float64 host oracle;
``backend="torch"`` runs the torch ops in float32 on ``device``
(``cuda`` unless given) — worthwhile for repeated large calls, not
single small ones.  ``capped_distance(engine="torch")`` is the
fixed-capacity cell list of :mod:`mdanalysis_mpi_tpu_torch.ops.neighbors`.
The JAX package's ``'jax'`` backend and engine are called ``'torch'``
here; ``'jax'`` is refused with an error that names ``'torch'``.
"""

from __future__ import annotations

import numpy as np


def _check_backend(backend: str) -> None:
    if backend == "jax":
        raise ValueError(
            "backend='jax' is the JAX package's name; the port's device "
            "backend is backend='torch'")
    if backend not in ("numpy", "torch"):
        raise ValueError(
            f"backend must be 'numpy' or 'torch', got {backend!r}")


def _device_f32(x, device):
    """A host array as a float32 tensor on ``device`` (``cuda`` unless
    given; raises without a GPU)."""
    import torch

    from mdanalysis_mpi_tpu_torch.device import resolve_device

    return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(
        resolve_device(device))


def _to_host64(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def _dims_of(box):
    if box is None:
        return None
    box = np.asarray(box, dtype=np.float64)
    if box.shape == (6,):
        return box
    if box.shape == (3,):
        return np.concatenate([box, [90.0, 90.0, 90.0]])
    raise ValueError(f"box must be (3,) lengths or (6,) dimensions, got {box.shape}")


def distance_array(reference, configuration, box=None,
                   backend: str = "numpy", device=None) -> np.ndarray:
    """(N, M) pair distances between two coordinate sets; ``device``
    serves ``backend="torch"``."""
    _check_backend(backend)
    a = np.asarray(reference, dtype=np.float64).reshape(-1, 3)
    b = np.asarray(configuration, dtype=np.float64).reshape(-1, 3)
    dims = _dims_of(box)
    if backend == "numpy":
        from mdanalysis_mpi_tpu_torch.ops import host

        return host.distance_array(a, b, dims)
    from mdanalysis_mpi_tpu_torch.ops import distances as d

    return _to_host64(d.distance_array(
        _device_f32(a, device), _device_f32(b, device),
        None if dims is None else _device_f32(dims, device)))


def self_distance_array(reference, box=None,
                        backend: str = "numpy", device=None) -> np.ndarray:
    """Condensed upper-triangle distances, length N(N-1)/2, in upstream's
    (i<j) row-major order (BASELINE config 5)."""
    _check_backend(backend)
    a = np.asarray(reference, dtype=np.float64).reshape(-1, 3)
    dims = _dims_of(box)
    if backend == "torch":
        from mdanalysis_mpi_tpu_torch.ops import distances as d

        # condensed on device — one small fetch instead of the full matrix
        return _to_host64(d.self_distance_array(
            _device_f32(a, device),
            None if dims is None else _device_f32(dims, device)))
    d = distance_array(a, a, box=box, backend=backend)
    iu, ju = np.triu_indices(len(a), k=1)
    return d[iu, ju]


def calc_bonds(coords1, coords2, box=None, backend: str = "numpy",
               device=None) -> np.ndarray:
    """Pairwise (row-wise) distances between two equal-length sets."""
    _check_backend(backend)
    a = np.asarray(coords1, dtype=np.float64).reshape(-1, 3)
    b = np.asarray(coords2, dtype=np.float64).reshape(-1, 3)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    dims = _dims_of(box)
    if backend == "torch":
        import torch

        from mdanalysis_mpi_tpu_torch.ops import distances as d

        disp = d.minimum_image(
            _device_f32(a - b, device),
            None if dims is None else _device_f32(dims, device))
        return _to_host64(torch.sqrt((disp ** 2).sum(-1)))
    from mdanalysis_mpi_tpu_torch.ops import host

    disp = host.minimum_image(a - b, dims)
    return np.sqrt((disp ** 2).sum(-1))


def apply_PBC(coords, box) -> np.ndarray:
    """Map coordinates into the primary unit cell (upstream
    ``lib.distances.apply_PBC``); float32 out like upstream."""
    from mdanalysis_mpi_tpu_torch.core.box import box_to_vectors, wrap_positions

    dims = _dims_of(box)
    if dims is None:
        raise ValueError("apply_PBC needs a box")
    m = box_to_vectors(np.asarray(dims, np.float64))
    return wrap_positions(
        np.asarray(coords, np.float64).reshape(-1, 3), m).astype(np.float32)


def calc_angles(coords1, coords2, coords3, box=None) -> np.ndarray:
    """Angle at the APEX ``coords2`` of each (a, b, c) triple, in
    RADIANS (upstream ``lib.distances.calc_angles``); minimum-image
    displacements under ``box``."""
    from mdanalysis_mpi_tpu_torch.ops import host

    a = np.asarray(coords1, np.float64).reshape(-1, 3)
    b = np.asarray(coords2, np.float64).reshape(-1, 3)
    c = np.asarray(coords3, np.float64).reshape(-1, 3)
    if not (a.shape == b.shape == c.shape):
        raise ValueError(
            f"shape mismatch {a.shape} vs {b.shape} vs {c.shape}")
    dims = _dims_of(box)
    u = host.minimum_image(a - b, dims)
    v = host.minimum_image(c - b, dims)
    num = (u * v).sum(-1)
    den = np.sqrt((u ** 2).sum(-1) * (v ** 2).sum(-1))
    return np.arccos(np.clip(num / np.maximum(den, 1e-300), -1.0, 1.0))


def calc_dihedrals(coords1, coords2, coords3, coords4, box=None) -> np.ndarray:
    """Dihedral of each (a, b, c, d) quadruple in RADIANS, IUPAC sign
    (upstream ``lib.distances.calc_dihedrals``) — the same convention as
    :func:`mdanalysis_mpi_tpu_torch.lib.mdamath.dihedral`; minimum-image
    under ``box``."""
    from mdanalysis_mpi_tpu_torch.ops import host

    p = [np.asarray(x, np.float64).reshape(-1, 3)
         for x in (coords1, coords2, coords3, coords4)]
    if not all(x.shape == p[0].shape for x in p):
        raise ValueError(
            f"shape mismatch: {[x.shape for x in p]}")
    dims = _dims_of(box)
    b1 = host.minimum_image(p[1] - p[0], dims)
    b2 = host.minimum_image(p[2] - p[1], dims)
    b3 = host.minimum_image(p[3] - p[2], dims)
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    b2n = b2 / np.maximum(
        np.linalg.norm(b2, axis=-1, keepdims=True), 1e-300)
    x = (n1 * n2).sum(-1)
    y = (np.cross(n1, n2) * b2n).sum(-1)
    return np.arctan2(y, x)


def contact_matrix(coords, cutoff: float = 15.0, box=None,
                   backend: str = "numpy", device=None) -> np.ndarray:
    """Boolean (N, N) contact map at ``cutoff`` (BASELINE config 5)."""
    a = np.asarray(coords, dtype=np.float64).reshape(-1, 3)
    return distance_array(a, a, box=box, backend=backend,
                          device=device) < cutoff


#: ``engine="auto"`` switches from brute force to the cell list above
#: this many candidate pairs (N·M); below it the vectorized brute block
#: is faster than grid bookkeeping
AUTO_GRID_MIN_PAIRS = 16_384
#: ...and only when the grid actually prunes: with fewer total cells
#: than ~2× the 27-stencil, nearly every atom is a candidate anyway
AUTO_GRID_MIN_CELLS = 54


def capped_distance(reference, configuration, max_cutoff: float,
                    min_cutoff: float | None = None, box=None,
                    return_distances: bool = True, engine: str = "auto",
                    device=None, _self_upper=False):
    """Pairs within ``max_cutoff`` (upstream ``lib.distances
    .capped_distance``): returns ``(pairs, distances)`` — pairs is
    (K, 2) int ``[i_reference, j_configuration]`` lexsorted by (i, j)
    — or just ``pairs`` with ``return_distances=False``.

    ``engine`` selects the pair-pruning backend (the knob mirrors
    ``InterRDF``'s):

    - ``"auto"`` (default): the O(N) cell list (``lib.nsgrid``) when
      the query is large enough to profit and the grid applies;
      otherwise brute force.  Every capped-radius consumer
      (``guess_bonds``, LeafletFinder, HBond pruning,
      AtomNeighborSearch) routes through here, so auto is the
      one default that turns them ~linear at scale.
    - ``"nsgrid"``: force the cell list; raises ``ValueError`` when the
      grid cannot serve the query (degenerate box, or cutoff so large
      that fewer than 3 cells fit per axis).
    - ``"bruteforce"``: the documented fallback — blockwise over the
      reference axis so the full N×M matrix never materializes (the
      same discipline as the device pair kernels, SURVEY.md §5.7).
    - ``"torch"``: the fixed-capacity cell list in torch
      (``ops.neighbors``) on ``device`` (``cuda`` unless given; raises
      without a GPU) — worthwhile for large queries on the card, not
      for small host calls.  ``"auto"`` never picks it.

    The host engines (auto/nsgrid/bruteforce) emit IDENTICAL (pairs,
    distances) in identical order; the torch engine computes in f32,
    so a pair whose true distance lies within f32 rounding of the
    cutoff (~1e-5 Å at solvated-box coordinates) can flip across it —
    same order and identity otherwise.  Minimum image under ``box``
    when given.  ``_self_upper`` (internal,
    :func:`self_capped_distance`) keeps only j > i pairs.
    """
    a = np.asarray(reference, dtype=np.float64).reshape(-1, 3)
    b = np.asarray(configuration, dtype=np.float64).reshape(-1, 3)
    if max_cutoff <= 0:
        raise ValueError(f"max_cutoff must be positive, got {max_cutoff}")
    if min_cutoff is not None and min_cutoff >= max_cutoff:
        raise ValueError(
            f"min_cutoff {min_cutoff} must be below max_cutoff {max_cutoff}")
    if engine == "jax":
        raise ValueError(
            "engine='jax' is the JAX package's name; the port's device "
            "engine is engine='torch'")
    if engine not in ("auto", "nsgrid", "bruteforce", "torch"):
        raise ValueError(
            "engine must be 'auto', 'nsgrid', 'bruteforce' or 'torch', "
            f"got {engine!r}")
    dims = _dims_of(box)

    if engine == "torch":
        from mdanalysis_mpi_tpu_torch.ops import neighbors

        return neighbors.capped_distance(
            a, b, max_cutoff, min_cutoff=min_cutoff, dims=dims,
            return_distances=return_distances, self_upper=_self_upper,
            device=device)
    if engine in ("auto", "nsgrid"):
        from mdanalysis_mpi_tpu_torch.lib import nsgrid

        try:
            plan = None
            if engine == "auto":
                if len(a) * len(b) < AUTO_GRID_MIN_PAIRS:
                    raise nsgrid.GridUnsuitable("query too small to profit")
                if len(a) and len(b):
                    plan = nsgrid.make_plan(a, b, max_cutoff, dims)
                    if int(np.prod(plan[0])) < AUTO_GRID_MIN_CELLS:
                        raise nsgrid.GridUnsuitable(
                            "grid prunes too little")
            return nsgrid.capped_pairs(
                a, b, max_cutoff, min_cutoff=min_cutoff, dims=dims,
                return_distances=return_distances,
                self_upper=_self_upper, plan=plan)
        except nsgrid.GridUnsuitable as e:
            if engine == "nsgrid":
                raise ValueError(
                    f"engine='nsgrid' cannot serve this query: {e}"
                ) from e
            # auto: documented brute-force fallback below

    from mdanalysis_mpi_tpu_torch.ops import host

    pairs_i, pairs_j, dists = [], [], []
    # element budget sized for the REAL peak: disp (block·M·3 f64) plus
    # minimum_image's copies of the same shape and d2 — ~9 arrays of
    # block·M elements ≈ 160 MB at this setting
    block = max(1, int(2.2e6) // max(1, len(b)))
    c2 = float(max_cutoff) ** 2
    m2 = None if min_cutoff is None else float(min_cutoff) ** 2
    for lo in range(0, len(a), block):
        chunk = a[lo:lo + block]
        disp = chunk[:, None, :] - b[None, :, :]
        disp = host.minimum_image(disp, dims)
        d2 = np.einsum("abi,abi->ab", disp, disp)
        hit = d2 <= c2
        if m2 is not None:
            hit &= d2 > m2
        if _self_upper:
            hit &= (np.arange(len(b))[None, :]
                    > np.arange(lo, lo + len(chunk))[:, None])
        ii, jj = np.nonzero(hit)
        pairs_i.append(ii + lo)
        pairs_j.append(jj)
        if return_distances:
            dists.append(np.sqrt(d2[ii, jj]))
    pairs = np.stack([np.concatenate(pairs_i) if pairs_i else np.empty(0, np.int64),
                      np.concatenate(pairs_j) if pairs_j else np.empty(0, np.int64)],
                     axis=1)
    if return_distances:
        d = (np.concatenate(dists) if dists else np.empty(0))
        return pairs, d
    return pairs


def self_capped_distance(reference, max_cutoff: float,
                         min_cutoff: float | None = None, box=None,
                         return_distances: bool = True,
                         engine: str = "auto", device=None):
    """Unique i<j pairs within ``max_cutoff`` of each other (upstream
    ``lib.distances.self_capped_distance``); ``engine`` and ``device``
    as in :func:`capped_distance`."""
    return capped_distance(reference, reference, max_cutoff,
                           min_cutoff=min_cutoff, box=box,
                           return_distances=return_distances,
                           engine=engine, device=device, _self_upper=True)


def minimize_vectors(vectors, box) -> np.ndarray:
    """Apply the minimum-image convention to arbitrary displacement
    vectors (upstream ``lib.distances.minimize_vectors``): each vector
    is replaced by its TRUE shortest periodic image.

    For skewed triclinic cells the fractional round-to-nearest used by
    the hot-path kernels (ops/host.py ``minimum_image`` — the standard
    single-shift MD compromise) is not always minimal; this public
    utility finishes the job with a 27-neighbor lattice search, which
    is exact for any valid triclinic cell."""
    from mdanalysis_mpi_tpu_torch.ops.host import minimum_image

    m = _valid_box_matrix(box, "minimize_vectors")   # refuses degenerate
    dims = np.asarray(_dims_of(box), np.float64)
    v = np.asarray(vectors, np.float64)
    base = minimum_image(v, dims)
    if np.all(np.abs(dims[3:] - 90.0) < 1e-4):
        return base.astype(np.float32)       # orthorhombic: exact already
    flat = base.reshape(-1, 3)
    shifts = np.array([(i, j, k) for i in (-1, 0, 1)
                       for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], np.float64) @ m   # (27, 3)
    cand = flat[:, None, :] + shifts[None]                     # (n, 27, 3)
    best = cand[np.arange(len(flat)),
                (cand ** 2).sum(-1).argmin(axis=1)]
    return best.reshape(base.shape).astype(np.float32)


def _valid_box_matrix(box, who: str) -> np.ndarray:
    """Shared strict validation (core.box.valid_box_matrix), applied
    to this module's box argument convention (_dims_of)."""
    from mdanalysis_mpi_tpu_torch.core.box import valid_box_matrix

    return valid_box_matrix(_dims_of(box), who)


def transform_RtoS(coords, box) -> np.ndarray:
    """Real → fractional (scaled) coordinates (upstream
    ``lib.distances.transform_RtoS``)."""
    m = _valid_box_matrix(box, "transform_RtoS")
    return (np.asarray(coords, np.float64) @ np.linalg.inv(m)).astype(
        np.float32)


def transform_StoR(coords, box) -> np.ndarray:
    """Fractional (scaled) → real coordinates (upstream
    ``lib.distances.transform_StoR``)."""
    m = _valid_box_matrix(box, "transform_StoR")
    return (np.asarray(coords, np.float64) @ m).astype(np.float32)
