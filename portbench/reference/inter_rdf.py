"""Plain float64 reference of ``InterRDF`` between two groups of one
frame set in an orthorhombic box: MDAnalysis's ``InterRDF`` with
``norm='rdf'``, every ordered pair of a group-1 atom and a group-2
atom (the pair of an atom with itself left out when the groups are
one) whose minimum-image distance lies in ``range``, binned into
``nbins`` equal bins, and g(r) = counts / (T · N_pairs / ⟨V⟩ · V_shell).

Pairs are found through a cell list: each box edge is cut into as many
cells as fit cells of at least the range's end, so every pair inside
the range lies in one of a cell's 27 neighbours, taken with the image
shift that makes the plain difference the minimum image.  A cell's
squared distances come from one float64 matrix product of augmented
coordinates about the cell's centre, ``[a, |a|², 1] · [-2b, 1, |b|²]``;
its rounding (1e-13 Å² at these sizes) is far below the float32
program's.  The pairs inside the range are binned by ``torch.histc``.

``precision='bfloat16'`` is the control: the same computation on
coordinates and distances rounded to bfloat16, the precision below the
configuration's float32.

The frames are made again on the device from the seed; nothing the
program made is read.
"""

from __future__ import annotations

import itertools

import numpy as np

_FAR = 1e18         # a padding slot's squared norm: never inside the range


def _grid(x, lengths, n_cells):
    """Atoms ``x (N, 3)`` sorted into a ``(cells, P, 3)`` grid of cells
    and its ``(cells, P)`` mask of real slots."""
    import torch

    n = torch.as_tensor(n_cells, device=x.device)
    c = torch.floor(x / (lengths / n)).long()
    c = torch.minimum(c.clamp(min=0), n - 1)
    cid = (c[:, 0] * n[1] + c[:, 1]) * n[2] + c[:, 2]
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    counts = torch.bincount(cid_s, minlength=int(n.prod()))
    p = int(counts.max())
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(x), device=x.device) - start[cid_s]
    grid = torch.zeros((int(n.prod()), p, 3), dtype=x.dtype, device=x.device)
    grid[cid_s, slot] = x[order]
    real = torch.zeros((int(n.prod()), p), dtype=torch.bool, device=x.device)
    real[cid_s, slot] = True
    return grid, real


def _neighbours(n_cells, lengths):
    """Each cell's centre, and for each of its 27 offsets the
    neighbour's index and the image shift of its coordinates →
    ``(cells, 3)``, ``(cells, 27)``, ``(cells, 27, 3)``, and the
    position of the zero offset."""
    import torch

    offs = list(itertools.product((-1, 0, 1), repeat=3))
    n = np.array(n_cells)
    cells = np.array(list(itertools.product(*(range(k) for k in n_cells))))
    raw = cells[:, None, :] + np.array(offs)[None]          # (C, 27, 3)
    wrap = np.floor_divide(raw, n)
    nb = raw - wrap * n
    index = (nb[..., 0] * n[1] + nb[..., 1]) * n[2] + nb[..., 2]
    length = lengths.cpu().numpy()
    dev, dt = lengths.device, lengths.dtype
    return (torch.as_tensor((cells + 0.5) * length / n, dtype=dt, device=dev),
            torch.as_tensor(index, device=dev),
            torch.as_tensor(wrap * length, dtype=dt, device=dev),
            offs.index((0, 0, 0)))


def _augmented(x, real, first):
    """``[x, |x|², 1]`` (``first``) or ``[-2x, 1, |x|²]`` rows, a padding
    slot's squared norm :data:`_FAR`."""
    import torch

    sq = torch.where(real, (x * x).sum(-1), _FAR)[..., None]
    one = torch.ones_like(sq)
    x = torch.where(real[..., None], x, 0.0)
    return torch.cat([x, sq, one] if first else [-2.0 * x, one, sq], -1)


def frame_counts(a, b, lengths, edges, identical, precision="float64",
                 max_elems=1 << 28):
    """Counts ``(nbins,)`` of one frame's pairs; ``a (N, 3)``,
    ``b (M, 3)``, ``lengths (3,)`` float64."""
    import torch

    lo, hi, nbins = float(edges[0]), float(edges[-1]), len(edges) - 1
    n_cells = tuple(int(v) for v in torch.floor(lengths / hi).tolist())
    if min(n_cells) < 3:
        raise ValueError(f"box {lengths.tolist()} holds fewer than three "
                         f"cells of {hi} Å along an edge")
    ga, ra = _grid(torch.remainder(a, lengths), lengths, n_cells)
    gb, rb = _grid(torch.remainder(b, lengths), lengths, n_cells)
    centre, index, shift, zero = _neighbours(n_cells, lengths)
    counts = torch.zeros(nbins, dtype=torch.float64, device=a.device)
    n_c, p, q = ga.shape[0], ga.shape[1], gb.shape[1]
    step = max(1, max_elems // (27 * p * q))
    for c0 in range(0, n_c, step):
        c1 = min(c0 + step, n_c)
        mid = centre[c0:c1]
        left = _augmented(ga[c0:c1] - mid[:, None], ra[c0:c1], True)
        right = _augmented(gb[index[c0:c1]] + shift[c0:c1, :, None, :]
                           - mid[:, None, None, :], rb[index[c0:c1]], False)
        r2 = torch.matmul(left[:, None], right.transpose(-1, -2))
        if identical:
            r2[:, zero].diagonal(dim1=-2, dim2=-1).fill_(float("inf"))
        r = torch.sqrt(r2[r2 < hi * hi].clamp_(min=0.0))
        if precision == "bfloat16":
            r = r.to(torch.bfloat16).to(torch.float64)
        counts += torch.histc(r, bins=nbins, min=lo, max=hi)
    return counts


def compute(cfg: dict, frames, sel_a: np.ndarray, sel_b: np.ndarray,
            box: np.ndarray, precision: str = "float64") -> dict:
    """``{"count": (nbins,), "rdf": (nbins,)}`` float64 numpy arrays
    over every frame of ``frames`` (one fixed orthorhombic box)."""
    import torch

    dev = frames.device
    dt = torch.float64
    lo, hi = cfg["range"]
    edges = np.linspace(lo, hi, cfg["nbins"] + 1)
    lengths = torch.as_tensor(np.asarray(box[:3], np.float64), dtype=dt,
                              device=dev)
    ia = torch.as_tensor(sel_a, device=dev)
    ib = torch.as_tensor(sel_b, device=dev)
    identical = np.array_equal(sel_a, sel_b)
    counts = torch.zeros(cfg["nbins"], dtype=torch.float64, device=dev)
    for _, chunk in frames.chunks():
        for x in chunk:
            a, b = x[ia].to(dt), x[ib].to(dt)
            if precision == "bfloat16":
                a = a.to(torch.bfloat16).to(dt)
                b = b.to(torch.bfloat16).to(dt)
            counts += frame_counts(a, b, lengths, edges, identical,
                                   precision)
    counts = counts.cpu().numpy()
    t = frames.n_frames
    n_pairs = len(sel_a) * len(sel_b) - (len(sel_a) if identical else 0)
    volume = float(np.prod(np.asarray(box[:3], np.float64)))
    shells = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    rdf = counts / (n_pairs / volume * shells * t)
    return {"count": counts, "rdf": rdf}


def compare(answers: list[dict], ref: dict) -> dict:
    """The numbers compared, over every answer: the pairs binned
    otherwise than the reference bins them, as a share of the pairs
    it bins (the L1 gap of the counts over their sum), and the widest
    gap of g(r)."""
    count_gap, rdf_gap = 0.0, 0.0
    total = float(ref["count"].sum())
    for a in answers:
        c = np.asarray(a["count"], np.float64)
        g = np.asarray(a["rdf"], np.float64)
        if (c.shape != ref["count"].shape or not np.isfinite(c).all()
                or not np.isfinite(g).all()):
            return {"count_l1_rel": float("inf"), "rdf_gap": float("inf")}
        count_gap = max(count_gap,
                        float(np.abs(c - ref["count"]).sum()) / total)
        rdf_gap = max(rdf_gap, float(np.abs(g - ref["rdf"]).max()))
    return {"count_l1_rel": count_gap, "rdf_gap": rdf_gap}
