"""``protein.py``'s protein, its base structure a compact chain: the
topology, the heavy selection, the per-frame motion (a rotation about z
of ``rotation_sigma_rad`` plus ``noise_A`` of noise) and the dimensions
are ``protein.py``'s; only :func:`shared` differs.

A GROMACS ``.gro`` lists bonded atoms one after another, so consecutive
atoms of a real trajectory lie 1.0-1.6 Å apart, and the XTC coder, which
encodes each atom as its difference from the one before, works on those
small steps.  ``protein.py``'s base draws every atom apart (about 28 Å
between neighbours in the list), which an XTC would encode and decode
unlike a GROMACS file.  Here atom ``i`` sits at the ``i``-th point of a
serpentine walk through a cubic lattice of ``lattice_A`` (rows along x,
back and forth; rows stacked along y, back and forth; layers along z),
so that consecutive points are one lattice step apart; each point is
jittered by up to ``jitter_A`` per axis, and the globule is centred on
the origin.

With ``lattice_A`` 1.5 and ``jitter_A`` 0.04, consecutive base atoms lie
1.42-1.59 Å apart, the globule holds 1 / 1.5³ = 0.296 atoms a cubic Å
(about three times a solvated protein's 0.1: the XTC coder sees the
list's steps, not the density), and 100,000 atoms fill 45 full layers
of a 47-point cube, 69 Å across.
"""

from __future__ import annotations

from portbench.systems.protein import (chunk, dimensions, selection,
                                       topology)

__all__ = ["chunk", "dimensions", "selection", "shared", "topology"]


def shared(cfg, gen, device):
    import torch

    n = cfg["n_atoms"]
    side = round(n ** (1.0 / 3.0))
    if side ** 3 < n:
        side += 1
    i = torch.arange(n, device=device)
    row, x = i // side, i % side
    layer, y = row // side, row % side
    # reversed every other row and layer: each step moves one axis by one
    x = torch.where(row % 2 == 1, side - 1 - x, x)
    y = torch.where(layer % 2 == 1, side - 1 - y, y)
    base = torch.stack([x, y, layer], dim=1).to(torch.float32)
    jitter = torch.rand((n, 3), generator=gen, device=device,
                        dtype=torch.float32) * 2.0 - 1.0
    base = base * cfg["lattice_A"] + jitter * cfg["jitter_A"]
    return base - base.to(torch.float64).mean(0).to(torch.float32)
