"""A protein of ``n_atoms`` atoms in residues named by ``atom_names``
(CA, CB, HA, HB: half of them heavy) around a random base structure;
each frame is a small rigid rotation of the base about z plus noise.

Copied from ``chip_smoke.py::make_system`` (itself ``bench.py``'s
model), rewritten in PyTorch so that the frames are made on the device
a chunk at a time from the seed: a base of scale ``base_scale_A``
centred on the origin, rotation angles of ``rotation_sigma_rad``,
isotropic noise of ``noise_A`` per axis.
"""

from __future__ import annotations

import numpy as np

from portbench.frames import CHUNK


def topology(cfg):
    from mdanalysis_mpi_tpu_torch.core.topology import Topology

    n = cfg["n_atoms"]
    names = np.array(cfg["atom_names"])
    k = len(names)
    return Topology(names=np.tile(names, n // k + 1)[:n],
                    resnames=np.full(n, cfg["resname"]),
                    resids=np.arange(n) // k + 1)


def dimensions(cfg):
    return None


def selection(cfg) -> np.ndarray:
    """Indices of the atoms named in ``cfg["selected_names"]``, in
    index order (the selection's order)."""
    n = cfg["n_atoms"]
    names = np.array(cfg["atom_names"])
    per_atom = np.tile(names, n // len(names) + 1)[:n]
    return np.flatnonzero(np.isin(per_atom, cfg["selected_names"]))


def shared(cfg, gen, device):
    import torch

    base = torch.randn((cfg["n_atoms"], 3), generator=gen, device=device,
                       dtype=torch.float32) * cfg["base_scale_A"]
    return base - base.to(torch.float64).mean(0).to(torch.float32)


def chunk(cfg, base, gen, device):
    import torch

    angles = torch.randn(CHUNK, generator=gen, device=device,
                         dtype=torch.float32) * cfg["rotation_sigma_rad"]
    noise = torch.randn((CHUNK, cfg["n_atoms"], 3), generator=gen,
                        device=device, dtype=torch.float32) * cfg["noise_A"]
    cos, sin = angles.cos()[:, None], angles.sin()[:, None]
    x, y, z = base[:, 0], base[:, 1], base[:, 2]
    # the row vector times chip_smoke's rotation matrix
    # [[cos, -sin, 0], [sin, cos, 0], [0, 0, 1]]
    noise[..., 0] += x * cos + y * sin
    noise[..., 1] += y * cos - x * sin
    noise[..., 2] += z
    return noise
