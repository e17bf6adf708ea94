"""A TIP3P-like water box: ``n_waters`` oxygens on a jittered cubic
lattice in a cubic box of ``box_A``, each with two hydrogens, every
frame drawn afresh.

Copied from ``mdanalysis_mpi_tpu_torch/testing.py::make_water_universe``
(the model of ``chip_smoke.py::make_water``), rewritten in PyTorch so
that the frames are made on the device a chunk at a time from the seed:
lattice jitter ``jitter_A``, oxygens wrapped into the box, hydrogens at
``h_offsets_A`` from their oxygen plus ``h_jitter_A`` of noise.
"""

from __future__ import annotations

import numpy as np

from portbench.frames import CHUNK


def topology(cfg):
    from mdanalysis_mpi_tpu_torch.core.topology import Topology

    w = cfg["n_waters"]
    return Topology(names=np.array(["OW", "HW1", "HW2"] * w),
                    resnames=np.full(3 * w, cfg["resname"]),
                    resids=np.repeat(np.arange(1, w + 1), 3),
                    segids=np.full(3 * w, "WAT"))


def dimensions(cfg):
    b = cfg["box_A"]
    return np.array([b, b, b, 90.0, 90.0, 90.0], np.float32)


def selection(cfg) -> np.ndarray:
    """The oxygens' indices."""
    return np.arange(cfg["n_waters"]) * 3


def shared(cfg, gen, device):
    import torch

    w = cfg["n_waters"]
    side = int(np.ceil(w ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)[:w]
    spacing = cfg["box_A"] / side
    return torch.as_tensor((grid + 0.5) * spacing, dtype=torch.float32,
                           device=device)


def chunk(cfg, sites, gen, device):
    import torch

    w = cfg["n_waters"]
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    o = sites + torch.randn((CHUNK, w, 3), **kw) * cfg["jitter_A"]
    o = torch.remainder(o, cfg["box_A"])
    frames = torch.empty((CHUNK, w, 3, 3), dtype=torch.float32,
                         device=device)
    frames[:, :, 0] = o
    for i, off in enumerate(cfg["h_offsets_A"]):
        frames[:, :, i + 1] = (o + torch.randn((CHUNK, w, 3), **kw)
                               * cfg["h_jitter_A"]
                               + torch.tensor(off, dtype=torch.float32,
                                              device=device))
    return frames.reshape(CHUNK, 3 * w, 3)
