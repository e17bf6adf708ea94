"""Plain float64 reference of ``AlignedRMSF``: the two passes of
MDAnalysis-MPI's RMSF.py (lines 56-146).

Pass 1 superposes the selection of every frame onto the selection of
frame 0 and averages it; pass 2 superposes every frame onto that
average and takes each atom's root mean square fluctuation about its
mean.  The superposition removes the selection's centre of mass (its
atoms are all carbon, so of equal mass: the centroid) and applies the
least-squares rotation of the unweighted selection (Kabsch, by a
float64 SVD), then puts the frame at the reference's centre.

The frames are made again on the device, a chunk at a time, from the
seed (:class:`portbench.frames.Frames`); nothing the program made is
read.
"""

from __future__ import annotations

import numpy as np


def _rotations(xc, yc):
    """``(F, 3, 3)`` rotations ``R`` that minimise ``|xc[f] @ R - yc|``
    for centred ``xc (F, S, 3)`` and ``yc (S, 3)``."""
    import torch

    h = (xc.transpose(1, 2) @ yc).cpu()
    u, _, vh = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(u @ vh))
    u[:, :, 2] *= d[:, None]
    return (u @ vh).to(xc.device)


def _aligned(frames, sel, ref_c, ref_com):
    """Each chunk's selection superposed onto ``ref_c`` and put at
    ``ref_com``, float64."""
    import torch

    for _, chunk in frames.chunks():
        x = chunk[:, sel].to(torch.float64)
        del chunk
        xc = x - x.mean(dim=1, keepdim=True)
        yield xc @ _rotations(xc, ref_c) + ref_com


def compute(cfg: dict, frames, sel: np.ndarray) -> dict:
    """``{"average": (S, 3), "rmsf": (S,)}`` float64 numpy arrays over
    every frame of ``frames``."""
    import torch

    dev = frames.device
    idx = torch.as_tensor(sel, device=dev)
    ref = frames.chunk(0)[0, idx].to(torch.float64)
    ref_com = ref.mean(dim=0)
    acc = torch.zeros_like(ref)
    for aligned in _aligned(frames, idx, ref - ref_com, ref_com):
        acc += aligned.sum(dim=0)
    avg = acc / frames.n_frames

    avg_com = avg.mean(dim=0)
    s1 = torch.zeros_like(avg)
    s2 = torch.zeros_like(avg)
    for aligned in _aligned(frames, idx, avg - avg_com, avg_com):
        dev_ = aligned - avg
        s1 += dev_.sum(dim=0)
        s2 += (dev_ * dev_).sum(dim=0)
    t = frames.n_frames
    var = s2 / t - (s1 / t) ** 2
    rmsf = torch.sqrt(var.sum(dim=1))
    return {"average": avg.cpu().numpy(), "rmsf": rmsf.cpu().numpy()}


def _worst(answers, ref, key) -> float:
    worst = 0.0
    for a in answers:
        got = np.asarray(a[key], np.float64)
        if got.shape != ref[key].shape or not np.isfinite(got).all():
            return float("inf")
        worst = max(worst, float(np.abs(got - ref[key]).max()))
    return worst


def compare(answers: list[dict], ref: dict) -> dict:
    """The numbers compared, over every answer: the widest gap of an
    atom's RMSF and of an average coordinate, in Å."""
    return {"rmsf_gap_A": _worst(answers, ref, "rmsf"),
            "average_gap_A": _worst(answers, ref, "average")}
