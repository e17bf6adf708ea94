"""Native-contacts analysis (fraction of native contacts q).

Upstream-API mirror (``MDAnalysis.analysis.contacts.Contacts``): define
the *native* contact pairs from a reference frame (all inter-group
pairs within ``radius``), then score every trajectory frame by the
fraction of those pairs still in contact — ``hard_cut`` (distance <
radius) or ``soft_cut`` (Best–Hummer switching
``1/(1+exp(β(r−λr₀)))``).  ``Contacts(u, select=(s1, s2),
refgroup=(r1, r2)).run()`` → ``results.timeseries`` (T, 2):
``[frame, q]``.

A time-series analysis over a *fixed pair list*: only the union of
paired atoms is staged, every batch's P pair distances are one gather
and one batched minimum image (``torch.vmap`` of
:func:`~mdanalysis_mpi_tpu_torch.ops.distances.minimum_image` over the
frames' boxes), and q is a mean; no (N²) matrix is ever built.
"""

from __future__ import annotations

import numpy as np
import torch

from mdanalysis_mpi_tpu_torch.analysis.base import (AnalysisBase, Deferred,
                                                    reject_updating_groups,
                                                    to_numpy)
from mdanalysis_mpi_tpu_torch.ops.host import distance_array, minimum_image


def hard_cut_q(r: np.ndarray, r0: np.ndarray, radius: float) -> np.ndarray:
    """Fraction of pairs with r < radius (upstream ``hard_cut_q``)."""
    del r0
    return np.asarray(r) < radius


def soft_cut_q(r: np.ndarray, r0: np.ndarray, beta: float = 5.0,
               lambda_constant: float = 1.8) -> np.ndarray:
    """Best–Hummer soft switching: 1/(1+exp(β(r − λ·r₀)))."""
    return 1.0 / (1.0 + np.exp(beta * (np.asarray(r)
                                       - lambda_constant * np.asarray(r0))))


# ---- module-level batch functions ----

def _pair_r_batch(params, batch, boxes):
    """(B, P) minimum-image distances of the pairs ``(s1[p], s2[p])``,
    each frame under its own box (a zero box wraps nothing)."""
    from mdanalysis_mpi_tpu_torch.ops.distances import minimum_image as mi

    s1, s2 = params[0], params[1]
    disp = torch.vmap(mi)(batch[:, s1] - batch[:, s2], boxes)   # (B, P, 3)
    return (disp ** 2).sum(-1) ** 0.5


def _hard_kernel(params, batch, boxes, mask):
    s1, s2, _, radius = params
    r = _pair_r_batch((s1, s2), batch, boxes)
    q = (r < radius).to(batch.dtype).mean(dim=1)
    return (q * mask, mask)


def _soft_kernel(params, batch, boxes, mask):
    s1, s2, r0, beta, lam = params
    r = _pair_r_batch((s1, s2), batch, boxes)
    q = (1.0 / (1.0 + torch.exp(beta * (r - lam * r0)))).mean(dim=1)
    return (q * mask, mask)


class Contacts(AnalysisBase):
    """``Contacts(u, select=(s1, s2), refgroup=(ref1, ref2),
    radius=4.5, method='hard_cut').run()``.

    ``refgroup`` AtomGroups (typically from a reference universe at its
    native frame) define the native pairs; ``select`` strings pick the
    matching groups in ``u`` (atom counts must agree).  ``method`` is
    ``'hard_cut'``, ``'soft_cut'``, or a callable ``f(r, r0, **kwargs)``
    (serial backend only for callables).  Minimum-image PBC is applied
    when frames carry a box.
    """

    def __init__(self, universe, select, refgroup, radius: float = 4.5,
                 method="hard_cut", verbose: bool = False, **method_kwargs):
        super().__init__(universe, verbose)
        s1, s2 = select
        ref1, ref2 = refgroup
        # the refgroups' reference distances and the selections' pair
        # indices are snapshotted below and the groups dropped — the
        # run()-time updating-group scan cannot catch them here
        reject_updating_groups(ref1, ref2, owner="Contacts")
        ag1 = universe.select_atoms(s1)
        ag2 = universe.select_atoms(s2)
        if ag1.n_atoms != ref1.n_atoms or ag2.n_atoms != ref2.n_atoms:
            raise ValueError(
                f"select sizes ({ag1.n_atoms}, {ag2.n_atoms}) do not match "
                f"refgroup sizes ({ref1.n_atoms}, {ref2.n_atoms})")
        if isinstance(method, str) and method not in ("hard_cut", "soft_cut"):
            raise ValueError(
                f"method must be 'hard_cut', 'soft_cut' or a callable, "
                f"got {method!r}")
        allowed = {"hard_cut": set(), "soft_cut": {"beta", "lambda_constant"}}
        if isinstance(method, str):
            bad = set(method_kwargs) - allowed[method]
            if bad:
                raise TypeError(
                    f"{method} does not accept {sorted(bad)}; "
                    f"allowed: {sorted(allowed[method]) or 'none'}")
        self._method = method
        self._method_kwargs = method_kwargs
        self._radius = float(radius)

        # native pairs from the reference frame (its own box)
        ts = ref1.universe.trajectory.ts
        d = distance_array(ts.positions[ref1.indices],
                           ts.positions[ref2.indices], ts.dimensions)
        ii, jj = np.nonzero(d < radius)
        if len(ii) == 0:
            raise ValueError(
                f"no native contacts within radius {radius} in the "
                "reference frame")
        self.r0 = d[ii, jj]
        self._gpairs = (ag1.indices[ii], ag2.indices[jj])
        self.n_initial_contacts = len(ii)

    def _prepare(self):
        g1, g2 = self._gpairs
        uniq, inv = np.unique(np.concatenate([g1, g2]),
                              return_inverse=True)
        self._idx = uniq
        self._s1 = inv[: len(g1)].astype(np.int64)
        self._s2 = inv[len(g1):].astype(np.int64)
        self._serial_q = []

    def _q_of(self, r: np.ndarray) -> float:
        if self._method == "hard_cut":
            return float(hard_cut_q(r, self.r0, self._radius).mean())
        if self._method == "soft_cut":
            return float(soft_cut_q(r, self.r0,
                                    **self._method_kwargs).mean())
        return float(np.mean(self._method(r, self.r0,
                                          **self._method_kwargs)))

    # -- serial path --

    def _single_frame(self, ts):
        pos = ts.positions[self._idx].astype(np.float64)
        disp = minimum_image(pos[self._s1] - pos[self._s2], ts.dimensions)
        r = np.sqrt((disp ** 2).sum(-1))
        self._serial_q.append(self._q_of(r))

    def _serial_summary(self):
        q = np.asarray(self._serial_q)
        return (q, np.ones(len(q)))

    # -- batch path --

    def _batch_select(self):
        return self._idx

    def _batch_fn(self):
        if not isinstance(self._method, str):
            raise ValueError(
                "callable contact methods run on the serial backend only")
        return (_hard_kernel if self._method == "hard_cut"
                else _soft_kernel)

    def _batch_params(self):
        s1 = torch.as_tensor(self._s1)
        s2 = torch.as_tensor(self._s2)
        r0 = torch.as_tensor(self.r0, dtype=torch.float32)
        if self._method == "hard_cut":
            return (s1, s2, r0, np.float32(self._radius))
        kw = self._method_kwargs
        return (s1, s2, r0, np.float32(kw.get("beta", 5.0)),
                np.float32(kw.get("lambda_constant", 1.8)))

    # no _device_fold_fn: a time series, concatenated in frame order

    def _identity_partials(self):
        return (np.empty(0), np.empty(0))

    def _conclude(self, total):
        q, mask = total
        frames = np.asarray(self._frame_indices, dtype=np.float64)

        def _finalize():
            qv = np.asarray(to_numpy(q))[np.asarray(to_numpy(mask)) > 0.5]
            return np.column_stack([frames[: len(qv)], qv])

        self.results.timeseries = Deferred(_finalize)
