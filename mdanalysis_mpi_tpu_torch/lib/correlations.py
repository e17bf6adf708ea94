"""Discrete autocorrelation utilities (upstream
``MDAnalysis.lib.correlations``).

The shared math behind SurvivalProbability and hydrogen-bond lifetimes,
exposed in upstream's public list-of-sets API:

- :func:`autocorrelation(list_of_sets, tau_max, window_step=1)` —
  continuous-survival autocorrelation: for each lag τ, the mean over
  window starts t of ``|S_t ∩ S_{t+1} ∩ … ∩ S_{t+τ}| / |S_t|``
  (an element must be present through EVERY intermediate frame).
- :func:`correct_intermittency(list_of_sets, intermittency)` — fill
  departures of ≤ ``intermittency`` consecutive frames for elements
  present on both sides, BEFORE the survival product (upstream's
  intermittent preprocessing).

Internally both pack the sets into one (T, n_elements) boolean matrix
and reduce with vectorized running ANDs — the same representation the
analysis classes use directly (``analysis/waterdynamics.py``,
``analysis/hbonds.py:lifetime``).
"""

from __future__ import annotations

import numpy as np


def intermittency_filter(mask: np.ndarray, k: int) -> np.ndarray:
    """Fill gaps of ≤ k consecutive absent frames for columns present
    on both sides — the boolean-matrix core of
    :func:`correct_intermittency` (matrix layout: (T, n_elements))."""
    if k <= 0:
        return mask
    out = mask.copy()
    t = mask.shape[0]
    for gap in range(1, k + 1):
        # present at i and at i+gap+1 with the gap in between → filled
        for i in range(t - gap - 1):
            bridge = mask[i] & mask[i + gap + 1]
            if bridge.any():
                out[i + 1:i + gap + 1] |= bridge
    return out


def _sets_to_matrix(list_of_sets):
    elements = sorted(set().union(*list_of_sets)) if list_of_sets else []
    index = {e: i for i, e in enumerate(elements)}
    mat = np.zeros((len(list_of_sets), len(elements)), dtype=bool)
    for t, s in enumerate(list_of_sets):
        for e in s:
            mat[t, index[e]] = True
    return mat, elements


def correct_intermittency(list_of_sets, intermittency: int):
    """Upstream API: list of per-frame sets → list of per-frame sets
    with gaps of ≤ ``intermittency`` frames filled."""
    if intermittency < 0:
        raise ValueError(
            f"intermittency must be >= 0, got {intermittency}")
    if intermittency == 0 or not list_of_sets:
        return [set(s) for s in list_of_sets]
    mat, elements = _sets_to_matrix(list_of_sets)
    mat = intermittency_filter(mat, int(intermittency))
    return [{elements[i] for i in np.flatnonzero(row)} for row in mat]


def survival_windows(mask: np.ndarray, tau_max: int,
                     window_step: int = 1) -> list:
    """The ONE running-AND survival reduction (matrix level), shared by
    :func:`autocorrelation`, ``SurvivalProbability`` and
    ``HydrogenBondAnalysis.lifetime`` so the semantics cannot drift.

    mask: (T, n_elements) bool.  Returns, for each τ = 0..tau_max, the
    list of per-window survival fractions
    ``|S_t ∩ … ∩ S_{t+τ}| / |S_t|`` over window starts
    ``t = 0, window_step, …`` with ``|S_t| > 0`` (empty list when no
    window fits or every eligible start is empty)."""
    if tau_max < 0:
        raise ValueError(f"tau_max must be >= 0, got {tau_max}")
    if window_step < 1:
        raise ValueError(f"window_step must be >= 1, got {window_step}")
    t = len(mask)
    starts = np.arange(0, t, window_step)
    n0 = mask.sum(axis=1).astype(np.float64)
    surviving = mask.copy()
    data: list = []
    for tau in range(int(tau_max) + 1):
        if tau > t - 1:
            data.append([])
            continue
        if tau:
            surviving = surviving[:-1] & mask[tau:]
        ok = starts[starts < t - tau]
        ok = ok[n0[ok] > 0]
        data.append((surviving[ok].sum(axis=1) / n0[ok]).tolist())
    return data


def autocorrelation(list_of_sets, tau_max: int, window_step: int = 1):
    """Upstream API: ``(tau_timeseries, timeseries, timeseries_data)``.

    Upstream-exact shapes: ``tau_timeseries`` = [0..tau_max] and
    ``timeseries`` has tau_max+1 entries REGARDLESS of trajectory
    length (lags with no fitting window are NaN, never silently
    dropped); ``timeseries_data`` has tau_max entries indexed by
    ``τ−1`` (the τ=0 point carries no per-window list upstream).
    ``timeseries[0]`` is 1.0 whenever any window has members."""
    mat, _ = _sets_to_matrix(list_of_sets)
    if len(mat) == 0:
        raise ValueError("autocorrelation over zero frames")
    data = survival_windows(mat, tau_max, window_step)
    tau_timeseries = list(range(int(tau_max) + 1))
    timeseries = [float(np.mean(v)) if v else float("nan")
                  for v in data]
    return tau_timeseries, timeseries, data[1:]
