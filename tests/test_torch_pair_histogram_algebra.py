"""The pair-histogram kernel's two exact rewrites (the header of
``mdanalysis_mpi_tpu_torch/csrc/pair_histogram.cu``), held on the CPU to
the algebra of the kernel's plain version.

- ``fused_distances.wrap_nodiv``, the minimum image without a division,
  bit for bit against ``d - torch.round(d / L) * L`` (the plain
  version's wrap), up to the sign of a zero, which the square removes:
  over +-2000 ulps around +-L/2 and +-L, uniform draws in (-L, L), and
  |d| >= L, where the kernel keeps the division.
- ``fused_distances.squared_edge_thresholds``: each ``t_k`` is the
  smallest float32 with ``sqrt(t_k) >= e_k``, and
  ``searchsorted(t, d2)`` equals ``searchsorted(edges, sqrt(d2))`` over
  +-50 ulps of every ``t_k``, random draws and NaN.
- The kernel's choice of form per B atom: where ``fl(hi - b) < L`` and
  ``fl(b - lo) < L`` for the least and greatest A coordinate ``lo``,
  ``hi``, every pair of ``b`` has ``|fl(a - b)| < L``, and the
  division-free form ``min(|d|, L - |d|)`` squares to the plain
  version's square bit for bit.
- The two together, as the kernel applies them, count exactly what
  ``pair_histogram_plain`` counts.
"""

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu_torch.ops import fused_distances as fd

LENGTHS = [99.3, 25.0, 64.0, 128.0, 1.0, 39.1, 18.6, 0.3, 3.14159, 7.77,
           1e-3, 12345.678, 0.5, 2.0 ** -60]

EDGE_SETS = {
    "0-15x75": np.linspace(0.0, 15.0, 76),
    "0-1x75": np.linspace(0.0, 1.0, 76),
    "0-12x512": np.linspace(0.0, 12.0, 513),
    "1-bin": np.array([0.0, 12.0]),
    "non-uniform": np.concatenate([[0.0], np.geomspace(0.5, 15.0, 40)]),
    "above-0": np.linspace(2.5, 15.0, 51),
    "from-negative": np.linspace(-3.0, 9.0, 25),
}


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _plain_wrap(d, L):
    L = torch.tensor(L, dtype=torch.float32)
    return d - torch.round(d / L) * L


def _around(c, n):
    """The float32s within ``n`` ulps of the positive float32 ``c``, and
    their negatives."""
    bits = _f32(c).view(torch.int32) + torch.arange(-n, n + 1,
                                                    dtype=torch.int32)
    x = bits[bits >= 0].view(torch.float32)
    return torch.cat([x, -x])


def _assert_same_bits(got, want):
    """Equal bit patterns, -0 taken as +0 (x + 0.0 maps -0 to +0 and
    leaves every other float as it is); NaN at the same places."""
    gn, wn = torch.isnan(got), torch.isnan(want)
    assert torch.equal(gn, wn)
    g = (got[~gn] + 0.0).view(torch.int32)
    w = (want[~wn] + 0.0).view(torch.int32)
    bad = (g != w).nonzero().flatten()
    assert bad.numel() == 0, (
        f"{bad.numel()} values differ, e.g. got {got[~gn][bad[:3]]} want "
        f"{want[~wn][bad[:3]]}")


@pytest.mark.parametrize("L", LENGTHS)
def test_wrap_nodiv_around_half_and_full_box(L):
    L32 = float(np.float32(L))
    h = float(np.float32(L) * np.float32(0.5))
    d = torch.cat([_around(h, 2000), _around(L32, 2000)])
    _assert_same_bits(fd.wrap_nodiv(d, L32), _plain_wrap(d, L32))


@pytest.mark.parametrize("L", LENGTHS)
def test_wrap_nodiv_uniform_inside_box(L):
    L32 = np.float32(L)
    r = np.random.default_rng(int(L * 1000) % 2 ** 32)
    d = _f32(r.uniform(-L32, L32, 200_000))
    _assert_same_bits(fd.wrap_nodiv(d, float(L32)), _plain_wrap(d, float(L32)))


@pytest.mark.parametrize("L", LENGTHS)
def test_wrap_nodiv_outside_box_takes_the_division(L):
    """|d| >= L: unwrapped coordinates, the kernel's division branch,
    including whole multiples of L and their neighbours."""
    L32 = np.float32(L)
    r = np.random.default_rng(7)
    far = r.uniform(1.0, 40.0, 50_000) * r.choice([-1.0, 1.0], 50_000)
    d = torch.cat([_f32(far * L32),
                   _around(float(np.float32(2.0) * L32), 300),
                   _around(float(np.float32(1.5) * L32), 300)])
    assert bool((d.abs() >= L32).all())
    _assert_same_bits(fd.wrap_nodiv(d, float(L32)), _plain_wrap(d, float(L32)))


@pytest.mark.parametrize("L", [float("inf"), 2.0 ** -70, 1e-30])
def test_wrap_nodiv_irregular_length_is_the_division_form(L):
    r = np.random.default_rng(1)
    d = _f32(r.uniform(-50.0, 50.0, 10_000))
    _assert_same_bits(fd.wrap_nodiv(d, L), _plain_wrap(d, L))


def _ulps(c, n):
    """The float32s within ``n`` ulps of the float32 ``c`` (either sign)."""
    c = np.float32(c)
    x = _around(float(abs(c)), n)
    x = x[x >= 0]
    return x if c >= 0 else -x


@pytest.mark.parametrize("L", LENGTHS)
def test_span_flag_bounds_every_pair(L):
    """A B atom whose flag is set meets every A atom of the CUDA block
    at |fl(a - b)| < L, so the min form is exact for all its pairs; the
    A coordinates lie in [c, c + L) for a window c at 0, at -L/2 (a
    centred box) and far off, and b runs over ulps around lo + L and
    hi - L, where the flag flips."""
    L32 = np.float32(L)
    r = np.random.default_rng(int(L * 977) % 2 ** 32)
    for c in (np.float32(0.0), np.float32(-0.5) * L32,
              np.float32(3.25) * L32):
        a = _f32(np.clip(c + r.uniform(0, 1, 1000).astype(np.float32) * L32,
                         c, np.nextafter(c + L32, c)))
        lo, hi = a.min(), a.max()
        b = torch.cat([_ulps(float(lo + L32), 300), _ulps(float(hi - L32), 300),
                       _f32(c + r.uniform(-0.5, 1.5, 2000).astype(np.float32)
                            * L32)])
        flag = ((hi - b) < L32) & ((b - lo) < L32)
        assert bool(flag.any()) and bool((~flag).any())
        d = a[:, None] - b[None, flag]
        assert bool((d.abs() < L32).all())
        w = d.abs()
        near = torch.minimum(w, L32 - w)
        plain = _plain_wrap(d, float(L32))
        _assert_same_bits(near * near, plain * plain)


@pytest.mark.parametrize("name", sorted(EDGE_SETS))
def test_thresholds_are_the_smallest_square(name):
    e = _f32(EDGE_SETS[name])
    t = fd.squared_edge_thresholds(e)
    assert t.dtype == torch.float32
    assert bool((t >= 0).all())
    assert bool((torch.sqrt(t) >= e).all())
    prev = torch.nextafter(t, torch.zeros_like(t))
    below = t > 0
    assert bool((torch.sqrt(prev[below]) < e[below]).all())
    assert bool((t[e <= 0] == 0).all())
    assert bool((t[1:] >= t[:-1]).all())


@pytest.mark.parametrize("name", sorted(EDGE_SETS))
def test_searchsorted_on_squares_equals_searchsorted_on_roots(name):
    e = _f32(EDGE_SETS[name])
    t = fd.squared_edge_thresholds(e)
    near = [_around(float(tk), 50) for tk in t.tolist() if tk > 0]
    near = torch.cat(near + [torch.zeros(1)]).abs()
    r = np.random.default_rng(11)
    d2 = torch.cat([
        near,
        _f32(r.uniform(0.0, 1.2 * float(t[-1]) + 1.0, 100_000)),
        _f32([0.0, float("nan"), float("inf"),
              np.finfo(np.float32).max]),
    ])
    d = torch.sqrt(d2)
    assert torch.equal(torch.searchsorted(t, d2, right=True),
                       torch.searchsorted(e, d, right=True))
    # the kernel's range test, on d2 against the plain version's on d:
    # NaN is outside both
    assert torch.equal((d2 >= t[0]) & (d2 < t[-1]), (d >= e[0]) & (d < e[-1]))


def test_thresholds_of_special_edges():
    e = _f32([-np.inf, -1.0, -0.0, 0.0, 1e-30, 1e-45, 1.0, 1e19, 1e20,
              np.inf, np.nan])
    t = fd.squared_edge_thresholds(e)
    assert t[:4].tolist() == [0.0, 0.0, 0.0, 0.0]
    assert float(t[8]) == float("inf") and float(t[9]) == float("inf")
    assert bool(torch.isnan(t[10]))
    fin = t[4:8]
    assert bool((torch.sqrt(fin) >= e[4:8]).all())
    prev = torch.nextafter(fin, torch.zeros_like(fin))
    assert bool((torch.sqrt(prev) < e[4:8]).all())


def _kernel_algebra(a, b, lengths, edges, exclude_self):
    """Counts of the kernel's algebra in torch: division-free wrap where
    it applies, squares in the plain version's order, range and bins on
    d2 against the thresholds."""
    B, N, _ = a.shape
    nbins = edges.shape[0] - 1
    t = fd.squared_edge_thresholds(edges)
    counts = torch.zeros((B, nbins + 1), dtype=torch.int64)
    for f in range(B):
        d2 = None
        for ax in range(3):
            diff = a[f, :, ax, None] - b[f, None, :, ax]
            L = float(lengths[f, ax])
            if L > 0:
                diff = fd.wrap_nodiv(diff, L)
            d2 = diff * diff if d2 is None else d2 + diff * diff
        inside = (d2 >= t[0]) & (d2 < t[-1])
        if exclude_self:
            inside &= (torch.arange(N)[:, None]
                       != torch.arange(b.shape[1])[None, :])
        idx = torch.searchsorted(t, d2.reshape(-1), right=True) - 1
        idx = torch.where(inside.reshape(-1), idx, nbins)
        counts[f] += torch.bincount(idx, minlength=nbins + 1)
    return counts[:, :nbins].to(torch.float32)


@pytest.mark.parametrize("case", ["wrapped", "unwrapped", "no-box",
                                  "mixed-box", "edge-above-0",
                                  "non-uniform", "self"])
def test_kernel_algebra_counts_equal_plain(case):
    r = np.random.default_rng(5)
    L = np.float32(20.0)
    a = r.uniform(0, L, (2, 130, 3)).astype(np.float32)
    b = r.uniform(0, L, (2, 170, 3)).astype(np.float32)
    lengths = np.full((2, 3), L, np.float32)
    edges = np.linspace(0.0, 9.0, 46)
    excl = False
    if case == "unwrapped":
        a += L * r.integers(-1, 2, a.shape).astype(np.float32)
        b += L * r.integers(-1, 2, b.shape).astype(np.float32)
    elif case == "no-box":
        lengths[:] = 0.0
    elif case == "mixed-box":
        lengths[1] = 0.0
        lengths[0, 2] = 0.0
    elif case == "edge-above-0":
        edges = np.linspace(3.0, 9.0, 31)
    elif case == "non-uniform":
        edges = np.concatenate([[0.0], np.geomspace(0.5, 9.0, 30)])
    elif case == "self":
        b = a
        excl = True
    a, b, lengths = _f32(a), _f32(b), _f32(lengths)
    e = _f32(edges)
    want = fd.pair_histogram_plain(a, b, lengths, e, excl)
    got = _kernel_algebra(a, b, lengths, e, excl)
    assert float(want.sum()) > 0
    assert torch.equal(got, want)
