"""The port's box matrices and pair-distance ops (``ops/_boxmat.py``,
``ops/distances.py``, the generic engine) against the JAX package's
``ops/_boxmat.py`` and ``ops/distances.py`` (its ``engine='xla'``).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: distances, displacements, box matrices and volumes within
1e-5 relative (float32 arithmetic in two libraries).  Unweighted pair
counts are required to be EQUAL: both engines wrap with ``d -
round(d/L)·L``, sum the squares in the order x, y, z and bin with
``searchsorted(..., right) - 1``, and on the CPU neither XLA nor torch
contracts these steps into an FMA here, so no edge tie can flip.
Weighted counts are float sums taken in another order and are held to
1e-5 relative.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

# small shapes: one intra-op thread leaves the CPU to the other workers
torch.set_num_threads(1)

from mdanalysis_mpi_tpu.ops import _boxmat as jax_boxmat  # noqa: E402
from mdanalysis_mpi_tpu.ops import distances as jd  # noqa: E402

from mdanalysis_mpi_tpu_torch.ops import _boxmat as boxmat  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import distances as td  # noqa: E402

EDGES = np.linspace(0.0, 12.0, 49)
BOXES = {
    "ortho": np.array([25.0, 25.0, 25.0, 90.0, 90.0, 90.0], np.float32),
    "ortho-one-axis-open": np.array([25.0, 25.0, 0.0, 90.0, 90.0, 90.0],
                                    np.float32),
    "triclinic": np.array([24.0, 26.0, 28.0, 80.0, 95.0, 70.0], np.float32),
    "zero": np.zeros(6, np.float32),
    "none": None,
}


def _coords(seed, n, scale=25.0):
    return np.random.default_rng(seed).uniform(
        0, scale, size=(n, 3)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("name", sorted(BOXES))
def test_minimum_image(name):
    box = BOXES[name]
    r = np.random.default_rng(1)
    disp = r.uniform(-40, 40, size=(200, 3)).astype(np.float32)
    got = td.minimum_image(_t(disp), _t(box)).numpy()
    want = np.asarray(jd.minimum_image(jnp.asarray(disp), _j(box)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if name in ("zero", "none"):
        np.testing.assert_array_equal(got, disp)     # no wrap without a box


def test_box_to_matrix_and_batch_volumes():
    boxes = np.stack([BOXES["ortho"], BOXES["triclinic"], BOXES["zero"],
                      np.array([30, 30, 30, 60, 60, 60], np.float32)])
    got_m = boxmat.box_to_matrix(_t(boxes)).numpy()
    want_m = np.stack([np.asarray(jax_boxmat.box_to_matrix(jnp.asarray(b)))
                       for b in boxes])
    np.testing.assert_allclose(got_m, want_m, rtol=1e-5, atol=1e-4)
    got_v = boxmat.batch_box_volumes(_t(boxes)).numpy()
    want_v = np.asarray(jax_boxmat.batch_box_volumes(jnp.asarray(boxes)))
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    assert got_v[2] == 0.0      # a zero box has volume 0 (InterRDF n_boxed)
    np.testing.assert_allclose(got_v[0], 25.0 ** 3, rtol=1e-6)


@pytest.mark.parametrize("name", ["ortho", "triclinic", "none"])
def test_distance_arrays(name):
    box = BOXES[name]
    a, b = _coords(2, 30), _coords(3, 45)
    got = td.distance_array(_t(a), _t(b), _t(box)).numpy()
    want = np.asarray(jd.distance_array(jnp.asarray(a), jnp.asarray(b),
                                        _j(box)))
    assert got.shape == (30, 45)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got_s = td.self_distance_array(_t(a), _t(box)).numpy()
    want_s = np.asarray(jd.self_distance_array(jnp.asarray(a), _j(box)))
    assert got_s.shape == (30 * 29 // 2,)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)


def test_pad_tiles():
    x = _coords(4, 10)
    xp, valid = td._pad_tiles(_t(x), 4)
    jxp, jvalid = jd._pad_tiles(jnp.asarray(x), 4)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert tuple(xp.shape) == (3, 4, 3)


HIST_CASES = {
    "box-40x70": dict(na=40, nb=70, box="ortho"),
    "box-300x515": dict(na=300, nb=515, box="ortho"),
    "triclinic": dict(na=90, nb=110, box="triclinic"),
    "no-box": dict(na=60, nb=80, box="none"),
    "exclude-self": dict(na=150, nb=None, box="ortho", exclude_self=True),
    "exclusion-block": dict(na=60, nb=120, box="ortho",
                            exclusion_block=(1, 2)),
    "exclude-self+block-offsets": dict(na=64, nb=None, box="ortho",
                                       exclude_self=True,
                                       exclusion_block=(4, 4),
                                       a_offset=8, b_offset=8),
}


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_pair_histogram_counts_equal(case):
    c = dict(HIST_CASES[case])
    na, nb, box = c.pop("na"), c.pop("nb"), BOXES[c.pop("box")]
    a = _coords(5, na)
    b = a if nb is None else _coords(6, nb)
    got = td.pair_histogram(_t(a), _t(b), _t(EDGES.astype(np.float32)),
                            box=_t(box), tile=64, **c).numpy()
    want = np.asarray(jd.pair_histogram(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(EDGES, jnp.float32),
        box=_j(box), tile=64, **c))
    assert got.dtype == np.float32 and got.shape == (48,)
    np.testing.assert_array_equal(got, want)
    if c.get("exclude_self"):
        assert got.sum() <= na * (na - 1)


def test_pair_histogram_weights_and_offsets():
    """The ring engine's form: per-atom weights, global offsets for the
    self exclusion."""
    a, b = _coords(7, 50), _coords(8, 70)
    r = np.random.default_rng(9)
    wa = r.uniform(0, 2, 50).astype(np.float32)
    wb = r.uniform(0, 2, 70).astype(np.float32)
    kw = dict(exclude_self=True, a_offset=10, b_offset=30, tile=32)
    got = td.pair_histogram(_t(a), _t(b), _t(EDGES.astype(np.float32)),
                            box=_t(BOXES["ortho"]), a_weights=_t(wa),
                            b_weights=_t(wb), **kw).numpy()
    want = np.asarray(jd.pair_histogram(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(EDGES, jnp.float32),
        box=jnp.asarray(BOXES["ortho"]), a_weights=jnp.asarray(wa),
        b_weights=jnp.asarray(wb), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert got.sum() > 0


def test_pair_histogram_batch_with_padded_frame():
    r = np.random.default_rng(10)
    B, N, M = 3, 70, 50
    ca = r.uniform(0, 25, size=(B, N, 3)).astype(np.float32)
    cb = r.uniform(0, 25, size=(B, M, 3)).astype(np.float32)
    boxes = np.stack([BOXES["ortho"], BOXES["triclinic"], BOXES["ortho"]])
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    got = td.pair_histogram_batch(_t(ca), _t(cb), _t(boxes), _t(mask),
                                  _t(EDGES.astype(np.float32)), tile=32)
    want = jd.pair_histogram_batch(
        jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(boxes),
        jnp.asarray(mask), jnp.asarray(EDGES, jnp.float32), tile=32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
    assert float(got[2]) == float(want[2]) == 2.0


def test_contact_fraction_batch():
    r = np.random.default_rng(12)
    coords = r.uniform(0, 20, size=(4, 24, 3)).astype(np.float32)
    boxes = np.stack([BOXES["ortho"]] * 2 + [BOXES["zero"]] * 2)
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    got_c, got_t = td.contact_fraction_batch(
        _t(coords), _t(boxes), _t(mask), torch.tensor(8.0))
    want_c, want_t = jd.contact_fraction_batch(
        jnp.asarray(coords), jnp.asarray(boxes), jnp.asarray(mask), 8.0)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert float(got_t) == float(want_t) == 3.0
    assert np.all(np.diag(got_c.numpy()) == 3.0)     # self-contacts
