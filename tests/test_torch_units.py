"""Twin of ``tests/test_units.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

units.convert: exact factors against independent physical
constants, round-trip identity, array elementwise behavior, and the
loud cross-category / unknown-unit contract."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch import units

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, outcome, port_runs_on_the_cpu)


def test_length_conversions():
    assert units.convert(1.0, "nm", "A") == pytest.approx(10.0)
    assert units.convert(10.0, "A", "nm") == pytest.approx(1.0)
    assert units.convert(1.0, "A", "pm") == pytest.approx(100.0)


def test_time_conversions():
    assert units.convert(1.0, "ns", "ps") == pytest.approx(1000.0)
    assert units.convert(1000.0, "fs", "ps") == pytest.approx(1.0)
    assert units.convert(1.0, "ps", "s") == pytest.approx(1e-12)


def test_energy_force_charge():
    assert units.convert(1.0, "kcal/mol", "kJ/mol") == pytest.approx(
        4.184)
    assert units.convert(4.184, "kJ/(mol*A)",
                         "kcal/(mol*A)") == pytest.approx(1.0)
    # one electron in coulombs
    assert units.convert(1.0, "e", "C") == pytest.approx(
        1.602176634e-19)


def test_round_trip_all_units():
    rng = np.random.default_rng(0)
    for cat, table in units.conversion_factor.items():
        base = next(iter(table))
        for u in table:
            x = float(rng.uniform(0.5, 2.0))
            back = units.convert(units.convert(x, base, u), u, base)
            assert back == pytest.approx(x, rel=1e-12), (cat, u)


def test_array_elementwise():
    out = units.convert(np.array([1.0, 2.0, 3.0]), "nm", "A")
    np.testing.assert_allclose(out, [10.0, 20.0, 30.0])


def test_cross_category_and_unknown_raise():
    with pytest.raises(ValueError, match="cannot convert"):
        units.convert(1.0, "nm", "ps")
    with pytest.raises(ValueError, match="not recognized"):
        units.convert(1.0, "parsec", "A")


def test_get_conversion_factor_signature():
    assert units.get_conversion_factor("length", "nm",
                                       "A") == pytest.approx(10.0)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


_UNIT_PAIRS = [
    ("length", "A", "nm"), ("length", "nm", "A"), ("length", "A", "pm"),
    ("time", "ps", "ns"), ("time", "fs", "ps"), ("time", "AKMA", "ps"),
    ("energy", "kcal/mol", "kJ/mol"), ("energy", "kJ/mol", "eV"),
    ("speed", "A/ps", "nm/ps"), ("force", "kJ/(mol*A)", "kJ/(mol*nm)"),
    ("charge", "e", "Amber"), ("density", "A^{-3}", "nm^{-3}"),
    ("length", "A", "parsec"),
]


@pytest.mark.parametrize("category,u1,u2", _UNIT_PAIRS)
def test_conversions_match_jax_package(category, u1, u2):
    x = np.linspace(-3, 7, 11)
    ref, port = both(lambda mod: (
        outcome(lambda: mod("units").get_conversion_factor(category, u1,
                                                           u2)),
        outcome(lambda: mod("units").convert(x, u1, u2))))
    assert_same(ref, port)


def test_unit_tables_match_jax_package():
    def case(mod):
        u = mod("units")
        return {k: v for k, v in sorted(vars(u).items())
                if not k.startswith("_") and isinstance(v, (dict, float))}
    assert_same(*both(case))
