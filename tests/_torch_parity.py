"""Shared pieces of the port's twins of the JAX package's test files
(``tests/test_torch_<name>.py`` for ``tests/test_<name>.py``).

- :func:`port_runs_on_the_cpu`, imported into a twin, is a module-scoped
  autouse fixture: the port's default device (``cuda`` otherwise) is
  the CPU for every case of that module, as ``device="cpu"`` would make
  it.
- :func:`mesh_kw` maps the reference's 8-virtual-device mesh to four
  shards on the CPU.
- :func:`both`, :func:`outcome` and :func:`assert_same` run one case on
  each package's modules and compare the outcomes.
"""

import importlib

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch import device as _port_device

#: the reference's 8-device mesh: four shards on the CPU
MESH_DEVICES = ["cpu"] * 4


@pytest.fixture(autouse=True, scope="module")
def port_runs_on_the_cpu():
    """Every case runs the port with ``device="cpu"``: the default
    device, ``cuda`` otherwise, is the CPU for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_port_device, "DEFAULT_DEVICE", "cpu")
        yield


def mesh_kw(backend):
    """``run()`` keywords of ``backend``: the mesh on
    :data:`MESH_DEVICES`."""
    return ({"backend": "mesh", "devices": MESH_DEVICES}
            if backend == "mesh" else {"backend": backend})


def both(case):
    """``case(mod)`` for the JAX package, then for the port;
    ``mod("io.xtc")`` imports that module of the package at hand."""
    return [case(lambda sub="", p=pkg: importlib.import_module(
                p + ("." + sub if sub else "")))
            for pkg in ("mdanalysis_mpi_tpu", "mdanalysis_mpi_tpu_torch")]


def outcome(fn):
    """``("ok", value)``, or ``("raise", error class name)``: a refusal
    is part of the behaviour the two packages share."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 -- the class is the result
        return ("raise", type(e).__name__)


def assert_same(a, b, **tol):
    """Equal structure; arrays equal, or within ``tol`` when given."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k], **tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y, **tol)
    elif a is None or isinstance(a, (str, bytes, bool)):
        assert a == b
    elif tol:
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **tol)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
