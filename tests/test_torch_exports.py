"""The port's package ``__init__`` files export what the JAX package's do.

Every package of ``mdanalysis_mpi_tpu`` has a counterpart in
``mdanalysis_mpi_tpu_torch``.  Each counterpart's ``__all__`` equals the
reference's, with ``JaxExecutor`` read as ``TorchExecutor`` (the one
renamed export) and the port's documented additions below; every name
the reference's ``__init__`` binds at module level, or resolves through
its module ``__getattr__``, resolves in the port.  The migration
guide's flow (``mdt.analysis.RMSF``) is run in a fresh process, where
nothing has imported the submodules before.
"""

import ast
import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "mdanalysis_mpi_tpu"
PORT_PKG = "mdanalysis_mpi_tpu_torch"

# reference name -> port name
RENAMED = {"JaxExecutor": "TorchExecutor"}

# names the port exports beyond the reference, each a type or function
# the port's own behaviour needs to name (ROADMAP §C records why)
PORT_ADDITIONS = {
    # a collection refuses an analysis whose algorithm is a run()
    # override with its own error type
    "analysis": {"UncoalescableAnalysisError"},
    # the chain stops at Torch on a CUDA device (no serial on the card)
    "reliability": {"degradation_chain"},
    # the scheduler refuses instead of shedding a card job to serial
    "service": {"BackendUnavailableError"},
}


def _packages():
    root = os.path.join(REPO, JAX_PKG)
    out = []
    for d, _, files in os.walk(root):
        if "__init__.py" in files and "__pycache__" not in d:
            rel = os.path.relpath(d, root)
            out.append("" if rel == "." else rel.replace(os.sep, "."))
    return sorted(out)


PACKAGES = _packages()


def _name(base, sub):
    return base + ("." + sub if sub else "")


def _module_level_names(sub):
    """Public names the reference's ``__init__.py`` binds or resolves:
    imports, assignments, defs, and the string constants its module
    ``__getattr__`` compares the name with."""
    path = os.path.join(REPO, JAX_PKG, *sub.split(".") if sub else [],
                        "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name == "__getattr__":
                for c in ast.walk(node):
                    if isinstance(c, ast.Compare):
                        for e in [c.left, *c.comparators]:
                            for k in ast.walk(e):
                                if (isinstance(k, ast.Constant)
                                        and isinstance(k.value, str)):
                                    names.add(k.value)
            else:
                names.add(node.name)
    return sorted(n for n in names
                  if not n.startswith("_") and n != "annotations")


def test_every_reference_package_has_a_port():
    assert "" in PACKAGES and "parallel" in PACKAGES
    for sub in PACKAGES:
        assert os.path.isfile(os.path.join(
            REPO, PORT_PKG, *sub.split(".") if sub else [], "__init__.py")), sub


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_all_matches_reference(sub):
    ref = importlib.import_module(_name(JAX_PKG, sub))
    port = importlib.import_module(_name(PORT_PKG, sub))
    ref_all = getattr(ref, "__all__", None)
    port_all = getattr(port, "__all__", None)
    if ref_all is None:
        assert port_all is None
        return
    want = {RENAMED.get(n, n) for n in ref_all}
    assert set(port_all) == want | PORT_ADDITIONS.get(sub, set())
    assert len(port_all) == len(set(port_all))


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_every_exported_name_resolves(sub):
    port = importlib.import_module(_name(PORT_PKG, sub))
    for n in getattr(port, "__all__", ()):
        assert getattr(port, n) is not None, n


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_reference_module_level_names_resolve(sub):
    port = importlib.import_module(_name(PORT_PKG, sub))
    missing = [n for n in _module_level_names(sub)
               if not hasattr(port, RENAMED.get(n, n))]
    assert missing == [], missing


def test_renamed_executor_is_the_torch_one():
    from mdanalysis_mpi_tpu_torch import parallel
    from mdanalysis_mpi_tpu_torch.parallel import executors

    assert parallel.TorchExecutor is executors.TorchExecutor
    assert parallel.get_executor is executors.get_executor
    assert isinstance(parallel.get_executor("torch", device="cpu"),
                      executors.TorchExecutor)
    assert not hasattr(parallel, "JaxExecutor")


def test_ops_exports_modules_not_functions():
    from mdanalysis_mpi_tpu_torch import ops

    for n in ops.__all__:
        mod = getattr(ops, n)
        assert mod.__name__ == f"{PORT_PKG}.ops.{n}"
    with pytest.raises(AttributeError):
        ops.no_such_module


def test_unknown_top_level_name_is_an_attribute_error():
    import mdanalysis_mpi_tpu_torch as mdt

    assert not hasattr(mdt, "no_such_layer")
    with pytest.raises(AttributeError):
        mdt.no_such_layer


_FRESH = r"""
import sys
import mdanalysis_mpi_tpu_torch as mdt
assert "torch" not in sys.modules, "import pulled in torch"
from mdanalysis_mpi_tpu_torch.utils import TIMERS, PhaseTimers
assert isinstance(TIMERS, PhaseTimers)
assert "torch" not in sys.modules, "utils pulled in torch"
from mdanalysis_mpi_tpu_torch.parallel import static_blocks
assert "torch" not in sys.modules, "parallel pulled in torch"
from mdanalysis_mpi_tpu_torch.parallel import get_executor
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
u = make_protein_universe(n_residues=6, n_frames=8)
ca = u.select_atoms("name CA")
r = mdt.analysis.RMSF(ca).run(backend="torch", device="cpu", batch_size=4)
s = mdt.analysis.RMSF(ca).run(backend="serial")
import numpy as np
assert np.allclose(r.results.rmsf, s.results.rmsf, atol=1e-4)
assert get_executor("serial").__class__.__name__ == "SerialExecutor"
for layer in ("analysis", "ops", "parallel", "io", "utils", "obs"):
    assert getattr(mdt, layer).__name__ == "mdanalysis_mpi_tpu_torch." + layer
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "mdanalysis_mpi_tpu")
             or m.startswith(("jax.", "jaxlib.", "mdanalysis_mpi_tpu.")))
print("BAD", bad)
"""


def test_migration_flow_in_a_fresh_process():
    """``docs/MIGRATION.md``'s ``mdt.analysis.RMSF`` with nothing
    imported beforehand; the bare import and the timers and partitioner
    imports pull in neither torch nor JAX."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", _FRESH], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "BAD []" in p.stdout
