"""`mdtpu lint` of the PyTorch port (``mdanalysis_mpi_tpu_torch/lint``):
per-rule fixtures, the seeded-bug corpus, parity with the JAX package's
checker, the capture contracts on the CPU, the tree self-check and the
command line.

- **Per-rule fixtures** — each rule's smallest positive and nearest
  negative (the JAX package's ``tests/test_lint.py`` cases, with the
  MDT1xx ones rewritten for torch batch functions and captured groups).
- **Seeded-bug corpus** — the historical bugs reintroduced into the
  port's own modules: stripping the ``PhaseTimers.phase`` lock trips
  MDT001, turning the scheduler's ``notify_all()`` back into
  ``notify()`` trips MDT002.
- **Parity** — the same fixture sources and synthetic schema trees give
  equal findings from both packages' MDT001-MDT005 and MDT201-MDT206,
  and the two rule catalogs have the same ids.
- **Capture tier on the CPU** — MDT110 over eager group bodies (a
  collective inside a body fires; the mesh scan program is clean with
  one combine a group) and the MDT111 predicate on synthetic node
  lists (the graphs themselves are read on the card,
  ``tests/test_torch_cuda.py``).
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mdanalysis_mpi_tpu.lint import concurrency as jax_concurrency  # noqa: E402
from mdanalysis_mpi_tpu.lint import core as jax_core  # noqa: E402
from mdanalysis_mpi_tpu.lint import persistence as jax_persistence  # noqa: E402
from mdanalysis_mpi_tpu.lint import schema as jax_schema  # noqa: E402
from mdanalysis_mpi_tpu_torch.lint import (  # noqa: E402
    concurrency, graphcontracts, persistence, schema,
)
from mdanalysis_mpi_tpu_torch.lint.core import (  # noqa: E402
    Baseline, Finding, all_rules, pragma_suppressed, rule_ids, run_lint,
)

PKG = "mdanalysis_mpi_tpu_torch"
BASELINE = os.path.join(REPO, PKG, "lint", "baseline.json")


def _rules(findings):
    return {f.rule for f in findings}


def _check(src: str, rel: str = f"{PKG}/service/mod.py"):
    tree = ast.parse(src)
    return (concurrency.check_module(tree, rel)
            + graphcontracts.check_module(tree, rel))


def _check_persist(src: str, rel: str = f"{PKG}/service/mod.py"):
    return persistence.check_module(ast.parse(src), rel)


# ---------------------------------------------------- MDT001 lock discipline

_LOCKED_CLASS = """
import threading

class Counters:
    def __init__(self):
        self._lock = threading.Lock()
        self._acc = dict()

    def bump(self, name):
        with self._lock:
            self._acc[name] = self._acc.get(name, 0) + 1

    def {method}(self, name):
{body}
"""

_MDT001_CASES = {
    "racy_rmw": ("racy",
                 "        self._acc[name] = self._acc.get(name, 0) + 1"),
    "locked": ("fine", "        with self._lock:\n"
                       "            self._acc[name] = 0"),
    "locked_suffix": ("clear_locked", "        self._acc[name] = 0"),
    "unshared": ("other", "        self.unrelated = name"),
    "mutating_call": ("racy", "        self._acc.update(dict(name=1))"),
}


def test_mdt001_positive_unlocked_rmw():
    src = _LOCKED_CLASS.format(method="racy",
                               body=_MDT001_CASES["racy_rmw"][1])
    found = [f for f in _check(src) if f.rule == "MDT001"]
    assert len(found) == 1
    assert found[0].symbol == "Counters.racy"
    assert found[0].detail == "_acc"


@pytest.mark.parametrize("case", ["locked", "locked_suffix", "unshared"])
def test_mdt001_negatives(case):
    method, body = _MDT001_CASES[case]
    src = _LOCKED_CLASS.format(method=method, body=body)
    assert "MDT001" not in _rules(_check(src))


def test_mdt001_mutating_calls_count():
    method, body = _MDT001_CASES["mutating_call"]
    found = [f for f in _check(_LOCKED_CLASS.format(method=method,
                                                    body=body))
             if f.rule == "MDT001"]
    assert len(found) == 1 and found[0].detail == "_acc"


# ------------------------------------------------- MDT002 condition wakeups

_COND_CLASS = """
import threading

class Q:
    def __init__(self):
        self._cond = threading.Condition()
        self._items = []

    def put(self, x):
        with self._cond:
            self._items.append(x)
            self._cond.{wake}()

    def get(self):
        with self._cond:
            while not self._items:
                self._cond.wait()
            return self._items.pop()

    def drain(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._items)
"""
_DRAIN = ("    def drain(self):\n"
          "        with self._cond:\n"
          "            self._cond.wait_for(lambda: not self._items)\n")


def test_mdt002_positive_notify_two_waiters():
    found = [f for f in _check(_COND_CLASS.format(wake="notify"))
             if f.rule == "MDT002"]
    assert len(found) == 1
    assert found[0].symbol == "Q.put"


def test_mdt002_negatives_notify_all_and_single_waiter():
    assert "MDT002" not in _rules(_check(_COND_CLASS.format(
        wake="notify_all")))
    single = _COND_CLASS.format(wake="notify").replace(_DRAIN, "")
    assert "MDT002" not in _rules(_check(single))


# --------------------------------------------------- MDT003 fencing swallow

_SWALLOW = ("def loop():\n"
            "    try:\n"
            "        work()\n"
            "    except BaseException:\n"
            "        pass\n")
_RERAISE = ("def loop():\n"
            "    try:\n"
            "        work()\n"
            "    except BaseException:\n"
            "        cleanup()\n"
            "        raise\n")
_AWARE = ("def loop():\n"
          "    try:\n"
          "        work()\n"
          "    except BaseException as exc:\n"
          "        if isinstance(exc, WorkerFenced):\n"
          "            handle(exc)\n")
_PLAIN = ("def loop():\n"
          "    try:\n"
          "        work()\n"
          "    except Exception:\n"
          "        pass\n")


def test_mdt003_positive_bare_except_in_service_and_reliability():
    for rel in (f"{PKG}/service/mod.py", f"{PKG}/reliability/mod.py"):
        found = [f for f in _check(_SWALLOW, rel) if f.rule == "MDT003"]
        assert len(found) == 1 and found[0].symbol == "loop"


def test_mdt003_negatives_and_scope():
    for src in (_RERAISE, _AWARE, _PLAIN):
        assert "MDT003" not in _rules(_check(src))
    assert "MDT003" not in _rules(concurrency.check_module(
        ast.parse(_SWALLOW), f"{PKG}/analysis/mod.py"))


# ------------------------------------------------ MDT004 thread discipline

_THREAD_POS = "import threading\nt = threading.Thread(target=f)\n"
_THREAD_NEG = ("import threading\n"
               "t = threading.Thread(target=f, daemon=True)\n"
               "u = threading.Thread(target=f, daemon=False)\n")


def test_mdt004_positive_and_negative():
    assert "MDT004" in _rules(_check(_THREAD_POS))
    assert "MDT004" not in _rules(_check(_THREAD_NEG))


# ------------------------------------------- MDT005 non-atomic writes

_PERSIST = {
    "bare_open": ("def save(path, data):\n"
                  "    with open(path, 'w') as f:\n"
                  "        f.write(data)\n"),
    "bare_savez": ("import numpy as np\n"
                   "def save(path, arrays):\n"
                   "    np.savez(path, **arrays)\n"),
    "tmp_rename": ("import os\n"
                   "def save(path, data):\n"
                   "    tmp = path + '.tmp'\n"
                   "    with open(tmp, 'w') as f:\n"
                   "        f.write(data)\n"
                   "    os.replace(tmp, path)\n"),
    "rename_blesses": ("import os\n"
                       "def save(path, scratch, data):\n"
                       "    with open(scratch, 'w') as f:\n"
                       "        f.write(data)\n"
                       "    os.rename(scratch, path)\n"),
    "append_and_read": ("def log(path, line):\n"
                        "    with open(path, 'a') as f:\n"
                        "        f.write(line)\n"
                        "def load(path):\n"
                        "    with open(path) as f:\n"
                        "        return f.read()\n"),
    "exclusive": ("def save(path, data):\n"
                  "    with open(path, 'xb') as f:\n"
                  "        f.write(data)\n"),
    "keyword_target": ("def save(path, data):\n"
                       "    with open(file=path, mode='w') as f:\n"
                       "        f.write(data)\n"),
    "closure_rename": ("import os\n"
                       "def save(path, src_, dst, data):\n"
                       "    def later():\n"
                       "        os.replace(src_, dst)\n"
                       "    with open(path, 'w') as f:\n"
                       "        f.write(data)\n"
                       "    return later\n"),
    "nested_alone": ("import os\n"
                     "def outer(path, data):\n"
                     "    def cb(p):\n"
                     "        with open(p, 'w') as f:\n"
                     "            f.write(data)\n"
                     "    os.replace(path + '.tmp', path)\n"
                     "    return cb\n"),
    "buffer_then_atomic": ("import io\n"
                           "import numpy as np\n"
                           "def save(path, arrays):\n"
                           "    buf = io.BytesIO()\n"
                           "    np.savez(buf, **arrays)\n"
                           "    atomic_write_bytes(path, buf.getvalue())\n"),
}


@pytest.mark.parametrize("case,symbol", [
    ("bare_open", "save"), ("bare_savez", "save"), ("exclusive", "save"),
    ("keyword_target", "save"), ("closure_rename", "save"),
    ("nested_alone", "outer.cb"), ("buffer_then_atomic", "save")])
def test_mdt005_positives(case, symbol):
    found = [f for f in _check_persist(_PERSIST[case]) if f.rule == "MDT005"]
    assert len(found) == 1
    assert found[0].symbol == symbol


@pytest.mark.parametrize("case", ["tmp_rename", "rename_blesses",
                                  "append_and_read"])
def test_mdt005_negatives(case):
    assert "MDT005" not in _rules(_check_persist(_PERSIST[case]))


def test_mdt005_scoped_to_the_ports_persistence_modules():
    src = _PERSIST["bare_open"]
    for rel in (f"{PKG}/obs/m.py", f"{PKG}/utils/checkpoint.py",
                f"{PKG}/utils/integrity.py"):
        assert "MDT005" in _rules(_check_persist(src, rel))
    for rel in (f"{PKG}/analysis/rms.py", "mdanalysis_mpi_tpu/service/m.py"):
        assert "MDT005" not in _rules(_check_persist(src, rel))


def test_fleet_output_write_is_atomic_and_pragma_marked():
    """The one MDT005 site of the port writes into a BytesIO; the file
    goes through integrity.atomic_write_bytes, and the line's pragma
    says so."""
    path = os.path.join(REPO, PKG, "service", "fleet.py")
    with open(path) as f:
        src = f.read()
    lines = src.splitlines()
    found = [f for f in _check_persist(src, f"{PKG}/service/fleet.py")]
    assert [(f.symbol, f.detail) for f in found] == [
        ("_write_output", "savez#0")]
    assert pragma_suppressed(lines, found[0])
    body = ast.get_source_segment(src, next(
        n for n in ast.parse(src).body
        if isinstance(n, ast.FunctionDef) and n.name == "_write_output"))
    assert "atomic_write_bytes(" in body


# ------------------------------------ MDT101/102 host effects in captures

_CAPTURED = """
import time as _time
import numpy as np
import torch

def _kernel(params, batch, boxes, mask):
{kbody}
    return out

def untraced(x):
    return np.asarray(x.cpu())       # host helper: never captured

class Thing:
{flag}
    def _batch_fn(self):
        return _kernel
"""


@pytest.mark.parametrize("body,detail", [
    ("    out = batch.sum().item()", ".item"),
    ("    out = batch.cpu()", ".cpu"),
    ("    out = batch.tolist()", ".tolist"),
    ("    out = batch.numpy()", ".numpy"),
    ("    torch.cuda.synchronize()\n    out = batch", "torch.cuda.synchronize"),
    ("    out = np.asarray(batch)", "np.asarray"),
    ("    out = batch * _time.perf_counter()", "_time.perf_counter"),
    ("    print(batch)\n    out = batch", "print")])
def test_mdt101_positive_in_a_batch_function(body, detail):
    src = _CAPTURED.format(kbody=body, flag="    pass")
    found = [f for f in _check(src) if f.rule == "MDT101"]
    assert [(f.detail, f.symbol) for f in found] == [(detail, "_kernel")]


def test_mdt101_declared_host_waits_are_not_flagged():
    """A class declaring ``_host_waits_in_batch = True`` is never
    captured (its groups run eagerly): its waits are declared."""
    src = _CAPTURED.format(kbody="    out = batch.sum().item()",
                           flag="    _host_waits_in_batch = True")
    assert "MDT101" not in _rules(_check(src))


def test_mdt101_negative_pure_torch():
    src = _CAPTURED.format(kbody="    out = torch.sum(batch * mask)",
                           flag="    pass")
    assert "MDT101" not in _rules(_check(src))


def test_mdt101_follows_factories_and_the_call_graph():
    src = """
import numpy as np

def helper(x):
    return np.log(x)              # reached via the factory's kernel

def _make(tile):
    def kernel(params, batch, boxes, mask):
        return helper(batch)
    return kernel

class Thing:
    def _batch_fn(self):
        return _make(1024)
"""
    found = [f for f in _check(src) if f.rule == "MDT101"]
    assert [f.symbol for f in found] == ["helper"]


def test_mdt101_fold_combine_vmap_and_group_body_roots():
    src = """
import torch

def _fold(a, b):
    return a + b.tolist()[0]

def _combine(parts, comm=None):
    print(parts)
    return parts[0]

def _mi(d, box):
    return d - box * (d / box).round().item()

class Thing:
    _device_fold_fn = staticmethod(_fold)
    _device_combine = staticmethod(_combine)

def batch(x, boxes):
    return torch.vmap(_mi)(x, boxes)

def dispatch(cache, key, entry, tag, params, device):
    def body(p, tot):
        return p.cpu()
    return _run_group(cache, key, entry, tag, body, params, None, device)
"""
    found = {(f.symbol, f.detail) for f in _check(src) if f.rule == "MDT101"}
    assert found == {("_fold", ".tolist"), ("_combine", "print"),
                     ("_mi", ".item"), ("dispatch.body", ".cpu")}


def test_mdt102_global_in_captured():
    src = """
COUNT = 0

def _kernel(params, batch, boxes, mask):
    global COUNT
    COUNT += 1
    return batch

def host_counter():
    global COUNT
    COUNT += 1

class Thing:
    def _batch_fn(self):
        return _kernel
"""
    found = [f for f in _check(src) if f.rule == "MDT102"]
    assert [f.symbol for f in found] == ["_kernel"]


def test_the_ports_roots_are_found():
    """The AST tier reaches the port's real batch functions and the
    executors' group bodies (a walk that finds no root proves nothing)."""
    def roots(rel):
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        parents = {c: p for p in ast.walk(tree)
                   for c in ast.iter_child_nodes(p)}
        scopes, top = graphcontracts._index_scopes(tree)
        return {graphcontracts._qualname(r, parents) for r in
                graphcontracts.captured_roots(tree, parents, scopes, top)}

    assert {"_moments_kernel", "_aligned_moments_kernel",
            "_psum_moments_partials"} <= roots(f"{PKG}/analysis/rms.py")
    assert {"_rdf_kernel.kernel"} <= roots(f"{PKG}/analysis/rdf.py")
    assert roots(f"{PKG}/parallel/executors.py") == {
        "TorchExecutor.execute.scan.body", "MeshExecutor._scan.scan.body"}
    # GNM declares its host waits: its batch function is no root
    assert roots(f"{PKG}/analysis/gnm.py") == set()


def test_a_sync_seeded_into_the_rmsf_kernel_fires():
    path = os.path.join(REPO, PKG, "analysis", "rms.py")
    src = open(path).read()
    tree = ast.parse(src)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_moments_kernel")
    lines = src.splitlines()
    # an (unused) host read as the kernel's first statement
    first = fn.body[0]
    if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
        first = fn.body[1]
    indent = " " * first.col_offset
    lines.insert(first.lineno - 1, f"{indent}_n = mask.sum().item()")
    found = [f for f in graphcontracts.check_module(
        ast.parse("\n".join(lines)), f"{PKG}/analysis/rms.py")
        if f.rule == "MDT101"]
    assert [(f.symbol, f.detail) for f in found] == [
        ("_moments_kernel", ".item")]


# -------------------------------------------- MDT110/111 capture contracts

class _Counts:
    """A probe's counters, set by hand."""

    def __init__(self, bodies, combines, collectives=None, in_body=None):
        self.bodies, self.combines = bodies, combines
        self.collectives = collectives or {}
        self.in_body = in_body or {}


def test_mdt110_combine_count_predicate():
    ok = graphcontracts.combine_findings("p", _Counts(8, 4), 2, False)
    per_block = graphcontracts.combine_findings("p", _Counts(8, 8), 2, False)
    assert ok == []
    assert [f.detail for f in per_block] == ["combines"]
    single = graphcontracts.combine_findings(
        "p", _Counts(4, 0, {"torch.distributed.all_reduce": 1}), 1, True)
    assert [f.detail for f in single] == [
        "single:torch.distributed.all_reduce"]


def test_mdt110_collective_inside_a_group_body_fires(tmp_path):
    """A cached group's body that calls a counted ``Collectives``
    method (over a one-rank gloo group) is an MDT110 finding."""
    import torch.distributed as dist

    from mdanalysis_mpi_tpu_torch.parallel import executors
    from mdanalysis_mpi_tpu_torch.parallel.distributed import Collectives

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        comm = Collectives()

        def body(p, _tot):
            return comm.all_reduce(p[0] * 2)

        params = (torch.ones(4),)
        with graphcontracts.GroupProbe() as probe:
            out = executors._run_group(None, "k", None, "t", body, params,
                                       None, torch.device("cpu"))
            comm.all_reduce(out)            # outside the body
    finally:
        dist.destroy_process_group()
    assert torch.equal(out, torch.full((4,), 2.0))
    assert probe.bodies == 1
    assert probe.in_body == {"Collectives.all_reduce": 1,
                             "torch.distributed.all_reduce": 1}
    assert probe.collectives["Collectives.all_reduce"] == 2
    found = graphcontracts.combine_findings("p", probe, 1, True)
    assert {f.detail for f in found} == {
        "body:Collectives.all_reduce", "body:torch.distributed.all_reduce",
        "single:Collectives.all_reduce",
        "single:torch.distributed.all_reduce"}
    # the probe restored what it patched
    assert executors._run_group.__name__ == "_run_group"
    assert Collectives.all_reduce.__name__ == "all_reduce"


def test_group_probe_counts_and_restores_the_combine():
    """The probe counts ``_device_combine`` calls through the instance
    and leaves the analysis as it found it: the class's staticmethod,
    or an instance's own combine."""
    def merge(parts, comm=None):
        return sum(parts)

    class Ana:
        _device_combine = staticmethod(merge)

    plain, own = Ana(), Ana()
    own._device_combine = lambda parts, comm=None: -1
    mine = own._device_combine
    for a in (plain, own):
        with graphcontracts.GroupProbe(a) as probe:
            a._device_combine([1, 2])
            a._device_combine([3])
        assert probe.combines == 2
    assert "_device_combine" not in vars(plain)
    assert plain._device_combine is merge
    assert own._device_combine is mine


def test_mdt110_mesh_scan_program_clean_on_two_cpu_shards():
    progs = graphcontracts.registered_programs("cpu")
    make, exe, shards, single = progs["mesh_scan_rmsf"]
    findings, rep = graphcontracts.check_program(
        "mesh_scan_rmsf", make, exe, shards=shards, single_device=single)
    assert findings == []
    assert shards == 2 and not single
    for p in rep["passes"]:
        assert p["groups"] == 4 and p["combines"] == p["groups"]
        assert p["collectives"] == {}
    assert rep["replay_equal"] and rep["graphs"] == []


def test_mdt110_program_without_a_scan_is_refused():
    from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor

    progs = graphcontracts.registered_programs("cpu")
    make, exe, _, _ = progs["mesh_scan_rmsf"]
    flat = MeshExecutor(batch_size=4, devices=["cpu"] * 2,
                        block_cache=exe.block_cache, scan_k=1)
    with pytest.raises(RuntimeError, match="no scan program"):
        graphcontracts.check_program("flat", make, flat, shards=2,
                                     single_device=False)


def test_group_graphs_keep_their_graph_only_under_a_probe():
    """Production captures drop the ``cudaGraph_t`` once instantiated;
    a :class:`GroupProbe` keeps it for the block it patches."""
    from mdanalysis_mpi_tpu_torch.parallel.executors import _GroupGraph

    assert _GroupGraph.keep_graph is False
    with graphcontracts.GroupProbe():
        assert _GroupGraph.keep_graph is True
    assert _GroupGraph.keep_graph is False


def test_mdt111_predicates_on_node_lists():
    fused = "_Z19fused_planar_kernelIsEv4Args"
    nodes = ([("kernel", 0, fused)] * 4
             + [("kernel", 0, "_ZN2at6native29vectorized_elementwise")]
             + [("memcpy_dtod", 0, "4096 B"), ("memset", 0, "3276800 B"),
                ("memcpy_htod", 1024, "1024 B")])
    assert graphcontracts.host_constant_bytes(nodes) == 1024
    assert graphcontracts.hand_kernel_nodes(nodes) == {
        "planar_sums": 4, "pair_histogram": 0}
    assert graphcontracts.graph_findings(
        "p", 0, nodes, {"planar_sums": 4}) == []
    lost = graphcontracts.graph_findings("p", 0, nodes, {"planar_sums": 3})
    assert [f.detail for f in lost] == ["graph0:kernels"]
    baked = nodes + [("memcpy_htod", 2 << 20, "2097152 B")]
    found = graphcontracts.graph_findings("p", 1, baked,
                                          {"planar_sums": 4})
    assert [(f.rule, f.detail) for f in found] == [
        ("MDT111", "graph1:host_bytes")]
    at_budget = [("memcpy_htod", graphcontracts.CONST_BUDGET_BYTES, "")]
    assert graphcontracts.graph_findings("p", 0, at_budget, {}) == []
    ph = [("kernel", 0, "_Z16pair_hist_kernelPKfS0_")] * 2
    assert graphcontracts.graph_findings(
        "p", 0, ph, {"pair_histogram": 2}) == []


def test_capture_programs_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graphcontracts.check_captured_programs([], "cuda")


# ------------------------------------------------------ MDT20x schema drift

def _schema_tree(root, pkg, *, recorded="mdtpu_widgets_total",
                 pinned='{"mdtpu_widgets_total": "counter"}',
                 doc="`mdtpu_widgets_total` and the `stage` / `run` "
                     "span with `lease_reaped` instants",
                 span="stage", bench_keys=("metric",),
                 bench_src='rec = {"metric": 1}\n', alerts=None,
                 pinned_alerts=None):
    """A synthetic repo at ``root`` with package ``pkg``: one recording
    site, one span, the contract test's pins, the docs, and the bench
    script as both packages' MDT205 find it (``bench.py`` for the JAX
    package, :data:`schema.BENCH_SCRIPT` for the port)."""
    p = root / pkg
    (p / "obs").mkdir(parents=True)
    (p / "__init__.py").write_text("")
    (p / "obs" / "__init__.py").write_text("")
    (p / "obs" / "metrics.py").write_text("COMPILE_METRICS = ()\n")
    if alerts is not None:
        (p / "obs" / "alerts.py").write_text(
            "SEED_RULES = [" + ", ".join(
                f'{{"name": {n!r}}}' for n in alerts) + "]\n")
    (p / "rec.py").write_text(
        f'from x import METRICS, phase\n'
        f'METRICS.inc("{recorded}")\n'
        f'with phase("{span}"):\n    pass\n')
    (root / "tests").mkdir(exist_ok=True)
    pins = "" if pinned_alerts is None else (
        f"PINNED_ALERT_RULES = {tuple(pinned_alerts)!r}\n")
    (root / "tests" / "test_bench_contract.py").write_text(
        f"PINNED_METRICS = {pinned}\n{pins}"
        f"def test_keys():\n"
        f"    rec = {{}}\n"
        f"    for key in ({', '.join(repr(k) for k in bench_keys)},):\n"
        f"        assert key in rec\n")
    (root / "docs").mkdir(exist_ok=True)
    (root / "docs" / "OBSERVABILITY.md").write_text(doc + "\n")
    for script in ("bench.py", schema.BENCH_SCRIPT):
        (root / script).write_text(bench_src)


_SCHEMA_CASES = {
    "aligned": {},
    "mdt201": {"pinned": "{}"},
    "mdt202": {"pinned": '{"mdtpu_widgets_total": "counter", '
                         '"mdtpu_ghost_total": "counter"}'},
    "mdt203": {"doc": "`stage` spans only, with `lease_reaped`"},
    "mdt203_families": {
        "recorded": "mdtpu_jobs_done_total",
        "pinned": '{"mdtpu_jobs_done_total": "counter"}',
        "doc": "`mdtpu_jobs_{done,failed}_total{backend}` plus spans "
               "`stage` `run` `lease_reaped`"},
    "mdt204": {"span": "mystery_phase"},
    "mdt205": {"bench_keys": ("metric", "vanished_field")},
    "mdt206": {"alerts": ["queue_stall", "queue_stall", "BadName",
                          "unpinned_rule"],
               "pinned_alerts": ["queue_stall", "BadName", "ghost_rule"]},
    "mdt206_clean": {"alerts": ["queue_stall"],
                     "pinned_alerts": ["queue_stall"]},
}

_SCHEMA_EXPECT = {
    "aligned": set(), "mdt201": {("MDT201", "mdtpu_widgets_total")},
    "mdt202": {("MDT202", "mdtpu_ghost_total")},
    "mdt203": {("MDT203", "mdtpu_widgets_total")},
    "mdt203_families": set(),
    "mdt204": {("MDT204", "mystery_phase")},
    "mdt205": {("MDT205", "vanished_field")},
    "mdt206": {("MDT206", "dup:queue_stall"), ("MDT206", "case:BadName"),
               ("MDT206", "unpinned_rule"), ("MDT206", "ghost_rule")},
    "mdt206_clean": set(),
}


@pytest.mark.parametrize("case", sorted(_SCHEMA_CASES))
def test_schema_rules_on_synthetic_trees(tmp_path, case):
    _schema_tree(tmp_path, PKG, **_SCHEMA_CASES[case])
    findings = schema.check_repo(str(tmp_path), [])
    assert {(f.rule, f.detail) for f in findings} == _SCHEMA_EXPECT[case]


def test_mdt205_reads_the_ports_bench_script_only(tmp_path):
    """The port's MDT205 checks its own bench script and stays inert
    without one: the root ``bench.py`` is the JAX package's, which the
    JAX package's lint checks."""
    _schema_tree(tmp_path, PKG, bench_keys=("metric", "vanished_field"))
    assert {(f.rule, f.detail) for f in schema.check_repo(
        str(tmp_path), [])} == {("MDT205", "vanished_field")}
    (tmp_path / schema.BENCH_SCRIPT).unlink()
    notes = []
    assert schema.check_repo(str(tmp_path), notes) == []
    assert f"MDT205 skipped: {schema.BENCH_SCRIPT} not found" in notes
    # the repo holds the JAX package's bench.py and no port script yet
    assert os.path.exists(os.path.join(REPO, "bench.py"))
    notes = []
    assert "MDT205" not in _rules(schema.check_repo(REPO, notes))
    assert f"MDT205 skipped: {schema.BENCH_SCRIPT} not found" in notes


# ------------------------------------------------------------ parity (JAX)

def _normal(findings):
    """Findings as comparable tuples, the package prefix of paths and
    messages made the JAX package's."""
    return sorted(
        (f.rule, f.path.replace(f"{PKG}/", "mdanalysis_mpi_tpu/"), f.line,
         f.symbol, f.detail, f.message.replace(PKG, "mdanalysis_mpi_tpu"))
        for f in findings)


def _fixture_sources():
    out = {f"mdt001_{k}": _LOCKED_CLASS.format(method=m, body=b)
           for k, (m, b) in _MDT001_CASES.items()}
    out["mdt002_notify"] = _COND_CLASS.format(wake="notify")
    out["mdt002_notify_all"] = _COND_CLASS.format(wake="notify_all")
    out["mdt002_single"] = _COND_CLASS.format(wake="notify").replace(
        _DRAIN, "")
    out.update({"mdt003_swallow": _SWALLOW, "mdt003_reraise": _RERAISE,
                "mdt003_aware": _AWARE, "mdt003_plain": _PLAIN,
                "mdt004_pos": _THREAD_POS, "mdt004_neg": _THREAD_NEG})
    out.update({f"mdt005_{k}": v for k, v in _PERSIST.items()})
    out["seeded_timers"] = _seeded_timers()[1]
    out["seeded_scheduler"] = _seeded_scheduler()[1]
    return out


_SUBDIRS = ("service/mod.py", "reliability/mod.py", "obs/mod.py",
            "utils/checkpoint.py", "analysis/mod.py")


@pytest.mark.parametrize("name", sorted(
    [f"mdt001_{k}" for k in _MDT001_CASES]
    + ["mdt002_notify", "mdt002_notify_all", "mdt002_single",
       "mdt003_swallow", "mdt003_reraise", "mdt003_aware", "mdt003_plain",
       "mdt004_pos", "mdt004_neg", "seeded_timers", "seeded_scheduler"]
    + [f"mdt005_{k}" for k in _PERSIST]))
def test_parity_mdt001_to_mdt005_on_fixtures(name):
    tree = ast.parse(_fixture_sources()[name])
    # the seeded real modules once, in their own directory
    subs = (("utils/timers.py",) if name == "seeded_timers"
            else ("service/scheduler.py",) if name == "seeded_scheduler"
            else _SUBDIRS)
    for sub in subs:
        port = (concurrency.check_module(tree, f"{PKG}/{sub}")
                + persistence.check_module(tree, f"{PKG}/{sub}"))
        ref = (jax_concurrency.check_module(
            tree, f"mdanalysis_mpi_tpu/{sub}")
            + jax_persistence.check_module(
                tree, f"mdanalysis_mpi_tpu/{sub}"))
        assert _normal(port) == _normal(ref), (name, sub)


def test_parity_mdt001_to_mdt005_on_the_ports_modules():
    """Both packages' passes over every module of the port's service/,
    reliability/, obs/ and utils/ give equal findings."""
    n = 0
    for sub in ("service", "reliability", "obs", "utils"):
        d = os.path.join(REPO, PKG, sub)
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, fn)).read())
            port = (concurrency.check_module(tree, f"{PKG}/{sub}/{fn}")
                    + persistence.check_module(tree, f"{PKG}/{sub}/{fn}"))
            ref = (jax_concurrency.check_module(
                tree, f"mdanalysis_mpi_tpu/{sub}/{fn}")
                + jax_persistence.check_module(
                    tree, f"mdanalysis_mpi_tpu/{sub}/{fn}"))
            assert _normal(port) == _normal(ref), fn
            n += 1
    assert n > 30


@pytest.mark.parametrize("case", sorted(_SCHEMA_CASES))
def test_parity_mdt201_to_mdt206_on_synthetic_trees(tmp_path, case):
    port_root, ref_root = tmp_path / "port", tmp_path / "ref"
    _schema_tree(port_root, PKG, **_SCHEMA_CASES[case])
    _schema_tree(ref_root, "mdanalysis_mpi_tpu", **_SCHEMA_CASES[case])
    port_notes, ref_notes = [], []
    # the same bench file for both: the JAX package's MDT205 reads
    # bench.py, the port's its own script
    port = schema.check_repo(str(port_root), port_notes,
                             bench_script="bench.py")
    ref = jax_schema.check_repo(str(ref_root), ref_notes)
    assert _normal(port) == _normal(ref)
    assert port_notes == ref_notes


def test_parity_rule_catalog():
    from mdanalysis_mpi_tpu.lint.core import rule_ids as jax_rule_ids

    assert rule_ids() == jax_rule_ids()
    assert len(rule_ids()) == 15
    ref = jax_core.all_rules()
    for rid, rule in all_rules().items():
        assert rule.summary and rule.history
        assert rule.needs_device == ref[rid].needs_jax
    assert {r.family for r in all_rules().values()} == {
        "concurrency", "persistence", "capture", "graph", "schema"}


# --------------------------------------------------------- seeded-bug corpus

def _seeded_timers():
    path = os.path.join(REPO, PKG, "utils", "timers.py")
    with open(path) as f:
        src = f.read()
    locked = ("            with self._lock:\n"
              "                self._acc[name] = "
              "self._acc.get(name, 0.0) + dt\n"
              "                self._calls[name] = "
              "self._calls.get(name, 0) + 1")
    racy = ("            self._acc[name] = "
            "self._acc.get(name, 0.0) + dt\n"
            "            self._calls[name] = "
            "self._calls.get(name, 0) + 1")
    assert locked in src, "seed site moved; update the fixture"
    return src, src.replace(locked, racy)


def _seeded_scheduler():
    path = os.path.join(REPO, PKG, "service", "scheduler.py")
    with open(path) as f:
        src = f.read()
    assert "self._cond.notify_all()" in src
    return src, src.replace("self._cond.notify_all()",
                            "self._cond.notify()", 1)


def test_seeded_phasetimers_race_trips_mdt001():
    """Stripping the port's ``PhaseTimers.phase`` lock must trip
    MDT001."""
    rel = f"{PKG}/utils/timers.py"
    clean, seeded = _seeded_timers()
    assert "MDT001" not in _rules(concurrency.check_module(
        ast.parse(clean), rel))
    found = [f for f in concurrency.check_module(ast.parse(seeded), rel)
             if f.rule == "MDT001"]
    assert {f.detail for f in found} == {"_acc", "_calls"}
    assert all(f.symbol == "PhaseTimers.phase" for f in found)


def test_seeded_notify_lost_wakeup_trips_mdt002():
    """Turning the port scheduler's ``notify_all()`` back into
    ``notify()`` must trip MDT002."""
    rel = f"{PKG}/service/scheduler.py"
    clean, seeded = _seeded_scheduler()
    assert "MDT002" not in _rules(concurrency.check_module(
        ast.parse(clean), rel))
    found = [f for f in concurrency.check_module(ast.parse(seeded), rel)
             if f.rule == "MDT002"]
    assert found and all(f.detail == "_cond" for f in found)


# ----------------------------------------------- suppression: pragma+baseline

def test_pragma_suppresses_line():
    f = Finding("MDT004", "m.py", 2, "mod", "msg", "Thread")
    lines = ["import threading",
             "t = threading.Thread(target=f)  # mdtpu-lint: "
             "disable=MDT004"]
    assert pragma_suppressed(lines, f)
    assert not pragma_suppressed(
        ["import threading", "t = threading.Thread(target=f)"], f)


def test_baseline_requires_justification(tmp_path):
    f = Finding("MDT205", "tests/test_bench_contract.py", 0,
                "test_bench_json_contract", "msg", "some_key")
    assert not Baseline.from_findings([f]).match(f)
    justified = Baseline.from_findings([f], justification="dynamic key")
    assert justified.match(f)
    path = str(tmp_path / "base.json")
    justified.save(path)
    assert Baseline.load(path).match(f)


# ------------------------------------------------------- tree-wide self-check

def test_tree_lints_clean():
    """The port itself: zero unbaselined findings from the fast passes,
    with its own baseline of one justified entry and the fleet output
    write's one pragma."""
    report = run_lint(root=REPO, baseline=BASELINE)
    assert report.clean, "\n".join(f.render() for f in report.findings)
    n_py = sum(fn.endswith(".py") for _, _, fns in os.walk(
        os.path.join(REPO, PKG)) for fn in fns)
    assert report.files == n_py > 150
    assert sorted((f.rule, f.detail) for f in report.baselined) == [
        ("MDT204", "admission_mem_wait")]
    assert report.suppressed == 1
    with open(BASELINE) as fh:
        entries = json.load(fh)["findings"]
    assert len(entries) == 1
    assert all(len(e["justification"]) > 80 for e in entries)


# ----------------------------------------------------------------- the CLI

def test_cli_fast_mode_imports_neither_torch_nor_jax():
    """``python -m mdanalysis_mpi_tpu_torch lint --json``: exit 0 on the
    repo, and the fast mode imports neither torch nor jax."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", PKG, "lint", "--json", "--root", REPO],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["clean"] is True
    assert doc["torch_imported"] is False
    assert doc["jax_imported"] is False
    assert doc["n_baselined"] == 1
    assert doc["baseline"] == BASELINE
    assert sorted(doc["rules"]) == list(rule_ids())


def test_cli_refuses_jaxpr_and_unknown_ids(capsys):
    from mdanalysis_mpi_tpu_torch.lint.cli import lint_main

    assert lint_main(["--jaxpr", "--root", REPO]) == 2
    assert "--graphs" in capsys.readouterr().err
    assert lint_main(["--rules", "MDT01,MDT004", "--root", REPO]) == 2
    assert "MDT01" in capsys.readouterr().err


def test_cli_graphs_without_a_gpu_exits_2(monkeypatch, capsys):
    from mdanalysis_mpi_tpu_torch.lint.cli import lint_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lint_main(["--graphs", "--root", REPO]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_cli_baseline_write_is_idempotent(tmp_path):
    """Re-running --baseline-write (TODO entries don't suppress, so
    the findings come back) must not append duplicate entries."""
    from mdanalysis_mpi_tpu_torch.lint.cli import lint_main

    _schema_tree(tmp_path, PKG, bench_keys=("metric", "gone_a", "gone_b"))
    base = str(tmp_path / "base.json")
    for _ in range(2):
        assert lint_main(["--rules", "MDT205", "--root", str(tmp_path),
                          "--baseline", base, "--baseline-write"]) == 0
    with open(base) as f:
        entries = json.load(f)["findings"]
    assert sorted(e["detail"] for e in entries) == ["gone_a", "gone_b"]
    # TODO entries do not suppress: the tree still fails
    assert lint_main(["--root", str(tmp_path), "--baseline", base]) == 1


def test_cli_graphs_on_the_cpu(tmp_path, capsys):
    """``--graphs --device cpu``: the three registered programs run,
    MDT110 is checked on eager group bodies and the notes say MDT111
    needs a captured graph."""
    from mdanalysis_mpi_tpu_torch.lint.cli import lint_main

    _schema_tree(tmp_path, PKG)
    assert lint_main(["--graphs", "--device", "cpu", "--json", "--root",
                      str(tmp_path)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["clean"] and doc["torch_imported"] is True
    names = [p["name"] for p in doc["programs"]]
    assert names == ["mesh_scan_rmsf", "torch_group_aligned_rmsf_fused",
                     "torch_group_interrdf_kernel"]
    for p in doc["programs"]:
        assert p["replay_equal"] and p["graphs"] == []
        for leg in p["passes"]:
            assert leg["collectives"] == {}
            if p["name"] == "mesh_scan_rmsf":
                assert leg["combines"] == leg["groups"] == 4
    assert any("MDT111 not checked" in n for n in doc["notes"])


def test_cli_list_rules(capsys):
    from mdanalysis_mpi_tpu_torch.lint.cli import lint_main

    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rid in out for rid in rule_ids())
