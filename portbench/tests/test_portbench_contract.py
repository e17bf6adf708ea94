"""BENCHMARK.json's names and units, and what the benchmark imports."""

import ast
import json
import os
import re

from portbench.tests._tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "mdanalysis_mpi_tpu"}
PROGRAM = "mdanalysis_mpi_tpu_torch"


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_only_the_allowed_characters():
    b = _bench()
    names = [c["name"] for c in b["configs"]]
    for w in b["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for m in b["end_to_end"] + b["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        names += c["reduced"]
    bad = [n for n in names if not NAME.match(n)]
    assert not bad, bad


def test_every_cell_and_metric_is_found_by_name():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic",
                                           f"{w['traffic']}.json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           f"{m['name']}.py")), m["name"]
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            moved = [e for e in b["end_to_end"] if e["name"] == m["moves"]][0]
            assert w in moved.get("workloads", [w])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(ROOT, "portbench", sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    found = {(p, m) for p in _sources() for m in _imports(p)
             if m in FORBIDDEN}
    assert not found, found


def test_the_reference_imports_nothing_of_the_program():
    found = {(p, m) for p in _sources("reference") for m in _imports(p)
             if m == PROGRAM or m in FORBIDDEN}
    assert not found, found


def _literals(path):
    """The string constants of a module that are not docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read())
    docs = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


def test_nothing_reads_the_old_benchmark_or_the_smoke_script():
    words = ("benchmarks", "bench.py", "BENCH_", "chip_smoke", "scripts")
    for p in _sources():
        if os.path.basename(p).startswith("test_"):
            continue
        assert not {m for m in _imports(p)} & {"chip_smoke", "scripts",
                                                "bench", "benchmarks"}, p
        for text in _literals(p):
            assert not any(w in text for w in words), (p, text)
