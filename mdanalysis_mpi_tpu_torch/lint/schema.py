"""Schema-drift rules (MDT2xx) — stdlib only.

The observability contract lives in four places that historically
drifted apart: the recording sites (``obs.METRICS.inc(...)`` and the
zero-injection tables in ``obs/metrics.py``), the pinned schema
(``PINNED_METRICS`` in ``tests/test_bench_contract.py``), the operator
catalog (``docs/OBSERVABILITY.md``), and the bench artifact keys the
driver scores.  This pass statically harvests all four and diffs them:

- **MDT201 metric-not-pinned** — a live-recorded or zero-injected
  series missing from ``PINNED_METRICS``: the schema test can't
  protect a name it doesn't know.
- **MDT202 pinned-metric-unregistered** — a pinned name no code
  records, injects or emits: the schema test is pinning vapor (a
  rename's orphaned half).
- **MDT203 metric-undocumented** — a live/injected series absent from
  the ``docs/OBSERVABILITY.md`` catalog (brace families like
  ``mdtpu_jobs_{submitted,completed}_total`` are expanded).
- **MDT204 span-undocumented** — a ``phase("...")``/``span("...")``/
  ``span_event("...")`` name the docs' span model never mentions
  (exactly how the supervision instants went missing).
- **MDT205 bench-key-drift** — an artifact key the bench contract
  test requires that the port's bench script (:data:`BENCH_SCRIPT`)
  never mentions: the pin outlived the field.  Inert until that script
  exists: the root ``bench.py`` is the JAX package's, and its own lint
  checks it.
- **MDT206 alert-rule-drift** — the ``obs/alerts.py`` seed-rule
  catalog vs its pin (``PINNED_ALERT_RULES`` in the contract test):
  duplicate or non-snake_case rule names, rules missing from the
  pin, and pinned names no rule carries — rule drift caught exactly
  like metric drift.
"""

from __future__ import annotations

import ast
import itertools
import os
import re

from mdanalysis_mpi_tpu_torch.lint.core import Finding, Rule, register

register(Rule(
    "MDT201", "metric-not-pinned", "schema",
    "recorded/zero-injected metric missing from PINNED_METRICS",
    "the snapshot schema is pinned precisely because renames were "
    "silently shipping; an unpinned series is outside that fence"))
register(Rule(
    "MDT202", "pinned-metric-unregistered", "schema",
    "PINNED_METRICS name that no code records, injects or emits",
    "the orphaned half of a rename: the schema test keeps passing "
    "while the series it thinks it pins no longer exists"))
register(Rule(
    "MDT203", "metric-undocumented", "schema",
    "recorded/zero-injected metric absent from docs/OBSERVABILITY.md",
    "the docs table is the operator contract; compile-cache and "
    "supervision series drifted out of it"))
register(Rule(
    "MDT204", "span-undocumented", "schema",
    "span/phase/instant name absent from docs/OBSERVABILITY.md",
    "the supervision instants (lease_reaped, job_quarantined...) "
    "never reached the documented span model"))
register(Rule(
    "MDT205", "bench-key-drift", "schema",
    "bench-contract-pinned artifact key that the bench script never "
    "mentions",
    "the benchmark harness scores the bench script's JSON line; a "
    "pinned-but-unemitted key means the contract test and the "
    "artifact diverged"))
register(Rule(
    "MDT206", "alert-rule-drift", "schema",
    "alert seed-rule catalog drift: duplicate/non-snake_case names, "
    "or mismatch vs PINNED_ALERT_RULES",
    "the alert rules are an operator contract like the metric "
    "schema; an unpinned rename would silently retire a rule every "
    "runbook references"))

_METRIC_RE = re.compile(r"^mdtpu_\w+$")
#: Doc tokens: a metric name possibly with ``{a,b,c}`` families.
_DOC_METRIC_RE = re.compile(r"mdtpu_[a-z0-9_]*(?:\{[a-z0-9_,]+\}[a-z0-9_]*)*")

#: Zero-injection tables in obs/metrics.py whose members are part of
#: the process-invariant snapshot schema (with their types).
_TABLE_TYPES = {
    "COMPILE_METRICS": "counter",
    "BREAKER_COUNTERS": "counter",
    "BREAKER_GAUGES": "gauge",
    "SUPERVISION_COUNTERS": "counter",
    "RELIABILITY_COUNTERS": "counter",
    "LINT_GAUGES": "gauge",
    "INTEGRITY_COUNTERS": "counter",
    "INTEGRITY_GAUGES": "gauge",
    "SCRUB_COUNTERS": "counter",
    "STORE_COUNTERS": "counter",
    "STORE_REMOTE_COUNTERS": "counter",
    "STORE_CACHE_COUNTERS": "counter",
    "STORE_CACHE_GAUGES": "gauge",
    "FLEET_COUNTERS": "counter",
    "FLEET_GAUGES": "gauge",
    "FLEET_OBS_COUNTERS": "counter",
    "FLEET_OBS_GAUGES": "gauge",
    "QOS_COUNTERS": "counter",
    "QOS_GAUGES": "gauge",
    "PROF_COUNTERS": "counter",
    "PROF_GAUGES": "gauge",
    "PROF_HISTOGRAMS": "histogram",
    "ALERT_COUNTERS": "counter",
    "ALERT_GAUGES": "gauge",
    "ENSEMBLE_COUNTERS": "counter",
    "ENSEMBLE_GAUGES": "gauge",
    "STREAM_COUNTERS": "counter",
    "STREAM_GAUGES": "gauge",
    "USAGE_COUNTERS": "counter",
    "CANARY_COUNTERS": "counter",
    "CANARY_GAUGES": "gauge",
    "CANARY_HISTOGRAMS": "histogram",
}

_RECORD_TYPES = {"inc": "counter", "observe": "histogram",
                 "set_gauge": "gauge"}


def _literal_assignments(tree: ast.Module) -> dict:
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except (ValueError, TypeError, SyntaxError):
                pass
    return out


def harvest_recorded(pkg_root: str) -> dict[str, set]:
    """``name → {types}`` for every literal-named recording call
    (``X.inc("mdtpu_..")`` etc.) in the package."""
    from mdanalysis_mpi_tpu_torch.lint.core import iter_python_files, parse_file

    out: dict[str, set] = {}
    for path in iter_python_files(pkg_root):
        tree, _ = parse_file(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _RECORD_TYPES
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            if _METRIC_RE.match(name):
                out.setdefault(name, set()).add(
                    _RECORD_TYPES[node.func.attr])
    return out


def harvest_metrics_tables(metrics_py: str) -> tuple[dict, set]:
    """(zero-injected ``name → type``, all code-declared names) from
    ``obs/metrics.py``: the injection tables, the telemetry-derived
    families, and the adapter-emitted literal names."""
    from mdanalysis_mpi_tpu_torch.lint.core import parse_file

    tree, _ = parse_file(metrics_py)
    injected: dict[str, str] = {}
    declared: set[str] = set()
    if tree is None:
        return injected, declared
    consts = _literal_assignments(tree)
    for table, typ in _TABLE_TYPES.items():
        for name in consts.get(table, ()):
            injected[name] = typ
            declared.add(name)
    for key in consts.get("_TELEMETRY_COUNTERS", ()):
        declared.add(f"mdtpu_{key}_total")
    for key in consts.get("_TELEMETRY_GAUGES", ()):
        declared.add(f"mdtpu_{key}")
    # adapter-emitted literals (snap["mdtpu_phase_seconds_total"]=...)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _METRIC_RE.match(node.value)):
            declared.add(node.value)
    return injected, declared


def harvest_pinned(contract_py: str) -> dict[str, str]:
    from mdanalysis_mpi_tpu_torch.lint.core import parse_file

    tree, _ = parse_file(contract_py)
    if tree is None:
        return {}
    pinned = _literal_assignments(tree).get("PINNED_METRICS", {})
    return pinned if isinstance(pinned, dict) else {}


def expand_doc_token(token: str) -> list[str]:
    """``mdtpu_jobs_{submitted,completed}_total`` → both names.

    A brace group WITHOUT a comma is a label annotation
    (``mdtpu_runs_total{backend}``), not a family — dropped."""
    parts = re.split(r"(\{[a-z0-9_,]+\})", token)
    options = [
        (p[1:-1].split(",") if "," in p else [""])
        if p.startswith("{") else [p]
        for p in parts]
    return ["".join(combo) for combo in itertools.product(*options)]


def harvest_doc_metrics(doc_md: str) -> set[str]:
    with open(doc_md, encoding="utf-8") as f:
        text = f.read()
    out: set[str] = set()
    for token in _DOC_METRIC_RE.findall(text):
        out.update(expand_doc_token(token))
    return out


def harvest_span_names(pkg_root: str) -> dict[str, int]:
    """Literal names handed to ``phase(...)``, ``span(...)`` and
    ``span_event(...)`` across the package → first line seen."""
    from mdanalysis_mpi_tpu_torch.lint.core import iter_python_files, parse_file

    out: dict[str, tuple] = {}
    for path in iter_python_files(pkg_root):
        tree, _ = parse_file(path)
        if tree is None:
            continue
        rel = path
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute)
                    else None)
            if name in ("phase", "span", "span_event"):
                out.setdefault(node.args[0].value,
                               (rel, node.lineno))
    return out


def harvest_alert_rules(alerts_py: str) -> list[str]:
    """The ``SEED_RULES`` catalog's rule names, in declaration order
    (duplicates preserved — MDT206 flags them)."""
    from mdanalysis_mpi_tpu_torch.lint.core import parse_file

    tree, _ = parse_file(alerts_py)
    if tree is None:
        return []
    rules = _literal_assignments(tree).get("SEED_RULES", [])
    if not isinstance(rules, list):
        return []
    return [r.get("name") for r in rules
            if isinstance(r, dict) and isinstance(r.get("name"), str)]


def harvest_pinned_alert_rules(contract_py: str) -> list[str]:
    from mdanalysis_mpi_tpu_torch.lint.core import parse_file

    tree, _ = parse_file(contract_py)
    if tree is None:
        return []
    pinned = _literal_assignments(tree).get("PINNED_ALERT_RULES", ())
    if not isinstance(pinned, (list, tuple)):
        return []
    return [n for n in pinned if isinstance(n, str)]


def harvest_bench_pins(contract_py: str) -> list[str]:
    """Artifact keys the contract test iterates over (``for key in
    ("metric", ...): assert key in rec``)."""
    from mdanalysis_mpi_tpu_torch.lint.core import parse_file

    tree, _ = parse_file(contract_py)
    if tree is None:
        return []
    keys: list[str] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.For)
                and isinstance(node.target, ast.Name)
                and node.target.id == "key"
                and isinstance(node.iter, ast.Tuple)):
            for elt in node.iter.elts:
                if (isinstance(elt, ast.Constant)
                        and isinstance(elt.value, str)):
                    keys.append(elt.value)
    return keys


#: The port's bench script, at the repo root, that MDT205 checks.
BENCH_SCRIPT = "bench_torch.py"


def check_repo(root: str, notes: list[str],
               bench_script: str = BENCH_SCRIPT) -> list[Finding]:
    pkg = os.path.join(root, "mdanalysis_mpi_tpu_torch")
    metrics_py = os.path.join(pkg, "obs", "metrics.py")
    contract_py = os.path.join(root, "tests", "test_bench_contract.py")
    doc_md = os.path.join(root, "docs", "OBSERVABILITY.md")
    bench_py = os.path.join(root, bench_script)
    missing = [p for p in (metrics_py, contract_py, doc_md)
               if not os.path.exists(p)]
    if missing:
        notes.append("schema pass skipped: missing "
                     + ", ".join(os.path.relpath(p, root)
                                 for p in missing))
        return []

    findings: list[Finding] = []
    rel_metrics = "mdanalysis_mpi_tpu_torch/obs/metrics.py"
    rel_contract = "tests/test_bench_contract.py"

    recorded = harvest_recorded(pkg)
    injected, declared = harvest_metrics_tables(metrics_py)
    pinned = harvest_pinned(contract_py)
    documented = harvest_doc_metrics(doc_md)

    # the process-invariant schema: live-recorded + zero-injected
    invariant = dict(injected)
    for name, types in recorded.items():
        invariant.setdefault(name, sorted(types)[0])

    for name in sorted(invariant):
        if name not in pinned:
            findings.append(Finding(
                "MDT201", rel_contract, 0, "PINNED_METRICS",
                f"`{name}` is recorded/zero-injected by the package "
                f"but missing from PINNED_METRICS", detail=name))
        if name not in documented:
            findings.append(Finding(
                "MDT203", "docs/OBSERVABILITY.md", 0, "metrics-table",
                f"`{name}` is recorded/zero-injected but absent from "
                f"the docs metric catalog", detail=name))
    all_declared = set(declared) | set(recorded) | set(injected)
    for name in sorted(pinned):
        if name not in all_declared:
            findings.append(Finding(
                "MDT202", rel_metrics, 0, "PINNED_METRICS",
                f"pinned metric `{name}` is never recorded, injected "
                f"or emitted by package code", detail=name))

    with open(doc_md, encoding="utf-8") as f:
        doc_text = f.read()
    for name, (path, line) in sorted(harvest_span_names(pkg).items()):
        if not re.search(rf"\b{re.escape(name)}\b", doc_text):
            from mdanalysis_mpi_tpu_torch.lint.core import relpath

            findings.append(Finding(
                "MDT204", relpath(path, root), line, "span-model",
                f"span/phase name `{name}` is not in the "
                f"docs/OBSERVABILITY.md span model", detail=name))

    # MDT206: the alert seed-rule catalog vs its pin — rule drift is
    # caught like metric drift
    alerts_py = os.path.join(pkg, "obs", "alerts.py")
    rel_alerts = "mdanalysis_mpi_tpu_torch/obs/alerts.py"
    if os.path.exists(alerts_py):
        rule_names = harvest_alert_rules(alerts_py)
        pinned_rules = harvest_pinned_alert_rules(contract_py)
        seen: set[str] = set()
        snake = re.compile(r"^[a-z][a-z0-9_]*$")
        for name in rule_names:
            if name in seen:
                findings.append(Finding(
                    "MDT206", rel_alerts, 0, "SEED_RULES",
                    f"duplicate alert rule name `{name}`",
                    detail=f"dup:{name}"))
            seen.add(name)
            if not snake.match(name):
                findings.append(Finding(
                    "MDT206", rel_alerts, 0, "SEED_RULES",
                    f"alert rule name `{name}` is not snake_case",
                    detail=f"case:{name}"))
            if name not in pinned_rules:
                findings.append(Finding(
                    "MDT206", rel_contract, 0, "PINNED_ALERT_RULES",
                    f"seed alert rule `{name}` is missing from "
                    f"PINNED_ALERT_RULES", detail=name))
        for name in pinned_rules:
            if name not in seen:
                findings.append(Finding(
                    "MDT206", rel_alerts, 0, "SEED_RULES",
                    f"pinned alert rule `{name}` is not in the "
                    f"SEED_RULES catalog", detail=name))
    else:
        notes.append("MDT206 skipped: obs/alerts.py not found")

    if os.path.exists(bench_py):
        with open(bench_py, encoding="utf-8") as f:
            bench_src = f.read()
        for key in harvest_bench_pins(contract_py):
            if key not in bench_src:
                findings.append(Finding(
                    "MDT205", rel_contract, 0,
                    "test_bench_json_contract",
                    f"pinned artifact key `{key}` never appears in "
                    f"{bench_script}", detail=key))
    else:
        notes.append(f"MDT205 skipped: {bench_script} not found")
    return findings
