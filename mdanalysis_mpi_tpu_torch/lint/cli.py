"""``python -m mdanalysis_mpi_tpu_torch lint`` — the checker's command
line.

Fast by default: only the stdlib-``ast`` passes run, importing neither
torch nor jax (the JSON output discloses ``torch_imported`` and
``jax_imported``, and tests pin both false).  ``--graphs`` adds the
capture-tier MDT11x contracts: the registered programs run on
``--device`` (``cuda`` by default; with no GPU the command exits 2 and
names ``--device cpu``, which runs the group bodies eagerly and checks
MDT110 alone).  ``--jaxpr`` is the JAX package's flag and is refused
with exit 2, naming ``--graphs``.

Exit codes: 0 clean (no unbaselined findings), 1 findings, 2 usage.

Baseline workflow (docs/LINT.md): ``--baseline-write`` records every
current finding with ``justification: "TODO: justify"``; entries only
suppress once a real justification replaces the TODO — the bootstrap
cannot be silently shipped.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mdanalysis_mpi_tpu_torch.lint.core import (
    Baseline, all_rules, find_repo_root, run_lint,
)

#: Default baseline file, repo-relative (the port's own; the root
#: ``.mdtpu_lint_baseline.json`` is the JAX package's).
BASELINE_NAME = "mdanalysis_mpi_tpu_torch/lint/baseline.json"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mdanalysis_mpi_tpu_torch lint",
        description="repo-native static analysis: concurrency "
                    "discipline, persistence atomicity, CUDA-graph "
                    "capture contracts, schema drift "
                    "(docs/LINT.md)")
    p.add_argument("--root", default=None,
                   help="repo root to lint (default: the installed "
                        "package's parent)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default all)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="one JSON document on stdout instead of text")
    p.add_argument("--graphs", action="store_true",
                   help="also run the registered executor programs, "
                        "capture their group graphs and check the MDT11x "
                        "capture contracts (imports torch)")
    p.add_argument("--device", default="cuda",
                   help="device of --graphs (default cuda; 'cpu' runs "
                        "the group bodies eagerly and checks MDT110 "
                        "alone)")
    p.add_argument("--jaxpr", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"baseline suppression file (default "
                        f"<root>/{BASELINE_NAME})")
    p.add_argument("--baseline-write", action="store_true",
                   help="bootstrap: write every current finding to "
                        "the baseline file with a TODO justification "
                        "and exit 0")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def lint_main(argv=None) -> int:
    ns = _parser().parse_args(argv)
    if ns.list_rules:
        for rule in sorted(all_rules().values(), key=lambda r: r.id):
            print(f"{rule.id}  {rule.name:32s} [{rule.family}] "
                  f"{rule.summary}")
        return 0
    root = find_repo_root(ns.root)
    baseline_path = ns.baseline or os.path.join(root, BASELINE_NAME)
    rules = (None if ns.rules is None
             else [r.strip() for r in ns.rules.split(",") if r.strip()])
    if rules is not None:
        # a typo'd id would filter every finding away and leave a CI
        # gate permanently green — unknown ids are a usage error
        known = set(all_rules()) | {"MDT000"}   # MDT000: unparseable
        unknown = sorted(set(rules) - known)
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2
    if ns.jaxpr:
        print("--jaxpr lowers JAX programs, which the port has none of; "
              "its capture contracts run with --graphs", file=sys.stderr)
        return 2
    if ns.graphs and ns.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            print(f"--graphs captures CUDA graphs on --device "
                  f"{ns.device}, and no GPU is present; pass --device cpu "
                  f"to run the group bodies eagerly and check MDT110 "
                  f"alone", file=sys.stderr)
            return 2
    report = run_lint(root=root, rules=rules, graphs=ns.graphs,
                      baseline=baseline_path, device=ns.device)

    if ns.baseline_write:
        merged = Baseline.load(baseline_path)
        # dedup by finding key: a re-run (TODO entries don't suppress,
        # so the findings come back) must not append duplicates that
        # each need hand-justifying later
        have = {(e.get("rule"), e.get("path"), e.get("symbol"),
                 e.get("detail", "")) for e in merged.entries}
        fresh = [f for f in report.findings if f.key() not in have]
        merged.entries += Baseline.from_findings(fresh).entries
        merged.save(baseline_path)
        print(f"wrote {len(fresh)} new finding(s) to {baseline_path} "
              f"({len(report.findings) - len(fresh)} already present); "
              f"add justifications to activate them", file=sys.stderr)
        return 0

    # surface the outcome in the unified metrics snapshot
    # (docs/OBSERVABILITY.md): obs imports stdlib only — still torch-
    # and jax-free
    from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS

    METRICS.set_gauge("mdtpu_lint_rules", len(report.rules))
    METRICS.set_gauge("mdtpu_lint_findings", len(report.findings))

    if ns.as_json:
        doc = report.to_json()
        doc["torch_imported"] = "torch" in sys.modules
        doc["jax_imported"] = "jax" in sys.modules
        doc["baseline"] = baseline_path
        print(json.dumps(doc))
    else:
        for f in report.findings:
            print(f.render())
        for note in report.notes:
            print(f"note: {note}", file=sys.stderr)
        print(f"{len(report.findings)} finding(s), "
              f"{len(report.baselined)} baselined, "
              f"{report.suppressed} pragma-suppressed, "
              f"{report.files} files, {len(report.rules)} rules",
              file=sys.stderr)
    return 0 if report.clean else 1
