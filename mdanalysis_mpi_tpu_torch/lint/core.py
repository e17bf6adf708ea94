"""Lint infrastructure: rules, findings, pragmas, baseline, report.

Everything here is stdlib-only (``ast``/``json``/``os``/``re``) so the
fast path — ``python -m mdanalysis_mpi_tpu_torch lint`` without
``--graphs`` — imports neither torch nor jax (pinned by
``tests/test_torch_lint.py``).

Suppression model (docs/LINT.md):

- **Pragma** — ``# mdtpu-lint: disable=MDT001[,MDT101]`` on the
  flagged line silences those rules for that line only; a finding is
  pointed at real code someone already reviewed.
- **Baseline** — a JSON file of accepted findings, each with a
  required ``justification`` string.  Matching is by the finding's
  stable key ``(rule, path, symbol, detail)`` — deliberately NOT line
  numbers, so unrelated edits above a baselined site don't resurrect
  it.  ``--baseline-write`` bootstraps the file; a justification of
  ``"TODO"`` still counts as unbaselined so the bootstrap cannot be
  silently shipped.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

#: Pragma grammar: ``# mdtpu-lint: disable=MDT001,MDT002`` (line) —
#: recognized anywhere in the physical line's trailing comment.
_PRAGMA_RE = re.compile(r"#\s*mdtpu-lint:\s*disable=([A-Z0-9,\s]+)")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One named check.  ``history`` records the shipped bug the rule
    encodes — the reason it exists (docs/LINT.md catalog)."""

    id: str
    name: str
    family: str            # "concurrency" | "persistence" | "capture"
    #                        # | "graph" | "schema"
    summary: str
    history: str
    needs_device: bool = False


@dataclasses.dataclass
class Finding:
    rule: str
    path: str              # repo-relative, "/" separators
    line: int
    symbol: str            # dotted scope, e.g. "PhaseTimers.phase"
    message: str
    detail: str = ""       # stable discriminator within the symbol

    def key(self) -> tuple:
        return (self.rule, self.path, self.symbol, self.detail)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.symbol}] "
                f"{self.message}")


_RULES: dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if rule.id in _RULES:
        raise ValueError(f"duplicate lint rule id {rule.id}")
    _RULES[rule.id] = rule
    return rule


def _load_passes() -> None:
    # import for side effect: each pass module registers its rules
    from mdanalysis_mpi_tpu_torch.lint import (  # noqa: F401
        concurrency, graphcontracts, persistence, schema,
    )


def all_rules() -> dict[str, Rule]:
    _load_passes()
    return dict(_RULES)


def rule_ids() -> tuple[str, ...]:
    return tuple(sorted(all_rules()))


def iter_python_files(root: str):
    """Yield the package's ``.py`` files under ``root`` (sorted,
    ``__pycache__`` excluded) — the AST passes' input set."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__"
                             and not d.startswith("."))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def parse_file(path: str):
    """``(tree, source_lines)`` for ``path``; ``(None, [])`` on a
    syntax error (reported by the caller as unparseable, not crashed
    over — the linter must survive a broken tree)."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        return ast.parse(src), src.splitlines()
    except SyntaxError:
        return None, src.splitlines()


def pragma_suppressed(lines: list[str], finding: Finding) -> bool:
    if not 1 <= finding.line <= len(lines):
        return False
    m = _PRAGMA_RE.search(lines[finding.line - 1])
    if not m:
        return False
    ids = {tok.strip() for tok in m.group(1).split(",")}
    return finding.rule in ids or "ALL" in ids


class Baseline:
    """Accepted-findings file: ``{"version": 1, "findings": [{rule,
    path, symbol, detail, justification}, ...]}``."""

    def __init__(self, entries: list[dict] | None = None):
        self.entries = entries or []

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return cls(doc.get("findings", []))

    def save(self, path: str) -> None:
        doc = {"version": 1, "findings": self.entries}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    def _keys(self) -> set:
        out = set()
        for e in self.entries:
            just = (e.get("justification") or "").strip()
            if not just or just.upper().startswith("TODO"):
                continue     # unjustified entries don't suppress
            out.add((e.get("rule"), e.get("path"), e.get("symbol"),
                     e.get("detail", "")))
        return out

    def match(self, finding: Finding) -> bool:
        return finding.key() in self._keys()

    @classmethod
    def from_findings(cls, findings: list[Finding],
                      justification: str = "TODO: justify") -> "Baseline":
        return cls([
            {"rule": f.rule, "path": f.path, "symbol": f.symbol,
             "detail": f.detail, "justification": justification,
             "message": f.message}
            for f in findings])


@dataclasses.dataclass
class LintReport:
    findings: list[Finding]            # unbaselined, unsuppressed
    baselined: list[Finding]
    suppressed: int                    # pragma-silenced count
    files: int
    rules: tuple[str, ...]
    notes: list[str]                   # skipped passes etc.
    programs: list[dict] = dataclasses.field(default_factory=list)
    #                                  # capture-tier reports (--graphs)

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "clean": self.clean,
            "files": self.files,
            "rules": list(self.rules),
            "n_findings": len(self.findings),
            "n_baselined": len(self.baselined),
            "n_suppressed": self.suppressed,
            "findings": [f.to_json() for f in self.findings],
            "baselined": [f.to_json() for f in self.baselined],
            "notes": self.notes,
            "programs": self.programs,
        }


def find_repo_root(start: str | None = None) -> str:
    """The directory holding the ``mdanalysis_mpi_tpu_torch`` package —
    where ``tests/``, ``docs/`` and the bench script live for the
    schema pass.  Defaults to the installed package's parent."""
    if start is not None:
        return os.path.abspath(start)
    import mdanalysis_mpi_tpu_torch

    return os.path.dirname(os.path.dirname(
        os.path.abspath(mdanalysis_mpi_tpu_torch.__file__)))


def relpath(path: str, root: str) -> str:
    return os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")


def run_lint(root: str | None = None, rules=None, graphs: bool = False,
             baseline: Baseline | str | None = None,
             device: str = "cuda") -> LintReport:
    """Run every selected pass over the repo at ``root``.

    ``rules``: iterable of rule ids to keep (default: all).  ``graphs``:
    also run the capture-tier MDT11x contracts on ``device`` (imports
    torch; ``"cpu"`` runs the group bodies eagerly and checks MDT110
    only).  ``baseline``: a :class:`Baseline` or a path to one.
    """
    from mdanalysis_mpi_tpu_torch.lint import (
        concurrency, graphcontracts, persistence, schema,
    )

    root = find_repo_root(root)
    pkg = os.path.join(root, "mdanalysis_mpi_tpu_torch")
    if not os.path.isdir(pkg):
        # linting some other tree (tests do this): treat root itself
        # as the package dir
        pkg = root
    selected = set(rules) if rules is not None else None
    if isinstance(baseline, str):
        baseline = Baseline.load(baseline)
    baseline = baseline or Baseline()

    notes: list[str] = []
    raw: list[Finding] = []
    suppressed = 0
    n_files = 0
    for path in iter_python_files(pkg):
        tree, lines = parse_file(path)
        n_files += 1
        rel = relpath(path, root)
        if tree is None:
            raw.append(Finding("MDT000", rel, 1, "<module>",
                               "file does not parse", "syntax"))
            continue
        file_findings = []
        file_findings += concurrency.check_module(tree, rel)
        file_findings += persistence.check_module(tree, rel)
        file_findings += graphcontracts.check_module(tree, rel)
        kept = []
        for f in file_findings:
            if pragma_suppressed(lines, f):
                suppressed += 1
            else:
                kept.append(f)
        raw += kept

    raw += schema.check_repo(root, notes)
    programs: list[dict] = []
    if graphs:
        found, programs = graphcontracts.check_captured_programs(notes,
                                                                 device)
        raw += found
    else:
        notes.append("capture contracts (MDT110/MDT111) skipped: fast "
                     "mode (pass --graphs)")

    if selected is not None:
        raw = [f for f in raw if f.rule in selected]
    findings, baselined = [], []
    for f in raw:
        (baselined if baseline.match(f) else findings).append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintReport(findings=findings, baselined=baselined,
                      suppressed=suppressed, files=n_files,
                      rules=rule_ids(), notes=notes, programs=programs)
