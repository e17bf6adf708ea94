"""Persistence-discipline rules (MDT00x, persistence family) —
stdlib ``ast`` only.

- **MDT005 non-atomic-artifact-write** — the integrity layer
  (docs/RELIABILITY.md §5) made tmp→fsync→rename the repo convention
  for every persisted artifact: a crash mid-write must leave the old
  file or the new one, never a torn hybrid.  The historical bug: the
  batch CLI's per-job ``.npz`` outputs were written with a bare
  ``np.savez(output, ...)`` — a ``kill -9`` (or ENOSPC) mid-write left
  a torn file that a ``--journal`` restart then *skipped over* as
  "done".  The rule flags direct write-mode ``open()`` and
  ``np.savez``/``savez_compressed`` calls in the persistence modules
  (``service/``, ``utils/checkpoint.py``, ``utils/integrity.py``,
  ``obs/``) whose enclosing function shows no tmp+rename shape.

What counts as atomic (the negatives):

- the target expression mentions a temp name (``path + ".tmp"``, a
  variable named ``tmp*``/``*_tmp``) — the write lands on a scratch
  inode, or
- the enclosing function also calls ``os.replace``/``os.rename`` —
  the rename completes the pattern, or
- the file is opened in APPEND mode (``"a"``) — append-only logs
  (the journal) are crash-consistent by construction: a torn tail is
  detected by the CRC frame, never a torn *file*.

Reads (``"r"``/``"rb"``) and non-persistence modules are out of scope.
"""

from __future__ import annotations

import ast

from mdanalysis_mpi_tpu_torch.lint.core import Finding, Rule, register

register(Rule(
    "MDT005", "non-atomic-artifact-write", "persistence",
    "open-for-write / np.savez without tmp+rename in a persistence "
    "module",
    "the batch CLI's per-job .npz was a bare np.savez: kill -9 or "
    "ENOSPC mid-write left a torn artifact a --journal restart then "
    "trusted as done (fixed by utils/integrity.py write_npz_atomic)"))

#: Repo-relative path prefixes/files where persisted artifacts are
#: written — the rule's scope (docs/LINT.md).
_SCOPE_PREFIXES = (
    "mdanalysis_mpi_tpu_torch/service/",
    "mdanalysis_mpi_tpu_torch/obs/",
)
_SCOPE_FILES = (
    "mdanalysis_mpi_tpu_torch/utils/checkpoint.py",
    "mdanalysis_mpi_tpu_torch/utils/integrity.py",
)

_SAVEZ_NAMES = {"savez", "savez_compressed"}
_RENAME_NAMES = {"replace", "rename"}


def _in_scope(rel: str) -> bool:
    rel = rel.replace("\\", "/")
    return (rel in _SCOPE_FILES
            or any(rel.startswith(p) for p in _SCOPE_PREFIXES))


def _call_name(node: ast.Call) -> str | None:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _open_mode(node: ast.Call) -> str | None:
    """The literal mode of an ``open()`` call ("r" when omitted);
    None when the mode is not a literal (out of static reach)."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    else:
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
    if mode is None:
        return "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


def _open_target(node: ast.Call):
    """The path expression of an ``open()`` call: first positional
    arg, or the ``file=`` keyword (PEP 8 discourages it, but the rule
    must not be dodged by spelling)."""
    if node.args:
        return node.args[0]
    for kw in node.keywords:
        if kw.arg == "file":
            return kw.value
    return None


def _mentions_tmp(node: ast.AST) -> bool:
    """Does the target-path expression visibly route through a temp
    name?  (``path + ".tmp"``, ``tmp``, ``tmp_path``, ``f"{p}.tmp"``…)"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and "tmp" in sub.value.lower():
            return True
        if isinstance(sub, ast.Name) and "tmp" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "tmp" in sub.attr.lower():
            return True
    return False


def _has_rename(scope: ast.AST) -> bool:
    """Does THIS scope call os.replace/os.rename — not counting
    nested function bodies: a rename inside a deferred closure does
    not make the enclosing scope's in-place write atomic (the same
    judged-alone rule _write_calls applies)."""
    found = False

    def walk(node):
        nonlocal found
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Call) \
                    and _call_name(child) in _RENAME_NAMES:
                found = True
                return
            walk(child)
            if found:
                return

    walk(scope)
    return found


def _write_calls(scope: ast.AST):
    """(call, kind, target_expr) for every direct artifact write in
    ``scope``, NOT descending into nested function definitions (each
    function is judged on its own tmp+rename shape)."""
    out = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                name = _call_name(child)
                if name == "open":
                    mode = _open_mode(child)
                    target = _open_target(child)
                    # "x" (exclusive create) tears exactly like "w"
                    if mode is not None and target is not None \
                            and ("w" in mode or "x" in mode):
                        out.append((child, "open", target))
                elif name in _SAVEZ_NAMES and child.args:
                    out.append((child, name, child.args[0]))
            walk(child)

    walk(scope)
    return out


def _scopes(tree: ast.Module):
    """Every function/method body (plus the module top level), each
    judged independently: the tmp+rename pair must live in the SAME
    scope as the write it blesses."""
    yield "<module>", tree

    def rec(node, trail):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                name = ".".join(trail + [child.name])
                yield name, child
                yield from rec(child, trail + [child.name])
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, trail + [child.name])
            else:
                yield from rec(child, trail)

    yield from rec(tree, [])


def check_module(tree: ast.Module, rel: str) -> list[Finding]:
    if not _in_scope(rel):
        return []
    findings: list[Finding] = []
    for symbol, scope in _scopes(tree):
        has_rename = _has_rename(scope)
        for i, (call, kind, target) in enumerate(_write_calls(scope)):
            if _mentions_tmp(target):
                continue           # writing to a scratch inode
            if has_rename:
                continue           # tmp+rename completes in this scope
            what = ("open(..., 'w')" if kind == "open"
                    else f"np.{kind}(...)")
            findings.append(Finding(
                "MDT005", rel, call.lineno, symbol or "<module>",
                f"{what} writes a persistence artifact in place — a "
                f"crash or ENOSPC mid-write leaves a torn file; write "
                f"tmp→fsync→rename (utils/integrity.py atomic_write / "
                f"write_npz_atomic)",
                detail=f"{kind}#{i}"))
    return findings
