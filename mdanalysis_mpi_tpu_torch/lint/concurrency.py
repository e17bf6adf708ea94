"""Concurrency-discipline rules (MDT0xx) — stdlib ``ast`` only.

These encode the repo's own locking conventions, each distilled from a
bug that actually shipped:

- **MDT001 unlocked-shared-state** — the ``PhaseTimers`` race and the
  ``DeviceBlockCache`` double-delete were both unguarded
  read-modify-writes of state that *other* methods mutate under
  ``self._lock``.  The rule self-registers: any attribute a class
  mutates inside a ``with self.<lock>`` block is "shared", and any
  mutation of a shared attribute outside such a block (outside
  ``__init__``) is flagged.  Helpers whose callers hold the lock
  follow the scheduler's existing ``*_locked`` naming convention and
  are exempt.
- **MDT002 notify-with-multiple-waiters** — the lost wakeup:
  ``Scheduler.submit`` used ``notify()`` on a condition that the
  supervisor and prefetch threads also wait on, so the single wakeup
  could land on a non-worker and the submission sat unclaimed forever.
  The rule flags ``.notify()`` on any condition with two or more
  distinct in-class wait sites.
- **MDT003 fencing-swallow** — worker fencing (``WorkerFenced``,
  ``InjectedWorkerDeath``) is BaseException-based precisely so
  ``except Exception`` passes it through; a bare ``except:`` or
  ``except BaseException:`` that neither re-raises nor explicitly
  discriminates the fencing types would swallow the control flow.
  Scoped to ``service/`` and ``reliability/``, where fencing lives.
- **MDT004 thread-daemon-discipline** — every ``threading.Thread``
  the package creates must say ``daemon=`` explicitly: a non-daemon
  thread that is never joined hangs interpreter exit, and an
  accidental default has to be a decision, not an omission.
"""

from __future__ import annotations

import ast

from mdanalysis_mpi_tpu_torch.lint.core import Finding, Rule, register

register(Rule(
    "MDT001", "unlocked-shared-state", "concurrency",
    "mutation of a lock-guarded attribute outside `with self.<lock>`",
    "PhaseTimers' unguarded dict RMW lost updates under the "
    "serving worker pool; DeviceBlockCache racing same-key puts "
    "double-deleted a device buffer"))
register(Rule(
    "MDT002", "notify-with-multiple-waiters", "concurrency",
    "notify() on a condition with >=2 distinct wait sites",
    "Scheduler.submit's notify() could wake the supervisor "
    "instead of a worker - the submission sat unclaimed forever "
    "(intermittent drain-timeout hangs)"))
register(Rule(
    "MDT003", "fencing-swallow", "concurrency",
    "bare except/except BaseException in service|reliability without "
    "re-raise or fencing-type discrimination",
    "WorkerFenced/InjectedWorkerDeath are BaseExceptions so `except "
    "Exception` passes them through; a blanket BaseException handler "
    "silently eats the fencing channel"))
register(Rule(
    "MDT004", "thread-daemon-discipline", "concurrency",
    "threading.Thread(...) without an explicit daemon= argument",
    "supervision threads must not block interpreter exit; "
    "daemon-ness is a per-thread decision the code must state"))

#: Constructors whose assignment to ``self.<attr>`` makes that
#: attribute a lock for MDT001/MDT002 purposes.
_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_COND_CTORS = {"Condition"}

#: Method calls that mutate their receiver (list/dict/set/deque API) —
#: counted as writes for MDT001 registration and flagging.
_MUTATORS = {
    "append", "appendleft", "add", "clear", "discard", "extend",
    "insert", "pop", "popleft", "popitem", "remove", "setdefault",
    "update",
}

#: Methods allowed to touch shared attributes unlocked: construction
#: (no concurrent observer exists yet) and the caller-holds-lock
#: naming convention the scheduler already uses (``*_locked``).
_EXEMPT_METHODS = {"__init__", "__new__"}

_FENCING_NAMES = {"WorkerFenced", "InjectedWorkerDeath"}


def _ctor_name(call: ast.AST) -> str | None:
    """'Lock' for ``threading.Lock()`` / ``Lock()`` / ``x.RLock()``."""
    if not isinstance(call, ast.Call):
        return None
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _self_attr(node: ast.AST) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _iter_methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class _MethodScan(ast.NodeVisitor):
    """One method's attribute-write events with lock context.

    Nested function/lambda bodies are skipped on both sides of the
    rule (registration and flagging): a closure created under the lock
    may legally run much later without it, and guessing would produce
    noise in either direction.
    """

    def __init__(self, lock_attrs: set[str]):
        self.lock_attrs = lock_attrs
        self.depth = 0
        # [(attr, locked, line, kind)]
        self.events: list[tuple] = []
        self.wait_sites: list[tuple] = []    # (cond_attr, line)
        self.notify_sites: list[tuple] = []  # (cond_attr, line, name)

    # -- lock context --

    def visit_With(self, node: ast.With) -> None:
        locked = any(_self_attr(item.context_expr) in self.lock_attrs
                     for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if locked:
            self.depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if locked:
            self.depth -= 1

    def _skip(self, node) -> None:      # nested defs: out of scope
        pass

    visit_FunctionDef = visit_AsyncFunctionDef = visit_Lambda = _skip

    # -- writes --

    def _note_target(self, target: ast.AST, line: int) -> None:
        attr = _self_attr(target)
        if attr is not None:
            self.events.append((attr, self.depth > 0, line, "assign"))
        elif isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
            if attr is not None:
                self.events.append((attr, self.depth > 0, line, "item"))
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._note_target(elt, line)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._note_target(t, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._note_target(node.target, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._note_target(node.target, node.lineno)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._note_target(t, node.lineno)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            recv_attr = _self_attr(fn.value)
            if recv_attr is not None and fn.attr in _MUTATORS:
                self.events.append((recv_attr, self.depth > 0,
                                    node.lineno, "mutcall"))
            if recv_attr is not None and fn.attr in ("wait", "wait_for"):
                self.wait_sites.append((recv_attr, node.lineno))
            if recv_attr is not None and fn.attr == "notify":
                self.notify_sites.append((recv_attr, node.lineno))
        self.generic_visit(node)


def _check_class(cls: ast.ClassDef, rel: str,
                 findings: list[Finding]) -> None:
    lock_attrs: set[str] = set()
    cond_attrs: set[str] = set()
    for method in _iter_methods(cls):
        for node in ast.walk(method):
            if isinstance(node, ast.Assign):
                name = _ctor_name(node.value)
                if name in _LOCK_CTORS:
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            lock_attrs.add(attr)
                            if name in _COND_CTORS:
                                cond_attrs.add(attr)

    if not lock_attrs:
        return

    scans: dict[str, _MethodScan] = {}
    for method in _iter_methods(cls):
        scan = _MethodScan(lock_attrs)
        for stmt in method.body:
            scan.visit(stmt)
        scans[method.name] = scan

    # MDT001: registration, then flag unlocked writes of shared attrs
    shared = {attr for scan in scans.values()
              for (attr, locked, _, _) in scan.events if locked}
    shared -= lock_attrs
    for mname, scan in scans.items():
        if mname in _EXEMPT_METHODS or mname.endswith("_locked"):
            continue
        seen: set[tuple] = set()
        for (attr, locked, line, kind) in scan.events:
            if locked or attr not in shared:
                continue
            key = (attr, line)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                "MDT001", rel, line, f"{cls.name}.{mname}",
                f"`self.{attr}` is mutated under a lock elsewhere in "
                f"{cls.name} but written here without `with "
                f"self.<lock>` (helpers relying on a caller-held lock "
                f"must end in `_locked`)",
                detail=attr))

    # MDT002: notify() while >=2 distinct in-class wait sites exist
    for cond in cond_attrs:
        waits = [(m, ln) for m, s in scans.items()
                 for (a, ln) in s.wait_sites if a == cond]
        if len(waits) < 2:
            continue
        for mname, scan in scans.items():
            for (a, ln) in scan.notify_sites:
                if a != cond:
                    continue
                findings.append(Finding(
                    "MDT002", rel, ln, f"{cls.name}.{mname}",
                    f"`self.{cond}.notify()` with {len(waits)} distinct "
                    f"wait sites in {cls.name} "
                    f"({', '.join(sorted({m for m, _ in waits}))}): a "
                    f"single wakeup can land on the wrong waiter — use "
                    f"notify_all()",
                    detail=cond))


def _catches_base_exception(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    types = (handler.type.elts
             if isinstance(handler.type, ast.Tuple)
             else [handler.type])
    for t in types:
        name = t.id if isinstance(t, ast.Name) else (
            t.attr if isinstance(t, ast.Attribute) else None)
        if name == "BaseException":
            return True
    return False


def _handler_is_fencing_aware(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Name) and node.id in _FENCING_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _FENCING_NAMES:
            return True
    return False


def _enclosing_symbol(tree: ast.Module, target: ast.AST) -> str:
    """Dotted class/function scope containing ``target`` (best effort)."""
    path: list[str] = []

    def walk(node, trail):
        for child in ast.iter_child_nodes(node):
            if child is target:
                path.extend(trail)
                return True
            name = getattr(child, "name", None) if isinstance(
                child, (ast.ClassDef, ast.FunctionDef,
                        ast.AsyncFunctionDef)) else None
            if walk(child, trail + ([name] if name else [])):
                return True
        return False

    walk(tree, [])
    return ".".join(path) or "<module>"


def check_module(tree: ast.Module, rel: str) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            _check_class(node, rel, findings)

    in_fencing_scope = ("/service/" in f"/{rel}"
                        or "/reliability/" in f"/{rel}")
    for node in ast.walk(tree):
        if (in_fencing_scope and isinstance(node, ast.ExceptHandler)
                and _catches_base_exception(node)
                and not _handler_is_fencing_aware(node)):
            findings.append(Finding(
                "MDT003", rel, node.lineno,
                _enclosing_symbol(tree, node),
                "handler catches BaseException (or everything) without "
                "re-raising or discriminating WorkerFenced/"
                "InjectedWorkerDeath — it would swallow worker fencing",
                detail=f"line-scope:{_enclosing_symbol(tree, node)}"))
        if isinstance(node, ast.Call):
            fn = node.func
            is_thread = ((isinstance(fn, ast.Name) and fn.id == "Thread")
                         or (isinstance(fn, ast.Attribute)
                             and fn.attr == "Thread"))
            if is_thread and not any(kw.arg == "daemon"
                                     for kw in node.keywords):
                findings.append(Finding(
                    "MDT004", rel, node.lineno,
                    _enclosing_symbol(tree, node),
                    "threading.Thread(...) without an explicit daemon= "
                    "— state the join/daemon decision",
                    detail="Thread"))
    return findings
