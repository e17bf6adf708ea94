"""``mdtpu lint`` — repo-native static analysis of the port
(docs/LINT.md; the JAX package's ``lint/`` rebuilt for PyTorch).

The rules encode the recurring bug classes hand-found in review:
unlocked shared-state read-modify-writes, condition-variable misuse,
swallowed ``BaseException`` control flow, non-atomic artifact writes,
schema drift, and the capture invariants of the cached scan groups
that only runtime tests used to pin:

- :mod:`~mdanalysis_mpi_tpu_torch.lint.concurrency` — MDT0xx: lock
  discipline, condition-variable wakeups, fencing-exception flow,
  thread daemon/join hygiene.  Pure stdlib :mod:`ast`.
- :mod:`~mdanalysis_mpi_tpu_torch.lint.persistence` — MDT005:
  non-atomic artifact writes in the persistence modules (the
  tmp→fsync→rename convention of docs/RELIABILITY.md §5).  Pure stdlib
  :mod:`ast`.
- :mod:`~mdanalysis_mpi_tpu_torch.lint.graphcontracts` — MDT1xx: host
  side effects and host syncs inside code a CUDA graph captures (AST
  call-graph walk), plus capture contracts checked on the device (one
  combine per scan group, captured host bytes, hand-kernel nodes equal
  to the recorded launches) that need torch.
- :mod:`~mdanalysis_mpi_tpu_torch.lint.schema` — MDT2xx: schema drift
  between the metric/span names the port records, the pinned schema in
  ``tests/test_bench_contract.py``, and the catalog in
  ``docs/OBSERVABILITY.md``.

Entry points: ``python -m mdanalysis_mpi_tpu_torch lint`` (CLI — rule
ids, JSON output, baseline suppression), :func:`run_lint` (library),
and the tree-wide self-check in ``tests/test_torch_lint.py``.  The AST
and schema passes import stdlib only, so the default (fast) mode runs
before any torch or jax import.
"""

from mdanalysis_mpi_tpu_torch.lint.core import (
    Baseline, Finding, LintReport, Rule, all_rules, iter_python_files,
    rule_ids, run_lint,
)

__all__ = [
    "Baseline", "Finding", "LintReport", "Rule", "all_rules",
    "iter_python_files", "rule_ids", "run_lint",
]
