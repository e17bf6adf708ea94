"""Request coalescing: N pending jobs, one staged trajectory pass.

On the batch backends the wall clock is dominated by decode + staging
(PERF.md §1), so N tenants asking about the same (trajectory, frame
window) should cost ONE decode→stage→scan, not N.  The machinery
already exists —
:class:`~mdanalysis_mpi_tpu_torch.analysis.base.AnalysisCollection` stages
the union of its children's selections once and slices each child's
atoms back out on device — and this module is the routing layer that
builds collections out of a scheduler's pending queue:

1. Jobs are bucketed by :meth:`AnalysisJob.coalesce_key` (trajectory
   identity, frame window, backend, batch geometry, executor kwargs,
   reliability policy) — only identical keys may merge, so a merged
   pass is observationally identical to each member's solo run.
2. Within a bucket, members that cannot ride a collection run solo:
   ``coalesce=False`` opt-outs, ring (atom-sharded) kernels on batch
   backends, and mixed reduction/series members on batch backends
   (split into one collection per family instead — the executors fold
   or concatenate a run's partials uniformly).
3. Analyses whose algorithm lives in a ``run()`` override are routed
   BY EXCEPTION: :class:`~mdanalysis_mpi_tpu_torch.analysis.base.
   AnalysisCollection` raises the typed
   :class:`~mdanalysis_mpi_tpu_torch.analysis.base.UncoalescableAnalysisError`
   naming the offending member, and the planner moves that member to a
   solo pass and retries — the collection's constructor stays the ONE
   authority on coalesceability (no drifting duplicate predicate here).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ExecutionUnit:
    """One pass the scheduler will execute: the handles it serves and
    the runnable carrying their analyses (the single analysis for a
    solo pass, an ``AnalysisCollection`` for a merged one)."""

    handles: list
    runnable: object
    coalesced: bool = False
    #: why a solo unit did not merge (telemetry counter name), or None
    solo_reason: str | None = None


def _fold_family(analysis) -> bool:
    """True for reduction analyses (device fold), False for series —
    the two partial-accumulation families the batch executors keep
    uniform per run."""
    return analysis._device_fold_fn is not None


def _needs_solo_on_batch(analysis) -> bool:
    """Ring (atom-sharded / mesh-only) analyses cannot consume a
    collection's union block on the batch backends — the collection
    layer's own predicate, reused so the two sites cannot drift."""
    from mdanalysis_mpi_tpu_torch.analysis.base import needs_solo_on_batch

    return needs_solo_on_batch(analysis)


def _try_collection(handles):
    """Build a collection over ``handles``; route typed-refused members
    out (by exception) until the constructor accepts the remainder.
    Returns (collection_or_None, accepted_handles, refused_handles)."""
    from mdanalysis_mpi_tpu_torch.analysis.base import (
        AnalysisCollection, UncoalescableAnalysisError,
    )

    pool = list(handles)
    refused = []
    while pool:
        try:
            coll = AnalysisCollection(*[h.job.analysis for h in pool])
        except UncoalescableAnalysisError as exc:
            culprit = next(h for h in pool
                           if h.job.analysis is exc.analysis)
            pool.remove(culprit)
            refused.append(culprit)
            continue
        # a 1-member pool was probed (uncoalescable still routes to
        # `refused`) but runs bare — no collection wrapper overhead
        return (coll if len(pool) > 1 else None), pool, refused
    return None, [], refused


def plan_units(handles) -> list[ExecutionUnit]:
    """Plan one coalesce bucket (all handles share a coalesce key)
    into execution units, merged where the collection machinery
    allows."""
    from mdanalysis_mpi_tpu_torch.analysis.base import AnalysisCollection

    units: list[ExecutionUnit] = []
    pool = []
    for h in handles:
        job = h.job
        if (not job.coalesce
                # a user-built collection IS already a merged pass —
                # collections don't nest, so it runs as its own unit
                or isinstance(job.analysis, AnalysisCollection)):
            units.append(ExecutionUnit([h], job.analysis,
                                       solo_reason="solo_jobs"))
        elif (job.backend != "serial"
              and _needs_solo_on_batch(job.analysis)):
            units.append(ExecutionUnit([h], job.analysis,
                                       solo_reason="solo_jobs"))
        else:
            pool.append(h)

    # the serial backend runs any mix through the per-frame hooks; the
    # batch/MPI paths fold or concatenate partials uniformly, so split
    # per fold family there (two merged passes beat N solo ones)
    if pool and pool[0].job.backend != "serial":
        families = [[h for h in pool if _fold_family(h.job.analysis)],
                    [h for h in pool if not _fold_family(h.job.analysis)]]
    else:
        families = [pool]

    for family in families:
        if not family:
            continue
        coll, accepted, refused = _try_collection(family)
        for h in refused:
            units.append(ExecutionUnit([h], h.job.analysis,
                                       solo_reason="uncoalescable_jobs"))
        if coll is not None and len(accepted) > 1:
            units.append(ExecutionUnit(accepted, coll, coalesced=True))
        else:
            for h in accepted:
                units.append(ExecutionUnit([h], h.job.analysis,
                                           solo_reason="solo_jobs"))
    return units
