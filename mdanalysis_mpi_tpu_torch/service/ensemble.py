"""Ensemble jobs: ONE spec, N trajectories, fanned across the fleet.

The fleet shards one trajectory's frame window (``parallel.partition.
shard_windows``); this module owns the OTHER embarrassingly-parallel
axis — *across* trajectories (docs/ENSEMBLE.md): ensemble docking
runs, replica exchange, adaptive-sampling swarms.  The map-reduce
framing of "Pretty Fast Analysis" (PAPERS.md 0808.2992) and the
task-graph axis of 1801.07630, applied one level up.

Three pure pieces, importable without a fleet (the controller AND the
serial oracle in tests/bench share them, so parity is a statement
about the reductions, not about who called them):

- :func:`expand_ensemble` — validate an ``"ensemble"`` job-spec block
  (an int member count or a list of per-member override dicts) and
  expand it into N fully-merged member specs.  Members inherit the
  parent's QoS class unconditionally: the ensemble is ONE logical job
  and must not smuggle a higher class in through a member override.
- :func:`member_store` — the deterministic per-member store directory
  under an ingest pre-stage's ``out_root`` (idempotent re-runs land on
  the same path, so ``ingest``'s already-ingested check short-circuits
  them).
- :func:`merge_member_results` — the cross-trajectory reduction the
  controller applies where ``_merge_parent`` concatenates shards:
  ensemble-averaged RMSF via the weighted moment merge (the Welford
  carries every moments analysis ships — ``mean`` / ``m2`` /
  ``n_frames`` — are already merge-shaped: the pooled identity
  ``M2 = Σ M2ᵢ + Σ nᵢ(μᵢ − μ)²`` is exact, not approximate),
  frame-weighted ensemble RDF, a pairwise RMSD matrix over member mean
  structures (the distance matrix the existing encore / diffusionmap /
  PCA analyses eat), and a ``member<i>_<name>`` fan-out of every
  per-member series.
"""

from __future__ import annotations

import numpy as np


class EnsembleSpecError(ValueError):
    """Typed submit-time rejection of a malformed ``"ensemble"`` block
    (the fleet's submission contract: a bad spec fails the submit, not
    the audit three migrations later)."""


#: Result names that make a member's results moment-mergeable (the
#: Welford carries the moments analyses ship — analysis/rms.py RMSF /
#: AlignedRMSF).
MOMENT_KEYS = ("mean", "m2", "n_frames")

#: Result names that make a member's results RDF-mergeable
#: (analysis/rdf.py InterRDF).
RDF_KEYS = ("bins", "edges", "count", "rdf")


def expand_ensemble(spec: dict) -> list[dict]:
    """Expand one ensemble job spec into its member specs.

    ``spec["ensemble"]`` is either an int N (N members of the base
    spec — a replica/restart ensemble; fixture members get a distinct
    ``seed`` per member so they are distinct trajectories unless the
    base fixture pins one) or a list of per-member override dicts,
    shallow-merged over the base spec (``fixture`` merged dict-wise so
    a member can override just ``seed`` or just ``n_frames``).

    Mutually exclusive with ``shards``: a sharded ensemble would need
    two merge semantics on one parent.  Raises
    :class:`EnsembleSpecError` on any malformed block.
    """
    base = {k: v for k, v in spec.items()
            if k not in ("ensemble", "ingest")}
    ens = spec.get("ensemble")
    if spec.get("shards"):
        raise EnsembleSpecError(
            "ensemble and shards are mutually exclusive on one job "
            "(shard the members' windows in a follow-up pass instead)")
    if isinstance(ens, bool) or ens is None:
        raise EnsembleSpecError(
            f"ensemble must be an int member count or a list of "
            f"member override dicts, got {ens!r}")
    if isinstance(ens, int):
        if ens < 2:
            raise EnsembleSpecError(
                f"an ensemble needs >= 2 members, got {ens}")
        overrides: list[dict] = []
        for i in range(ens):
            ov: dict = {}
            if isinstance(base.get("fixture"), dict) \
                    and "seed" not in base["fixture"]:
                ov["fixture"] = {"seed": i}
            overrides.append(ov)
    elif isinstance(ens, (list, tuple)):
        if len(ens) < 2:
            raise EnsembleSpecError(
                f"an ensemble needs >= 2 members, got {len(ens)}")
        bad = [m for m in ens if not isinstance(m, dict)]
        if bad:
            raise EnsembleSpecError(
                f"ensemble members must be dicts (per-member spec "
                f"overrides), got {type(bad[0]).__name__}")
        overrides = [dict(m) for m in ens]
    else:
        raise EnsembleSpecError(
            f"ensemble must be an int member count or a list of "
            f"member override dicts, got {type(ens).__name__}")
    members = []
    for ov in overrides:
        sub = {k: v for k, v in base.items()}
        fix = ov.pop("fixture", None)
        sub.update(ov)
        if fix is not None:
            merged_fix = dict(base.get("fixture") or {})
            merged_fix.update(fix)
            sub["fixture"] = merged_fix
        # one logical job, one class: members inherit the parent's
        # QoS unconditionally (docs/ENSEMBLE.md "QoS accounting")
        if "qos" in base:
            sub["qos"] = base["qos"]
        else:
            sub.pop("qos", None)
        members.append(sub)
    return members


def member_store(out_root: str, index: int) -> str:
    """Deterministic per-member store directory under the ingest
    pre-stage's ``out_root`` — stable across re-runs, so a restarted
    ensemble's ingest children hit the already-ingested fast path
    instead of re-decoding.  Delegates to the store tier's canonical
    naming (:func:`~mdanalysis_mpi_tpu_torch.io.store.parallel.member_dir`)
    so the CLI driver and the fleet pre-stage cannot drift."""
    from mdanalysis_mpi_tpu_torch.io.store.parallel import member_dir

    return member_dir(out_root, index)


def merge_moments(members: list[dict]) -> dict:
    """Pooled Welford merge over member moment carries: exact, not
    approximate — ``n = Σnᵢ; μ = Σnᵢμᵢ/n; M2 = ΣM2ᵢ + Σnᵢ(μᵢ−μ)²``
    (ops/moments.py merge_moments, N-way).  Returns ``mean`` / ``m2``
    / ``n_frames`` / ``rmsf`` over the ensemble as if every member's
    frames had streamed through ONE Welford pass."""
    from mdanalysis_mpi_tpu_torch.ops.moments import rmsf_from_moments

    ns = np.asarray([float(m["n_frames"]) for m in members])
    means = np.stack([np.asarray(m["mean"], dtype=np.float64)
                      for m in members])
    m2s = np.stack([np.asarray(m["m2"], dtype=np.float64)
                    for m in members])
    n = ns.sum()
    w = ns.reshape((-1,) + (1,) * (means.ndim - 1))
    mean = (w * means).sum(axis=0) / max(n, 1.0)
    m2 = (m2s + w * (means - mean) ** 2).sum(axis=0)
    return {"n_frames": float(n), "mean": mean, "m2": m2,
            "rmsf": np.asarray(rmsf_from_moments(n, m2))}


def pairwise_rmsd(means: list) -> np.ndarray:
    """(N, N) RMSD matrix over member MEAN structures (each (S, 3)):
    ``D[i, j] = sqrt(mean_atoms ||μᵢ − μⱼ||²)`` — the symmetric,
    zero-diagonal distance matrix the encore / diffusionmap / PCA
    analyses consume.  Members of one ensemble share a topology, so no
    re-alignment happens here: the members' own analyses already
    aligned their frames before accumulating the carries."""
    m = np.stack([np.asarray(x, dtype=np.float64) for x in means])
    d = m[:, None, :, :] - m[None, :, :, :]
    return np.sqrt((d ** 2).sum(axis=-1).mean(axis=-1))


def _member_frames(spec: dict, results: dict) -> float:
    """A member's frame weight for the RDF merge: its own reported
    ``n_frames`` when the analysis ships one, else the spec window's
    length, else 1 (uniform)."""
    if "n_frames" in results:
        return float(np.asarray(results["n_frames"]).reshape(()))
    start, stop, step = (spec.get("start"), spec.get("stop"),
                         spec.get("step"))
    if stop is not None:
        return float(len(range(start or 0, stop, step or 1)))
    fix = spec.get("fixture") or {}
    if fix.get("n_frames"):
        return float(len(range(start or 0, fix["n_frames"],
                               step or 1)))
    return 1.0


def merge_rdf(members: list[dict], weights: list[float]) -> dict:
    """Frame-weighted ensemble RDF: raw ``count`` histograms SUM
    (counts are extensive), the normalized ``g(r)`` averages with each
    member weighted by its frame count (``g`` is per-frame intensive,
    so the weighted mean equals the pooled-frame g(r) when members
    share density/volume).  ``bins`` / ``edges`` must agree across
    members — a silent merge across different grids is the failure
    class PR-9 forbids."""
    bins0 = np.asarray(members[0]["bins"])
    for i, m in enumerate(members[1:], start=1):
        if not np.array_equal(np.asarray(m["bins"]), bins0):
            raise ValueError(
                f"member {i} RDF bins disagree with member 0 "
                f"(ensemble members must share the RDF grid)")
    w = np.asarray(weights, dtype=np.float64)
    w = w / max(w.sum(), 1e-30)
    count = sum(np.asarray(m["count"], dtype=np.float64)
                for m in members)
    rdf = sum(wi * np.asarray(m["rdf"], dtype=np.float64)
              for wi, m in zip(w, members))
    return {"bins": bins0, "edges": np.asarray(members[0]["edges"]),
            "count": count, "rdf": rdf}


def merge_member_results(members: list[tuple[int, dict, dict]]) -> dict:
    """The controller-side cross-trajectory reduction
    (docs/ENSEMBLE.md "Merge semantics"): ``members`` is
    ``[(member_index, member_spec, member_results), ...]`` for every
    DONE member, in member order.  Returns the parent's results dict
    (JSON-friendly: arrays as nested lists, like ``_merge_parent``'s
    shard concatenation):

    - ``ensemble_members`` — the member count;
    - ``member<i>_<name>`` — every member series, fanned out verbatim
      (the per-member view: nothing the reduction eats is lost);
    - moments reduction (when every member ships the Welford carries):
      ``rmsf`` / ``mean`` / ``m2`` / ``n_frames`` over the pooled
      ensemble, plus ``pairwise_rmsd`` — the (N, N) mean-structure
      distance matrix;
    - RDF reduction (when every member ships an RDF): summed
      ``count``, frame-weighted ``rdf``, shared ``bins`` / ``edges``.
    """
    merged: dict = {"ensemble_members": len(members)}
    results = [r for _i, _s, r in members]
    for i, _spec, res in members:
        for name, val in (res or {}).items():
            merged[f"member{i}_{name}"] = val
    if all(all(k in (r or {}) for k in MOMENT_KEYS)
           for r in results):
        mom = merge_moments(results)
        merged.update(
            n_frames=mom["n_frames"],
            mean=mom["mean"].tolist(), m2=mom["m2"].tolist(),
            rmsf=mom["rmsf"].tolist(),
            pairwise_rmsd=pairwise_rmsd(
                [r["mean"] for r in results]).tolist())
    if all(all(k in (r or {}) for k in RDF_KEYS) for r in results):
        rdf = merge_rdf(results, [_member_frames(s, r)
                                  for _i, s, r in members])
        merged.update(bins=rdf["bins"].tolist(),
                      edges=rdf["edges"].tolist(),
                      count=rdf["count"].tolist(),
                      rdf=rdf["rdf"].tolist())
    return merged
