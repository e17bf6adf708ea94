"""Placement policy for the fleet tier: sticky tenant→home-host routing.

This module is the POLICY half of the placement-policy/executor-
mechanics split (ROADMAP item 1): pure bookkeeping, no sockets, no
processes — :mod:`~mdanalysis_mpi_tpu_torch.service.fleet` owns the
mechanics (spawning hosts, leases, migration) and consults this table
for every assignment.

Routing is **rendezvous (highest-random-weight) hashing** with a
sticky overlay:

- a tenant's FIRST assignment picks the eligible host with the highest
  ``sha1(tenant|host)`` score — deterministic across controllers (a
  standby that adopts the fleet re-derives the same homes without any
  state transfer), and minimally disruptive: losing one host re-places
  ONLY that host's tenants (every other tenant's top-scoring host is
  unchanged);
- after that the mapping is STICKY: a hot tenant's superblocks live in
  its home host's ``DeviceBlockCache`` (and its Universe/reader state
  in the host's tenant cache), so re-routing a healthy tenant would
  throw away exactly the residency the fleet exists to preserve.  The
  home only changes when the host leaves the eligible set.

Degradation ladder (docs/RELIABILITY.md §6): N hosts → fewer hosts
(the dead host's tenants re-place over survivors; everyone else stays
home) → ONE host (every tenant maps to it) → ZERO hosts
(:meth:`PlacementTable.assign` returns None and the controller parks
the work until a host returns — degraded, never failing).

Per-host circuit breakers (``reliability/breaker.py``) feed
eligibility: a host that keeps getting lost (flapping network, OOM
loop) trips its breaker and is skipped by placement until the
breaker's cooldown lets a rejoin probe through — membership alone is
not health.
"""

from __future__ import annotations

import hashlib
import threading


def rendezvous_score(tenant: str, host: str) -> int:
    """Deterministic per-(tenant, host) weight — the highest score
    among eligible hosts is the tenant's home.  sha1, not ``hash()``:
    the score must agree across controller processes and Python
    hash-randomization seeds (a standby re-derives homes on adoption)."""
    h = hashlib.sha1(f"{tenant}|{host}".encode()).digest()
    return int.from_bytes(h[:8], "big")


class PlacementTable:
    """Sticky tenant→home-host table over a changing host set.

    ``breakers``
        Optional :class:`~mdanalysis_mpi_tpu_torch.reliability.breaker.
        BreakerBoard`; a host whose breaker is OPEN is ineligible even
        while it is a member (the fleet controller records a failure
        per host loss, so a flapping host trips out of rotation).
    """

    def __init__(self, breakers=None):
        self._lock = threading.Lock()
        self._hosts: set[str] = set()
        self._home: dict[str, str] = {}
        self.breakers = breakers

    # ---- membership ----

    def add_host(self, host: str) -> None:
        with self._lock:
            self._hosts.add(host)

    def remove_host(self, host: str) -> list[str]:
        """Drop a host from membership; returns the tenants whose home
        it was (their next :meth:`assign` re-places them over the
        survivors — sticky for everyone else)."""
        with self._lock:
            self._hosts.discard(host)
            orphans = [t for t, h in self._home.items() if h == host]
            for t in orphans:
                del self._home[t]
            return orphans

    def hosts(self) -> set[str]:
        with self._lock:
            return set(self._hosts)

    def _eligible_locked(self) -> list[str]:
        # caller holds self._lock
        if self.breakers is None:
            return sorted(self._hosts)
        return sorted(h for h in self._hosts
                      if self.breakers.get(h, mesh="fleet").allow())

    def eligible(self) -> list[str]:
        with self._lock:
            return self._eligible_locked()

    # ---- routing ----

    def assign(self, tenant: str) -> str | None:
        """The tenant's home host: its sticky home while that host is
        eligible, else the highest-rendezvous-score eligible host
        (recorded as the new home).  None when NO host is eligible —
        the degraded-to-zero rung; callers park the work."""
        with self._lock:
            eligible = self._eligible_locked()
            home = self._home.get(tenant)
            if home is not None and home in eligible:
                return home
            if not eligible:
                return None
            best = max(eligible,
                       key=lambda h: rendezvous_score(tenant, h))
            self._home[tenant] = best
            return best

    def home_of(self, tenant: str) -> str | None:
        """Current sticky home (None if never assigned / orphaned)."""
        with self._lock:
            return self._home.get(tenant)

    def snapshot(self) -> dict:
        with self._lock:
            return {"hosts": sorted(self._hosts),
                    "eligible": self._eligible_locked(),
                    "homes": dict(self._home)}
