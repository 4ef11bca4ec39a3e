"""Fair-share QoS plane: per-tenant deficit-round-robin state.

Counterpart of the JAX package's ``apps/qos.py`` (``TenantState``,
``QosPlane``), without admission buckets and metric series. Tenants are
client conn ids. Each carries a deficit in NONCES; :meth:`QosPlane.pick`
walks a ring of the backlogged tenants: the head is granted while its
deficit covers its next item's cost, is topped up by ``weight *
quantum`` at most once per ring cycle, and the ring rotates past it once
it cannot afford. The quantum is the largest candidate cost of the pick,
so every backlogged tenant is granted within ``ceil(1/weight)`` cycles,
and sustained grant share converges to the weight ratio. The items are
chunks, so an elephant yields the pool to a mouse between chunks.

The scheduler owns chunk plans and miner choice; this plane answers
"whose turn is it" and keeps the per-tenant in-flight counts.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional


class TenantState:
    """Per-tenant DRR state (one per live client conn)."""

    __slots__ = ("tenant", "weight", "deficit", "inflight",
                 "granted_nonces", "granted_chunks")

    def __init__(self, tenant, weight: float):
        self.tenant = tenant
        self.weight = max(weight, 1e-3)
        self.deficit = 0.0
        self.inflight = 0          # granted, not yet answered, chunks
        self.granted_nonces = 0
        self.granted_chunks = 0


class QosPlane:
    """Tenant registry + DRR ring. The scheduler executes every
    decision; the plane owns whose-turn-is-it and the accounting."""

    #: Safety valve on the DRR walk: weights are clamped to >= 1e-3, but
    #: a pick must terminate even on corrupted state.
    MAX_PASSES = 1024

    def __init__(self):
        self.tenants: Dict[object, TenantState] = {}
        self.ring: deque = deque()        # backlogged tenant ids, DRR order
        self._in_ring: set = set()
        # Tenants topped up in the current ring cycle (DRR adds the
        # quantum once per round, not once per missed pick).
        self._topped: set = set()
        self.total_granted_nonces = 0

    def tenant(self, tenant, weight: float = 1.0) -> TenantState:
        """The tenant's state, created on first sight with ``weight``
        (later calls ignore it)."""
        st = self.tenants.get(tenant)
        if st is None:
            st = self.tenants[tenant] = TenantState(tenant, weight)
        return st

    def _ensure_ring(self, tenant) -> None:
        if tenant not in self._in_ring:
            self._in_ring.add(tenant)
            self.ring.append(tenant)

    def sync_backlog(self, backlogged) -> None:
        """Reconcile the ring with the current backlogged tenants (in
        arrival order). Idle time banks no credit: a tenant leaving the
        ring forfeits its deficit, and one entering starts from zero."""
        ordered = list(backlogged)
        gone = self._in_ring - set(ordered)
        if gone:
            self.ring = deque(t for t in self.ring if t not in gone)
            self._in_ring -= gone
            self._topped -= gone
            for tenant in gone:
                st = self.tenants.get(tenant)
                if st is not None:
                    st.deficit = 0.0
        for tenant in ordered:
            if tenant not in self._in_ring:
                st = self.tenants.get(tenant)
                if st is not None:
                    st.deficit = 0.0
                self._ensure_ring(tenant)

    def forget(self, tenant) -> None:
        """Drop a tenant for good (its conn closed)."""
        if self.tenants.pop(tenant, None) is None:
            return
        self._topped.discard(tenant)
        if tenant in self._in_ring:
            self._in_ring.discard(tenant)
            self.ring.remove(tenant)

    def pick(self, candidates: Dict[object, int]) -> Optional[object]:
        """DRR choice among ``{tenant: next_item_cost_in_nonces}``, which
        the caller has already cut down to executable work. Returns the
        tenant to grant (the caller reports the grant through
        :meth:`on_grant`, which debits the deficit), or None."""
        if not candidates:
            return None
        for tenant in candidates:
            self.tenant(tenant)
            self._ensure_ring(tenant)
        quantum = max(candidates.values()) or 1
        visited = 0
        for _ in range(self.MAX_PASSES * max(1, len(self.ring))):
            tenant = self.ring[0]
            cost = candidates.get(tenant)
            if cost is not None:
                st = self.tenants[tenant]
                if st.deficit >= cost:
                    return tenant
                if tenant not in self._topped:
                    self._topped.add(tenant)
                    st.deficit += st.weight * quantum
                    if st.deficit >= cost:
                        return tenant
            self.ring.rotate(-1)
            visited += 1
            if visited >= len(self.ring):
                visited = 0
                self._topped.clear()
        return next(iter(candidates))   # unreachable safety valve

    def on_grant(self, tenant, nonces: int) -> None:
        """Account one executed grant: debit the deficit, count it in
        flight."""
        st = self.tenant(tenant)
        st.deficit = max(0.0, st.deficit - nonces)
        st.inflight += 1
        st.granted_chunks += 1
        st.granted_nonces += nonces
        self.total_granted_nonces += nonces

    def on_chunk_answered(self, tenant) -> None:
        st = self.tenants.get(tenant)
        if st is not None and st.inflight > 0:
            st.inflight -= 1

    def release(self, tenant, outstanding: int) -> None:
        """A request retired with ``outstanding`` granted-unanswered
        chunks (prefix release, client drop): free the tenant's slots."""
        st = self.tenants.get(tenant)
        if st is not None:
            st.inflight = max(0, st.inflight - max(0, outstanding))

    def grant_share(self, tenant) -> float:
        """Cumulative granted-nonce share of one tenant."""
        st = self.tenants.get(tenant)
        if st is None or not self.total_granted_nonces:
            return 0.0
        return st.granted_nonces / self.total_granted_nonces
