"""Fair-share QoS plane: per-tenant deficit-round-robin and admission state.

Counterpart of the JAX package's ``apps/qos.py`` (``TokenBucket``,
``TenantState``, ``QosPlane``). Tenants are client conn ids. Three
mechanisms:

- **Deficit-round-robin at chunk granularity.** Each tenant carries a
  deficit in NONCES. :meth:`QosPlane.pick` walks a ring of the
  backlogged tenants: the head is granted while its deficit covers its
  next item's cost, is topped up by ``weight * quantum`` at most once per
  ring cycle, and the ring rotates past it once it cannot afford. The
  quantum is the largest candidate cost of the pick, so every backlogged
  tenant is granted within ``ceil(1/weight)`` cycles, and sustained grant
  share converges to the weight ratio. The items are chunks, so an
  elephant yields the pool to a mouse between chunks.
  :meth:`QosPlane.pick_lazy` walks the same ring but prices each visited
  tenant's head on demand, with the largest cost seen so far as the
  quantum (the lazy pump).
- **Token-bucket admission.** A bucket per tenant of ``burst`` tokens
  refilled at ``rate`` a second; a request that finds it empty is shed
  (:meth:`QosPlane.admit`). The scheduler answers cache replays before
  admission, so they spend no token.
- **In-flight and shed bookkeeping.** Granted-unanswered chunks per
  tenant (the scheduler's ``max_inflight`` cap reads them), sheds per
  tenant, and the idle-tenant GC (:meth:`QosPlane.gc`).

The scheduler owns chunk plans and miner choice; this plane answers
"whose turn is it" and keeps the per-tenant accounting.

Its series, in the scheduler's registry (mounted under ``sched.``):
``qos_tenants`` (the tenants known), ``qos_granted_chunks{tenant}`` and
``qos_grant_share{tenant}`` (the tenant's cumulative share of the granted
nonces), ``qos_shed_reason{reason}`` (``admission``, ``overload`` or
``conn``). A grant sets the granted tenant's share at once; the others',
stale against the grown total, are refreshed from :meth:`QosPlane.gc`
once a sweep (the tenants granted since the last sweep, and every tenant
each ``FULL_REFRESH_SWEEPS``-th sweep), so a grant costs O(1). A
forgotten tenant's series retire with it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional

from ..utils.metrics import Registry

__all__ = ["LAZY_REMOVE", "QosPlane", "TenantState", "TokenBucket"]

#: What a :meth:`QosPlane.pick_lazy` head callback returns for a tenant
#: with no backlog at all: the walk drops it from the ring on the spot,
#: and its deficit with it.
LAZY_REMOVE = object()


class TokenBucket:
    """``burst`` tokens, refilled at ``rate`` a second, read off
    ``clock``. ``rate <= 0`` admits everything and reads full."""

    __slots__ = ("rate", "burst", "_tokens", "_t", "_clock")

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = rate
        self.burst = max(1.0, burst)
        self._tokens = self.burst
        self._clock = clock
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def take(self, n: float = 1.0) -> bool:
        """Spend ``n`` tokens; False (and nothing spent) when short."""
        if self.rate <= 0:
            return True
        self._refill()
        if self._tokens < n:
            return False
        self._tokens -= n
        return True

    def set_rate(self, rate: float, burst: Optional[float] = None) -> None:
        """Re-rate a live bucket (the adaptive admission controller): the
        tokens accrued so far are settled at the old rate, then the new
        rate (and burst, when given) applies from now."""
        self._refill()
        self.rate = rate
        if burst is not None:
            self.burst = max(1.0, burst)
            self._tokens = min(self._tokens, self.burst)

    @property
    def level(self) -> float:
        if self.rate <= 0:
            return self.burst
        self._refill()
        return self._tokens

    @property
    def full(self) -> bool:
        return self.level >= self.burst - 1e-9


class TenantState:
    """Per-tenant DRR and admission state (one per live client conn)."""

    __slots__ = ("tenant", "weight", "deficit", "inflight",
                 "granted_nonces", "granted_chunks", "shed", "bucket")

    def __init__(self, tenant, weight: float, bucket: TokenBucket):
        self.tenant = tenant
        self.weight = max(weight, 1e-3)
        self.deficit = 0.0
        self.inflight = 0          # granted, not yet answered, chunks
        self.granted_nonces = 0
        self.granted_chunks = 0
        self.shed = 0
        self.bucket = bucket


class QosPlane:
    """Tenant registry + DRR ring. The scheduler executes every
    decision; the plane owns whose-turn-is-it and the accounting.
    ``metrics`` is the scheduler's registry; ``clock`` feeds the
    admission buckets."""

    #: Safety valve on the DRR walk: weights are clamped to >= 1e-3, but
    #: a pick must terminate even on corrupted state.
    MAX_PASSES = 1024

    #: Every this-many sweeps :meth:`gc` refreshes every tenant's share
    #: gauge; in between only those granted since the last sweep.
    FULL_REFRESH_SWEEPS = 32

    def __init__(self, metrics: Registry,
                 clock: Callable[[], float] = time.monotonic):
        self.metrics = metrics
        self._clock = clock
        self.tenants: Dict[object, TenantState] = {}
        self.ring: deque = deque()        # backlogged tenant ids, DRR order
        self._in_ring: set = set()
        # Tenants topped up in the current ring cycle (DRR adds the
        # quantum once per round, not once per missed pick).
        self._topped: set = set()
        self.total_granted_nonces = 0
        # The lazy walk's quantum: the largest head cost it has priced
        # since the ring last drained.
        self._lazy_quantum = 0.0
        # Tenants granted since the last sweep (their share gauges are
        # the ones gc refreshes), and the sweeps so far.
        self._dirty_shares: set = set()
        self._sweeps = 0
        self._g_tenants = metrics.gauge("qos_tenants")

    def tenant(self, tenant, weight: float = 1.0, rate: float = 0.0,
               burst: float = 8.0) -> TenantState:
        """The tenant's state, created on first sight with ``weight`` and
        an admission bucket of ``rate`` and ``burst`` (later calls ignore
        them; :meth:`set_weight` changes a live tenant's weight)."""
        st = self.tenants.get(tenant)
        if st is None:
            st = self.tenants[tenant] = TenantState(
                tenant, weight, TokenBucket(rate, burst, self._clock))
            self._g_tenants.set(len(self.tenants))
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

    def backlog_enter(self, tenant) -> None:
        """The lazy pump's ring entry, the moment a tenant gains backlog
        (a request queued, a chunked activation with chunks left): one
        entering starts from zero deficit, one already in the ring keeps
        what it earned."""
        if tenant in self._in_ring:
            return
        st = self.tenants.get(tenant)
        if st is not None:
            st.deficit = 0.0
        self._ensure_ring(tenant)

    def set_weight(self, tenant, weight: float) -> None:
        if tenant in self.tenants:
            self.tenants[tenant].weight = max(weight, 1e-3)

    def forget(self, tenant) -> None:
        """Drop a tenant for good (its conn closed, or the idle GC), and
        its series with it, so conn churn cannot exhaust their bound."""
        if self.tenants.pop(tenant, None) is None:
            return
        self._topped.discard(tenant)
        self._dirty_shares.discard(tenant)
        if tenant in self._in_ring:
            self._in_ring.discard(tenant)
            self.ring.remove(tenant)
        self.metrics.remove("qos_grant_share", tenant=str(tenant))
        self.metrics.remove("qos_granted_chunks", tenant=str(tenant))
        self._g_tenants.set(len(self.tenants))

    def gc(self, busy: set) -> None:
        """Forget every tenant not in ``busy`` (no queued or in-flight
        work) with nothing granted outstanding and a full admission
        bucket: it holds nothing worth keeping. Then refresh the share
        gauges (:meth:`_update_shares`)."""
        for tenant in [t for t, st in self.tenants.items()
                       if t not in busy and st.inflight == 0
                       and st.bucket.full]:
            self.forget(tenant)
        self._update_shares()

    # ----------------------------------------------------------- admission

    def admit(self, tenant) -> bool:
        """Spend one admission token; False = shed at admission."""
        return self.tenants[tenant].bucket.take(1.0)

    def on_shed(self, tenant, reason: str) -> None:
        st = self.tenants.get(tenant)
        if st is not None:
            st.shed += 1
        self.metrics.counter(   # dbmlint: ok[cardinality] bounded:
            # reason is always one of the scheduler's literal shed kinds
            # ("admission" / "overload" / "conn"), never an entity id.
            "qos_shed_reason", reason=reason).inc()

    # ----------------------------------------------------------------- DRR

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

    def pick_lazy(self, head_fn) -> Optional[object]:
        """The lazy pump's DRR choice: the ring is walked and
        ``head_fn(tenant)`` prices the visited tenant's next item on
        demand, returning its cost in nonces (grantable now), None
        (backlogged, not grantable now) or :data:`LAZY_REMOVE` (no
        backlog: dropped from the ring, its deficit with it). The same
        rules as :meth:`pick`, with the largest cost priced so far as the
        quantum. Returns the tenant to grant, or None."""
        for _cycle in range(self.MAX_PASSES):
            visited = 0
            candidate_seen = False
            while visited < len(self.ring):
                tenant = self.ring[0]
                cost = head_fn(tenant)
                if cost is LAZY_REMOVE:
                    self.ring.popleft()
                    self._in_ring.discard(tenant)
                    self._topped.discard(tenant)
                    st = self.tenants.get(tenant)
                    if st is not None:
                        st.deficit = 0.0
                    continue               # the visit is not spent
                if cost is not None:
                    candidate_seen = True
                    if cost > self._lazy_quantum:
                        self._lazy_quantum = float(cost)
                    st = self.tenant(tenant)
                    if st.deficit >= cost:
                        return tenant
                    if tenant not in self._topped:
                        self._topped.add(tenant)
                        st.deficit += st.weight * self._lazy_quantum
                        if st.deficit >= cost:
                            return tenant
                self.ring.rotate(-1)
                visited += 1
            if not self.ring:
                self._lazy_quantum = 0.0   # idle plane: a fresh quantum
                return None
            if not candidate_seen:
                return None                # nothing grantable this pass
            self._topped.clear()           # a new cycle may top up afresh
        return None                        # safety valve

    def on_grant(self, tenant, nonces: int) -> None:
        """Account one executed grant: debit the deficit, count it in
        flight, and set the granted tenant's series (only its own: the
        others' shares are refreshed once a sweep, :meth:`gc`)."""
        st = self.tenant(tenant)
        st.deficit = max(0.0, st.deficit - nonces)
        st.inflight += 1
        st.granted_chunks += 1
        st.granted_nonces += nonces
        self.total_granted_nonces += nonces
        self._dirty_shares.add(tenant)
        self.metrics.counter("qos_granted_chunks", tenant=str(tenant)).inc()
        self.metrics.gauge("qos_grant_share", tenant=str(tenant)).set(
            st.granted_nonces / self.total_granted_nonces)

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

    def _update_shares(self) -> None:
        """One sweep's share-gauge refresh: the tenants granted since the
        last sweep, and every tenant each ``FULL_REFRESH_SWEEPS``-th
        sweep (so an idle tenant's gauge is stale a bounded number of
        sweeps; the alarms read :meth:`grant_share`, never the gauge)."""
        if not self.total_granted_nonces:
            return
        self._sweeps += 1
        if self._sweeps % self.FULL_REFRESH_SWEEPS == 0:
            targets = list(self.tenants.items())
        else:
            targets = [(t, self.tenants[t]) for t in self._dirty_shares
                       if t in self.tenants]
        for tenant, st in targets:
            self.metrics.gauge("qos_grant_share", tenant=str(tenant)).set(
                st.granted_nonces / self.total_granted_nonces)
        self._dirty_shares.clear()
