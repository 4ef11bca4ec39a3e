"""The tenant plane: the request queue, admission, shedding and weights.

Counterpart of the JAX package's ``apps/tenant_plane.py``, without its
trace, flight-recorder and capture hooks. :class:`TenantPlane` holds an
insertion-ordered map of every queued request plus a FIFO per tenant
(client conn id), so enqueue, the global head pop, a targeted dequeue
and a tenant's purge are O(1)-amortized, and the QoS pump's per-tenant
head scan is O(backlogged tenants); the queue-age alarms
(:meth:`TenantPlane.check_queue_age`), which the scheduler's sweep runs;
the :class:`~.qos.QosPlane` and everything tenant-facing around it:
per-tenant weight overrides, admission through each tenant's token
bucket, the SHED (classic LSP has no reject message, so the shed closes
the tenant's conn, and its other queued requests go with it) and the
idle-tenant GC. Under the lazy pump every enqueue enters its tenant
into the DRR ring.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Callable, Optional

from ..lsp.errors import LspError
from ..utils.config import QosParams
from .qos import QosPlane

logger = logging.getLogger("dbmt.scheduler")


class TenantPlane:
    """Queued requests in arrival order, with per-tenant FIFO heads, and
    the tenants' QoS state. ``count(name)`` is the scheduler's counter
    bump; ``close_conn(conn_id)`` the transport's close, which the shed
    uses. The admission buckets read ``time.monotonic`` through this
    module at each call."""

    def __init__(self, qos: QosParams, count: Callable,
                 close_conn: Optional[Callable] = None):
        self.qos = qos
        # The lazy pump enters a tenant into the DRR ring on each
        # enqueue; the eager pump syncs the ring itself.
        self.lazy = qos.enabled and qos.lazy
        self._count = count
        self._close_conn = close_conn
        self.qos_plane = QosPlane(clock=lambda: time.monotonic())
        self._tenant_weights: dict = {}    # per-tenant overrides
        self._queue: dict = {}       # qkey -> request, arrival order
        self._by_tenant: dict = {}   # tenant -> deque of its requests
        self._next_qkey = 0

    def __len__(self) -> int:
        return len(self._queue)

    def requests(self) -> list:
        """Arrival-ordered copy of the queued requests."""
        return list(self._queue.values())

    def enqueue(self, req) -> None:
        self._next_qkey += 1
        req.qkey = self._next_qkey
        self._queue[req.qkey] = req
        self._by_tenant.setdefault(req.conn_id, deque()).append(req)
        if self.lazy:
            self.qos_plane.backlog_enter(req.conn_id)

    def dequeue(self, req) -> None:
        """Remove one specific queued request (a pump grant)."""
        if self._queue.pop(req.qkey, None) is None:
            return
        dq = self._by_tenant[req.conn_id]
        if dq[0] is req:
            dq.popleft()
        else:
            dq.remove(req)
        if not dq:
            del self._by_tenant[req.conn_id]

    def pop_head(self):
        """Pop the globally oldest queued request, or None."""
        req = next(iter(self._queue.values()), None)
        if req is not None:
            self.dequeue(req)
        return req

    def purge_tenant(self, conn_id) -> list:
        """Remove and return, in arrival order, every queued request of
        one tenant (its client dropped)."""
        dq = self._by_tenant.pop(conn_id, None)
        if not dq:
            return []
        for req in dq:
            del self._queue[req.qkey]
        return list(dq)

    def tenant_heads(self) -> list:
        """``(tenant, oldest queued request)`` pairs, in the order the
        tenants first queued work."""
        return [(t, dq[0]) for t, dq in self._by_tenant.items()]

    def backlog_tenants(self) -> list:
        """Tenants with queued work, first-queued order."""
        return list(self._by_tenant)

    def tenant_head(self, tenant):
        """One tenant's oldest queued request, or None."""
        dq = self._by_tenant.get(tenant)
        return dq[0] if dq else None

    def check_queue_age(self, inflight: dict, bound: float, grant_share,
                        count, miners_n: int, eligible_n: int,
                        distrusted_n: int = 0) -> None:
        """Age alarms: each tenant's OLDEST queued request past ``bound``
        seconds, and every request IN FLIGHT past it, logs a warning (and
        counts ``queue_alarms`` or ``inflight_alarms``), at most once per
        bound interval per request. ``grant_share(tenant)`` is the
        tenant's share of the granted nonces, so a starved mouse reads
        apart from a busy elephant. Observability only."""
        if bound <= 0:
            return
        now = time.monotonic()
        for _tenant, req in self.tenant_heads():
            age = now - req.queued_at
            if age < bound or now - req.last_alarm < bound:
                continue
            req.last_alarm = now
            count("queue_alarms")
            logger.warning(
                "tenant %d: oldest request %r [%d, %d] queued for %.1fs "
                "(bound %.1fs): grant_share=%.3f pool=%d eligible=%d "
                "distrusted=%d in_flight=%d",
                req.conn_id, req.data, req.lower, req.upper, age, bound,
                grant_share(req.conn_id), miners_n, eligible_n,
                distrusted_n, len(inflight))
        for req in inflight.values():
            if now - req.started < bound \
                    or now - req.last_inflight_alarm < bound:
                continue
            req.last_inflight_alarm = now
            count("inflight_alarms")
            logger.warning(
                "request %d (tenant %d) in flight for %.1fs (bound %.1fs): "
                "%d/%d chunks answered, %d granted, grant_share=%.3f",
                req.job_id, req.conn_id, now - req.started, bound,
                sum(req.answered), req.num_chunks, req.granted_chunks,
                grant_share(req.conn_id))


    def weight_for(self, tenant) -> float:
        w = self._tenant_weights.get(tenant)
        return w if w is not None else self.qos.weight_for(tenant)

    def set_weight(self, tenant, weight: float) -> None:
        self._tenant_weights[tenant] = max(weight, 1e-3)
        self.qos_plane.set_weight(tenant, weight)

    def tenant(self, conn_id):
        """The tenant's QoS state, created on first sight with its weight
        and an admission bucket of the configured rate and burst."""
        return self.qos_plane.tenant(conn_id, self.weight_for(conn_id),
                                     self.qos.rate, self.qos.burst)

    def admit(self, conn_id) -> bool:
        """Create the tenant on first sight and spend one admission
        token; False = shed it."""
        self.tenant(conn_id)
        return self.qos_plane.admit(conn_id)

    def shed(self, req, reason: str) -> None:
        """Shed one request (``reason`` ``"admission"`` or
        ``"overload"``): its tenant's other queued requests go with it,
        each counted in ``qos_shed``, and the tenant's conn is closed, so
        its client sees the connection die (its in-flight work finishes;
        the reply's write fails)."""
        others = self.purge_tenant(req.conn_id)
        victims = [req] + [r for r in others if r is not req]
        for victim in victims:
            self._count("qos_shed")
            self.qos_plane.on_shed(victim.conn_id)
        logger.warning(
            "QoS shed (%s): request %r [%d, %d] from tenant %d "
            "(+%d queued sibling(s)); closing its conn so the client "
            "backs off and resubmits", reason, req.data, req.lower,
            req.upper, req.conn_id, len(victims) - 1)
        if self._close_conn is not None:
            try:
                self._close_conn(req.conn_id)
            except LspError:
                logger.info("shed: conn %d already closed", req.conn_id)

    def gc(self, busy: set) -> None:
        """The idle-tenant GC, run by the sweep (:meth:`QosPlane.gc`)."""
        self.qos_plane.gc(busy)
