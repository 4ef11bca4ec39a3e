"""The request queue, indexed per tenant.

Counterpart of the queue half of the JAX package's
``apps/tenant_plane.py``: an insertion-ordered map of every queued
request plus a FIFO per tenant (client conn id), so enqueue, the global
head pop, a targeted dequeue and a tenant's purge are O(1)-amortized,
and the QoS pump's per-tenant head scan is O(backlogged tenants); and
the queue-age alarms of the JAX package's ``TenantPlane``
(:meth:`TenantQueue.check_queue_age`), which the scheduler's sweep runs.
"""

from __future__ import annotations

import logging
import time
from collections import deque

logger = logging.getLogger("dbmt.scheduler")


class TenantQueue:
    """Queued requests in arrival order, with per-tenant FIFO heads."""

    def __init__(self):
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
