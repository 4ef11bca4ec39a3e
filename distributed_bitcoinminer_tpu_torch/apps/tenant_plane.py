"""The request queue, indexed per tenant.

Counterpart of the queue half of the JAX package's
``apps/tenant_plane.py``: an insertion-ordered map of every queued
request plus a FIFO per tenant (client conn id), so enqueue, the global
head pop, a targeted dequeue and a tenant's purge are O(1)-amortized,
and the QoS pump's per-tenant head scan is O(backlogged tenants).
"""

from __future__ import annotations

from collections import deque


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
