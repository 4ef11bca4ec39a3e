"""The tenant plane: the request queue, admission, shedding and weights.

Counterpart of the JAX package's ``apps/tenant_plane.py``.
:class:`TenantPlane` holds an
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

It also keeps the request traces: the :class:`~..utils.metrics.
TraceBuffer`, the export :class:`~..utils.trace.TrackSet` (a track per
tenant and per miner, retired where the entity goes), the
``DBMT_TRACE_SAMPLE`` decision (an unsampled request carries the shared
``NULL_TRACE`` and never registers), the traces of cache replays and
sheds, and the age alarms' trace dumps.
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from typing import Callable, Optional

from ..lsp.errors import LspError
from ..utils import trace as _tracing
from ..utils.config import QosParams
from ..utils.metrics import NULL_TRACE, Registry, RequestTrace, TraceBuffer
from .qos import QosPlane

logger = logging.getLogger("dbmt.scheduler")


class TenantPlane:
    """Queued requests in arrival order, with per-tenant FIFO heads, and
    the tenants' QoS state (its series go into ``metrics``, the
    scheduler's registry). ``count(name)`` is the scheduler's counter
    bump; ``close_conn(conn_id)`` the transport's close, which the shed
    uses. The admission buckets read ``time.monotonic`` through this
    module at each call. ``trace_on`` arms the tracks and the flight
    events; ``trace_sample`` (default ``DBMT_TRACE_SAMPLE``) is the share
    of requests traced; ``capture`` the scheduler's capture plane (None:
    off)."""

    def __init__(self, metrics: Registry, qos: QosParams, count: Callable,
                 close_conn: Optional[Callable] = None,
                 trace_on: bool = False,
                 trace_sample: Optional[float] = None,
                 capture=None):
        self.qos = qos
        # The capture plane's handle (None: off): a shed records one
        # event per victim.
        self._capture = capture
        # The lazy pump enters a tenant into the DRR ring on each
        # enqueue; the eager pump syncs the ring itself.
        self.lazy = qos.enabled and qos.lazy
        self._count = count
        self._close_conn = close_conn
        self.qos_plane = QosPlane(metrics, clock=lambda: time.monotonic())
        self._tenant_weights: dict = {}    # per-tenant overrides
        self._queue: dict = {}       # qkey -> request, arrival order
        self._by_tenant: dict = {}   # tenant -> deque of its requests
        self._next_qkey = 0
        self._trace_on = trace_on
        self.trace_sample = (trace_sample if trace_sample is not None
                             else _tracing.sample_rate())
        self._arrival_seq = 0
        self._cache_trace_seq = 0
        self.traces = TraceBuffer()
        self.tracks = _tracing.TrackSet()
        # The queue's depth, after each change (the rollup's ``queue``).
        self._queue_depth = metrics.gauge("queue_depth")

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
        self._queue_depth.set(len(self._queue))
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
        self._queue_depth.set(len(self._queue))

    def head(self):
        """The globally oldest queued request, or None (not popped)."""
        return next(iter(self._queue.values()), None)

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
        self._queue_depth.set(len(self._queue))
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

    # ------------------------------------------------------------- traces

    def new_trace(self, **meta):
        """A request's trace: a real :class:`RequestTrace`, or the shared
        ``NULL_TRACE`` when the deterministic sampler leaves it out."""
        self._arrival_seq += 1
        if _tracing.sample_hit(self._arrival_seq, self.trace_sample):
            return RequestTrace(**meta)
        return NULL_TRACE

    def track_tenant(self, conn_id) -> None:
        if self._trace_on:
            self.tracks.track("trace_track", tenant=str(conn_id))

    def track_miner(self, conn_id) -> None:
        if self._trace_on:
            self.tracks.track("trace_track", miner=str(conn_id))

    def retire_tenant_track(self, conn_id) -> None:
        self.tracks.retire("trace_track", tenant=str(conn_id))

    def retire_miner_track(self, conn_id) -> None:
        self.tracks.retire("trace_track", miner=str(conn_id))

    def dump_trace(self, why: str, trace) -> None:
        """One request's trace as a single-line JSON warning (the age
        alarms' payload)."""
        if trace is None or trace.null:
            return
        logger.warning("trace dump (%s): %s", why,
                       json.dumps(trace.to_dict(), sort_keys=True,
                                  default=str))

    def _register_synthetic(self, prefix: str, conn_id, trace) -> None:
        """Register a trace that never gets a job id under ``prefix:N``."""
        self._cache_trace_seq += 1
        self.traces.register(f"{prefix}:{self._cache_trace_seq}", trace)
        if not trace.null:
            self.track_tenant(conn_id)

    def cache_replay_trace(self, conn_id, key, h: int, nonce: int) -> None:
        """The trace of a request answered from the cache at arrival (it
        never becomes a Request), under a ``cache:N`` key."""
        trace = self.new_trace(data=key[0], lower=key[1], upper=key[2],
                               target=key[3], client=conn_id)
        if trace.null:
            self._cache_trace_seq += 1
            return
        trace.event("enqueue", queue_depth=len(self._queue))
        trace.event("cache_hit", at="request")
        trace.event("reply", hash=h, nonce=nonce, cached=True)
        self._register_synthetic("cache", conn_id, trace)

    def register_replay(self, req) -> None:
        """Register a dispatch-time cache replay's own trace (its queue
        wait is real history) under a ``cache:N`` key."""
        self._register_synthetic("cache", req.conn_id, req.trace)

    # ------------------------------------------------------------- alarms

    def check_queue_age(self, inflight: dict, bound: float, grant_share,
                        count, miners_n: int, eligible_n: int,
                        distrusted_n: int = 0, current=None) -> None:
        """Age alarms: each tenant's OLDEST queued request past ``bound``
        seconds, and every request IN FLIGHT past it, logs a warning (and
        counts ``queue_alarms`` or ``inflight_alarms``), at most once per
        bound interval per request, with a dump of its trace (and, for a
        queued one, of ``current``'s, the oldest in flight, unless its
        own alarm dumps it). ``grant_share(tenant)`` is the tenant's share
        of the granted nonces, so a starved mouse reads apart from a busy
        elephant. One flight dump a sweep that alarmed. Observability
        only."""
        if bound <= 0:
            return
        now = time.monotonic()
        queue_alarmed = False
        for _tenant, req in self.tenant_heads():
            age = now - req.queued_at
            if age < bound or now - req.last_alarm < bound:
                continue
            req.last_alarm = now
            queue_alarmed = True
            share = grant_share(req.conn_id)
            count("queue_alarms")
            logger.warning(
                "tenant %d: oldest request %r [%d, %d] queued for %.1fs "
                "(bound %.1fs): grant_share=%.3f pool=%d eligible=%d "
                "distrusted=%d in_flight=%d",
                req.conn_id, req.data, req.lower, req.upper, age, bound,
                share, miners_n, eligible_n, distrusted_n, len(inflight))
            req.trace.event("queue_alarm", age_s=round(age, 3),
                            tenant=req.conn_id,
                            grant_share=round(share, 4))
            self.dump_trace("queue-age alarm: stalled request", req.trace)
        inflight_due = [
            r for r in inflight.values()
            if now - r.started >= bound
            and now - r.last_inflight_alarm >= bound]
        if queue_alarmed and current is not None \
                and current not in inflight_due:
            self.dump_trace("queue-age alarm: request in flight "
                            "ahead of the stalled one", current.trace)
        for req in inflight_due:
            age = now - req.started
            req.last_inflight_alarm = now
            share = grant_share(req.conn_id)
            count("inflight_alarms")
            logger.warning(
                "request %d (tenant %d) in flight for %.1fs (bound %.1fs): "
                "%d/%d chunks answered, %d granted, grant_share=%.3f",
                req.job_id, req.conn_id, age, bound, sum(req.answered),
                req.num_chunks, req.granted_chunks, share)
            req.trace.event("inflight_alarm", age_s=round(age, 3),
                            tenant=req.conn_id,
                            grant_share=round(share, 4))
            self.dump_trace("in-flight age alarm", req.trace)
        if self._trace_on and (queue_alarmed or inflight_due):
            _tracing.flight_dump("queue-age / in-flight alarm")


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
        for i, victim in enumerate(victims):
            self._count("qos_shed")
            if self._capture is not None:
                # The purged siblings are sheds too (reason "conn").
                self._capture.shed(victim.conn_id,
                                   reason if i == 0 else "conn")
            self.qos_plane.on_shed(victim.conn_id,
                                   reason if i == 0 else "conn")
            victim.trace.event("cancel", reason="shed", shed_reason=reason)
            self._register_synthetic("shed", victim.conn_id, victim.trace)
            if self._trace_on:
                _tracing.flight("shed", tenant=victim.conn_id,
                                reason=reason)
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
        """The idle-tenant GC, run by the sweep (:meth:`QosPlane.gc`); a
        forgotten tenant's export track goes with it."""
        before = set(self.qos_plane.tenants)
        self.qos_plane.gc(busy)
        for tenant in before - set(self.qos_plane.tenants):
            self.retire_tenant_track(tenant)
