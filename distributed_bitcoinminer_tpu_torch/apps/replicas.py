"""Scheduler replicas: N schedulers behind one socket, tenants hashed.

Counterpart of the JAX package's ``apps/replicas.py`` (its in-process
replica tier). The server runs N port :class:`~.scheduler.Scheduler`\\ s
as REPLICAS behind one LSP server (``DBMT_REPLICAS`` > 1):

- **Tenant sharding.** Each client conn id is consistent-hashed
  (:class:`HashRing`: SHA-256 points, ``VNODES`` virtual nodes a replica)
  onto one serving replica; on a change of the replicas only about 1/N of
  the tenants move. A tenant's owner is pinned at its first request (its
  requests stay on one replica, in order) and resolved again only when
  that replica leaves.
- **Miner slices.** A joining miner goes to the live replica with the
  fewest miners. A replica grants only to its own slice, so each miner's
  FIFO discipline (the k-th Result answers the k-th Request) holds per
  replica.
- **A shared replay tier.** Every replica shares ONE
  :class:`~.scheduler.ResultCache`: a tenant that moves to another
  replica replays its finished answers there.
- **Takeover** (:meth:`ReplicaSet.kill`). A dead replica's miners are
  ADOPTED by the survivors (their pending chunks ride along cancelled, so
  their late answers pop as stale in order), then its queued and
  in-flight requests are served again through their new owners
  (``Scheduler.reserve_request``: no admission token, no overload shed).
  Exactly once: the dead replica never answered a request still queued or
  in flight, and a request it did answer replays from the shared cache.

Job ids come from disjoint ranges, ``JOB_ID_STRIDE`` apart, one a
replica: an adopted miner's late Result carries the dead replica's job
id, which must be stale on its adopter, never a live job of it.

A repeat JOIN from a conn a live replica already owns (a GatewayMiner's
rate-hint refresh, under ``DBMT_GATEWAY``) goes to that owner: picking
the thinnest slice again would register the same gateway on a second
replica.

``DBMT_REPLICAS=1`` (the default) keeps the server's plain single
scheduler, byte for byte. The multi-process tier (one process a replica,
heartbeats, fencing) is ``apps.procs``.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
from bisect import bisect_right
from typing import Dict, List, Optional

from ..bitcoin.message import Message, MsgType, new_request
from ..utils.config import (CacheParams, cache_from_env, gateway_from_env,
                            recv_batch_from_env, replicas_from_env)
from .scheduler import ResultCache, Scheduler, receive

logger = logging.getLogger("dbmt.replicas")

__all__ = ["HashRing", "ReplicaSet", "replicas_from_env"]


class HashRing:
    """A consistent hash ring over replica ids.

    ``VNODES`` virtual points a replica (SHA-256 of ``"r{id}:{v}"``); a
    key (``"t:{key}"``) maps to the first point clockwise. Adding or
    removing one replica moves only the key ranges next to its points;
    every key the changed replica did not own keeps its owner."""

    VNODES = 64

    def __init__(self, replica_ids: List[int]):
        self.replica_ids = list(replica_ids)
        points = sorted((self._point(f"r{rid}:{v}"), rid)
                        for rid in self.replica_ids
                        for v in range(self.VNODES))
        self._hashes = [h for h, _ in points]
        self._owners = [rid for _, rid in points]

    @staticmethod
    def _point(key: str) -> int:
        return int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:8], "big")

    def owner(self, key) -> int:
        """The replica id owning ``key`` (any hashable; conn ids here)."""
        if not self._hashes:
            raise ValueError("empty ring")
        i = bisect_right(self._hashes, self._point(f"t:{key}"))
        return self._owners[i % len(self._owners)]


class ReplicaSet:
    """N scheduler replicas behind one transport (see the module
    docstring). It owns the read loop: a JOIN makes the conn a miner of
    the thinnest slice, any other conn is a tenant routed by the ring,
    and each item goes to its owner's event handler. Each replica runs
    its own sweep at its lease tick. The keyword arguments are each
    replica's :class:`~.scheduler.Scheduler`'s (``cache`` sizes the one
    shared cache). Replica ``rid``'s metrics are mounted in the process
    registry as ``sched.r{rid}``, so the metrics emitter exports every
    replica's series."""

    #: The distance between two replicas' job-id ranges.
    JOB_ID_STRIDE = 1 << 40
    #: Tenant-pin GC cadence, in routed requests.
    ROUTE_GC_EVERY = 4096

    def __init__(self, server, n: Optional[int] = None, *,
                 cache: Optional[CacheParams] = None, capture=None,
                 recv_batch: Optional[int] = None, **sched_kw):
        self.server = server
        # The batched receive, as the scheduler's (``DBMT_RECV_BATCH``).
        self._recv_batch = max(1, recv_batch) if recv_batch is not None \
            else recv_batch_from_env()
        self.n = n if n is not None else replicas_from_env()
        cache = cache if cache is not None else cache_from_env()
        #: The shared replay tier (None when caching is off).
        self.shared_cache: Optional[ResultCache] = (
            ResultCache(cache.size) if cache.enabled else None)
        self.replicas: Dict[int, Scheduler] = {}
        for rid in range(self.n):
            sched = Scheduler(server, cache=cache,
                              result_cache=self.shared_cache,
                              capture=capture, recv_batch=self._recv_batch,
                              metrics_prefix=f"sched.r{rid}", **sched_kw)
            sched._next_job_id = rid * self.JOB_ID_STRIDE
            self.replicas[rid] = sched
        self.live: List[int] = list(range(self.n))
        self._miner_owner: Dict[int, int] = {}
        # Tenant pins: a tenant's owner, fixed at its first request,
        # resolved again only when that replica leaves; pruned of tenants
        # that hold no state (a shed conn gets no drop event).
        self._tenant_owner: Dict[int, int] = {}
        self._serving: Optional[List[int]] = None
        self._route_ring: Optional[HashRing] = None
        self._routes_since_gc = 0
        self._sweep_tasks: Dict[int, asyncio.Task] = {}
        # Repeat JOINs go to their owner (``DBMT_GATEWAY``, read once, as
        # the schedulers read it).
        self._gateway = gateway_from_env().enabled

    # ------------------------------------------------------------- routing

    @property
    def ring(self) -> HashRing:
        """The routing ring (over the serving replicas)."""
        return self._routing_ring()

    def _routing_ring(self) -> HashRing:
        """The ring over the SERVING replicas: live and holding a miner
        (a replica with none would queue its tenants while another
        served). With no miner anywhere, the first live replica, where
        the next JOIN lands."""
        serving = [rid for rid in self.live
                   if self.replicas[rid].miners] or [self.live[0]]
        if serving != self._serving:
            self._serving = serving
            self._route_ring = HashRing(serving)
        return self._route_ring

    def owner_of(self, conn_id: int) -> Scheduler:
        """The replica owning tenant ``conn_id``: its pin, or a fresh
        consistent hash over the serving replicas."""
        rid = self._tenant_owner.get(conn_id)
        if rid is None or rid not in self.live:
            rid = self._routing_ring().owner(conn_id)
            self._tenant_owner[conn_id] = rid
        return self.replicas[rid]

    def _gc_tenant_pins(self) -> None:
        """Drop the pins of tenants that hold no state on their owner
        (not a QoS tenant, nothing queued, nothing in flight)."""
        active: Dict[int, set] = {}
        for rid in self.live:
            sched = self.replicas[rid]
            conns = set(sched.qos_plane.tenants)
            conns.update(r.conn_id for r in sched.tenant_plane.requests())
            conns.update(r.conn_id for r in sched._inflight.values())
            active[rid] = conns
        self._tenant_owner = {
            conn: rid for conn, rid in self._tenant_owner.items()
            if rid in active and conn in active[rid]}

    def _thinnest(self) -> int:
        """The live replica with the fewest miners (the first on a tie)."""
        return min(self.live, key=lambda r: len(self.replicas[r].miners))

    def route(self, conn_id: int, payload) -> None:
        """Feed one transport item (a payload or a conn's death) to its
        owner."""
        if isinstance(payload, Exception):
            rid = self._miner_owner.pop(conn_id, None)
            if rid is not None:
                if rid in self.live:
                    self.replicas[rid]._on_drop(conn_id)
            else:
                self.owner_of(conn_id)._on_drop(conn_id)
                self._tenant_owner.pop(conn_id, None)
            return
        try:
            msg = Message.from_json(payload)
        except ValueError:
            return
        if msg.type == MsgType.JOIN:
            rid = self._miner_owner.get(conn_id)
            if self._gateway and rid is not None and rid in self.live:
                self.replicas[rid]._on_join(conn_id, msg)
                return
            rid = self._thinnest()
            self._miner_owner[conn_id] = rid
            self.replicas[rid]._on_join(conn_id, msg)
        elif msg.type == MsgType.RESULT:
            rid = self._miner_owner.get(conn_id)
            if rid is not None and rid in self.live:
                self.replicas[rid]._on_result(conn_id, msg)
        elif msg.type == MsgType.REQUEST:
            self.owner_of(conn_id)._on_request(conn_id, msg)
            self._routes_since_gc += 1
            if self._routes_since_gc >= self.ROUTE_GC_EVERY:
                self._routes_since_gc = 0
                self._gc_tenant_pins()

    # ------------------------------------------------------------ lifecycle

    async def run(self) -> None:
        """Serve until the transport closes (or the task is cancelled):
        one read loop, N sweeps; at the end the merged counters are logged
        as ``replicas rollup``."""
        loop = asyncio.get_running_loop()
        for rid in self.live:
            self._sweep_tasks[rid] = loop.create_task(
                self._sweep_loop(self.replicas[rid]))
        try:
            await receive(self.server, self.route, self._recv_batch)
        finally:
            for task in self._sweep_tasks.values():
                task.cancel()
            logger.info("replicas rollup %s", json.dumps(
                self.cluster_rollup()["counters"], sort_keys=True))

    async def _sweep_loop(self, sched: Scheduler) -> None:
        while True:
            await asyncio.sleep(sched.lease.tick_s)
            try:
                sched.sweep()
            except Exception:   # noqa: BLE001 — a sweep must never die
                logger.exception("replica sweep failed; continuing")

    def kill(self, rid: int) -> None:
        """A replica's death and the takeover: its miners are adopted
        first (the survivors need the capacity), thinnest surviving slice
        first, then its queued and in-flight requests are served again
        through their new owners (an in-flight request's ``upper`` was
        made exclusive at dispatch: undone for the wire)."""
        if rid not in self.live:
            raise ValueError(f"replica {rid} is not live")
        dead = self.replicas[rid]
        self.live.remove(rid)
        if not self.live:
            self.live.append(rid)
            raise ValueError("cannot kill the last live replica")
        self._serving = None
        self._tenant_owner = {c: r for c, r in self._tenant_owner.items()
                              if r != rid}
        task = self._sweep_tasks.pop(rid, None)
        if task is not None:
            task.cancel()
        adopted = 0
        for conn_id, owner in list(self._miner_owner.items()):
            if owner != rid:
                continue
            target = self._thinnest()
            miner = dead.miner_plane.find_miner(conn_id)
            self.replicas[target].miner_plane.adopt_miner(
                conn_id,
                pending=list(miner.pending) if miner else None,
                rate_ewma=miner.rate_ewma if miner else None)
            self._miner_owner[conn_id] = target
            adopted += 1
        reserved = 0
        for req in list(dead._inflight.values()) \
                + dead.tenant_plane.requests():
            upper = req.upper - 1 if req.qos_mode else req.upper
            self.owner_of(req.conn_id).reserve_request(
                req.conn_id, new_request(req.data, req.lower, upper,
                                         req.target))
            reserved += 1
        logger.warning(
            "replica %d killed: %d miner(s) adopted, %d request(s) "
            "re-served across %d survivor(s)", rid, adopted, reserved,
            len(self.live))
        for r in self.live:
            self.replicas[r]._maybe_dispatch()

    # ------------------------------------------------- aggregate views

    @property
    def stats(self) -> dict:
        """Counter totals over EVERY replica (the dead ones' served
        requests happened)."""
        out: dict = {}
        for sched in self.replicas.values():
            for k, v in sched.stats.items():
                out[k] = out.get(k, 0) + v
        return out

    def cluster_rollup(self) -> dict:
        """Every replica's registry merged by the rollup plane's rules
        (``apps.rollup.merge_snapshots``): the counters summed."""
        from .rollup import merge_snapshots
        return merge_snapshots(
            (f"replica{rid}", sched.metrics.snapshot())
            for rid, sched in sorted(self.replicas.items()))

    def export_trace(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON of every live replica's retained
        request traces (as ``Scheduler.export_trace``, one track per
        tenant and miner); ``path`` also writes it."""
        from ..utils.trace import to_chrome_trace
        doc = to_chrome_trace([{**t.to_dict(), "t0": t.t0}
                               for _key, t in self.traces.items()])
        if path:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, sort_keys=True)
        return doc

    @property
    def queue(self) -> list:
        """Queued requests across the live replicas (read-only)."""
        return [r for rid in self.live for r in self.replicas[rid].queue]

    @property
    def _inflight(self) -> dict:
        """In-flight requests across the live replicas, by job id."""
        return {job: req for rid in self.live
                for job, req in self.replicas[rid]._inflight.items()}

    @property
    def qos_plane(self):
        """The live replicas' QoS planes, merged (read-only)."""
        return _MergedQos([self.replicas[rid] for rid in self.live])

    @property
    def traces(self):
        """The live replicas' trace buffers, merged (read-only)."""
        return _MergedTraces([self.replicas[rid] for rid in self.live])


class _MergedQos:
    """Read-only merged view of the live replicas' QoS planes: their
    ``tenants`` tables, which the interleaving explorer's accounting
    invariant walks."""

    def __init__(self, scheds):
        self.tenants: dict = {}
        for sched in scheds:
            self.tenants.update(sched.qos_plane.tenants)


class _MergedTraces:
    """Read-only merged view of the live replicas' trace buffers."""

    def __init__(self, scheds):
        self._scheds = scheds

    def items(self):
        out = []
        for sched in self._scheds:
            out.extend(sched.tenant_plane.traces.items())
        return out

    def get(self, key):
        for sched in self._scheds:
            hit = sched.tenant_plane.traces.get(key)
            if hit is not None:
                return hit
        return None
