"""The scheduler: shard nonce ranges over an elastic miner pool, merge argmins.

The request state machine of the JAX package's ``apps/scheduler.py``
(itself the state machine of the reference coordinator, ref: bitcoin/
server/server.go:19-403), with the reference's method names. The pool
roster, pending FIFOs and coalescing windows live in
:mod:`.miner_plane`; the per-tenant queue index in :mod:`.tenant_plane`;
the deficit-round-robin state in :mod:`.qos`.

- Stock FIFO dispatch (``QosParams(enabled=False)``): ONE request in
  flight at a time. ``_load_balance`` makes bounds exclusive (``upper +=
  1``) and splits ``total // num_miners`` with the remainder to the FIRST
  miner; with more miners than nonces, only ``total`` miners get 1-nonce
  chunks (ref: server.go:165-205).
- Bound quirk preserved for bit parity: chunks are sent with EXCLUSIVE upper
  bounds but the miner treats ``Upper`` as inclusive (ref: miner.go:51-52),
  so each chunk scans one extra nonce and the system as a whole scans
  ``[0, maxNonce+1]``.
- Fair-share QoS dispatch (default on): tenants are client conn ids. A
  request estimated to scan longer than ``wholesale_s`` at the pool's
  throughput, or one that starts while chunked work is in flight, is
  CHUNKED and its chunks are granted one at a time by deficit-round-robin
  across tenants, each miner holding at most ``depth`` live chunks. A
  small request on an idle pool (and every request on a cold pool)
  dispatches wholesale, exactly like the stock path, so single-tenant
  traffic is bit-identical to it. Within one pump pass, small argmin
  chunks of different requests may be granted into one miner's
  COALESCING WINDOW: they share a ``coalesce_id``, count as one live
  chunk, and the miner runs them as one batched launch.
- Claim check: every Result is a claim; its hash is recomputed on the
  host with ``hash_op`` and its nonce must lie in the chunk. A failed
  claim is not merged and its range runs again on another miner.
- Result merge: strict ``<`` on the uint64 hash; the barrier releases the
  Result to the client when every chunk of the request has been answered
  (ref: server.go:257-325).
- Miner drop: its unanswered chunks go to available miners, else they
  park; a parked chunk is re-issued when a miner joins or frees up
  (ref: server.go:326-376, 222-244, 285-304).
- Client drop: its queued requests are purged and its in-flight requests
  are cancelled at once — miners are freed, parked chunks cleared, the
  next queued work starts.

Difficulty merge: a Request carrying a ``Target`` is forwarded with the
target on every chunk. Chunks cover ascending disjoint sub-ranges and each
until-speaking miner answers its chunk's FIRST qualifying (``hash <
target``) nonce, echoing the target; so the lowest-index qualifying chunk
holds the request's first qualifying nonce, final as soon as every earlier
chunk has answered (prefix release), whatever is still in flight. When no
chunk qualifies, the barrier answers the exact arg-min. A miner that
answers without echoing the target (a stock miner) makes the merge weak:
the answer is still qualifying when one exists, but not guaranteed first,
and the scheduler logs it.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Optional

from ..bitcoin.hash import MAX_U64, hash_op
from ..bitcoin.message import Message, MsgType, new_result
from ..lsp.errors import LspError
from ..lsp.server import AsyncServer
from ..utils.config import (CoalesceParams, QosParams, coalesce_from_env,
                            qos_from_env)
from .miner_plane import Chunk, MinerPlane, MinerState
from .qos import QosPlane
from .tenant_plane import TenantQueue

logger = logging.getLogger("dbmt.scheduler")

__all__ = ["Chunk", "MinerState", "Request", "Scheduler"]


@dataclass
class Request:
    conn_id: int
    data: str
    lower: int
    upper: int              # inclusive on arrival; +1 at dispatch
    target: int = 0
    job_id: int = 0
    num_chunks: int = 0
    min_hash: int = MAX_U64
    min_nonce: int = 0
    answered: list = field(default_factory=list)   # bool per chunk idx
    # Difficulty merge: each qualifying chunk's (nonce, hash) by chunk idx,
    # and whether a responder answered a target chunk without echoing the
    # target (then the answer is qualifying, not guaranteed first).
    chunk_q: dict = field(default_factory=dict)
    weak: bool = False
    started: float = 0.0
    qkey: int = 0                  # tenant-queue index stamp
    # QoS: "wholesale" (every chunk assigned at dispatch) or "chunked"
    # (chunk plan held here, granted one chunk at a time).
    qos_mode: str = ""
    chunk_bounds: list = field(default_factory=list)  # chunked: [(lo, up)]
    next_chunk: int = 0            # chunked: first ungranted idx
    granted_chunks: int = 0


class Scheduler:
    """Single-actor scheduler over an :class:`AsyncServer`. ``qos`` and
    ``coalesce`` default to the environment's (``DBMT_*`` knobs)."""

    def __init__(self, server: AsyncServer, qos: Optional[QosParams] = None,
                 coalesce: Optional[CoalesceParams] = None):
        self.server = server
        self.qos = qos if qos is not None else qos_from_env()
        coalesce = coalesce if coalesce is not None else coalesce_from_env()
        # In-flight requests by job id, oldest first. The stock FIFO path
        # keeps at most one; the QoS plane runs several.
        self._inflight: dict[int, Request] = {}
        self._chunked_inflight = 0
        self.queue = TenantQueue()
        self.qos_plane = QosPlane()
        self.miner_plane = MinerPlane(coalesce, write=self._write,
                                      inflight=self._inflight)
        self._next_job_id = 0
        self._dispatching = False
        self.stats = {"results_sent": 0, "dup_results": 0,
                      "claims_checked": 0, "claims_failed": 0,
                      "qos_grants": 0, "qos_window_grants": 0}

    @property
    def current(self) -> Optional[Request]:
        """The oldest in-flight request, or None."""
        return next(iter(self._inflight.values()), None)

    @property
    def inflight(self) -> dict:
        return dict(self._inflight)

    @property
    def miners(self) -> list:
        return self.miner_plane.miners

    async def run(self) -> None:
        """Serve until the LSP server is closed."""
        while True:
            try:
                conn_id, payload = await self.server.read()
            except LspError:
                return
            self.handle(conn_id, payload)

    def handle(self, conn_id: int, payload) -> None:
        """Handle ONE transport item — a payload or a conn-death
        exception."""
        if isinstance(payload, Exception):
            self._on_drop(conn_id)
            return
        try:
            msg = Message.from_json(payload)
        except ValueError:
            return
        if msg.type == MsgType.JOIN:
            self._on_join(conn_id, msg)
        elif msg.type == MsgType.REQUEST:
            self._on_request(conn_id, msg)
        elif msg.type == MsgType.RESULT:
            self._on_result(conn_id, msg)

    # ---------------------------------------------------------------- events

    def _on_request(self, conn_id: int, msg: Message) -> None:
        if self.qos.enabled:
            self.qos_plane.tenant(conn_id, self.qos.weight_for(conn_id))
        self.queue.enqueue(Request(conn_id=conn_id, data=msg.data,
                                   lower=msg.lower, upper=msg.upper,
                                   target=msg.target))
        self._maybe_dispatch()

    def _on_join(self, conn_id: int, msg: Optional[Message] = None) -> None:
        self.miner_plane.on_join(conn_id)
        self._maybe_dispatch()

    def _on_result(self, conn_id: int, msg: Message) -> None:
        popped = self.miner_plane.pop_result(conn_id)
        if popped is None:
            return
        miner, chunk = popped
        curr = self._inflight.get(chunk.job_id)
        if curr is None:
            # Stale Result of a retired request; under QoS it freed a slot.
            if self.qos.enabled:
                self._maybe_dispatch()
            return
        if curr.answered[chunk.idx]:
            self.stats["dup_results"] += 1
            if self.qos.enabled:
                self._maybe_dispatch()
            return
        if not self._claim_ok(curr, chunk, miner, msg):
            return
        if msg.hash < curr.min_hash:
            curr.min_hash = msg.hash
            curr.min_nonce = msg.nonce
        curr.answered[chunk.idx] = True
        if self.qos.enabled:
            self.qos_plane.on_chunk_answered(curr.conn_id)
        if curr.target and msg.target != curr.target and not curr.weak:
            curr.weak = True
            logger.info(
                "difficulty request %d: miner %d answered without the "
                "target extension; the merged result is guaranteed "
                "qualifying, not guaranteed globally first",
                curr.job_id, miner.conn_id)
        if curr.target and msg.hash < curr.target:
            curr.chunk_q[chunk.idx] = (msg.nonce, msg.hash)
        # Prefix release (difficulty only): the lowest-index qualifying
        # chunk is final once every earlier chunk has answered clean —
        # later chunks cover strictly higher nonces and cannot beat it.
        if curr.chunk_q:
            c = min(curr.chunk_q)
            if all(curr.answered[:c]):
                nonce, q_hash = curr.chunk_q[c]
                self._finish(curr, q_hash, nonce, early=True)
                return
        if all(curr.answered):
            # Full barrier: an arg-min request, or a target missed
            # everywhere (the exact arg-min).
            self._finish(curr, curr.min_hash, curr.min_nonce)
        elif self.qos.enabled:
            # The answering miner freed a slot: grant the next chunk.
            self._maybe_dispatch()

    def _claim_ok(self, curr: Request, chunk: Chunk, miner: MinerState,
                  msg: Message) -> bool:
        """Claim check: the nonce lies in the chunk (``Upper`` read
        inclusive), the hash equals the host recompute, and a difficulty
        claim entering the qualifying set satisfies the target bound on
        the RECOMPUTED hash (never the claimed one). A failed claim leaves
        ``answered[idx]`` False, sends the range to another eligible
        miner, or parks it, and pumps the queue: the liar's popped chunk
        freed a slot."""
        self.stats["claims_checked"] += 1
        actual = hash_op(curr.data, msg.nonce)
        if chunk.lower <= msg.nonce <= chunk.upper \
                and actual == msg.hash \
                and not (curr.target and msg.hash < curr.target
                         and not actual < curr.target):
            return True
        self.stats["claims_failed"] += 1
        logger.warning("miner %d: claim (%d, %d) for [%d, %d] failed the "
                       "check; re-running the range", miner.conn_id,
                       msg.hash, msg.nonce, chunk.lower, chunk.upper)
        copy = Chunk(chunk.job_id, chunk.data, chunk.lower, chunk.upper,
                     target=chunk.target, idx=chunk.idx)
        takeover = next((m for m in self.miner_plane.eligible()
                         if m is not miner), None)
        if takeover is not None:
            self.miner_plane.assign_chunk(takeover, copy)
        else:
            self.miner_plane.parked.append(copy)
        self._maybe_dispatch()
        return False

    def _on_drop(self, conn_id: int) -> None:
        miner = self.miner_plane.drop_miner(conn_id)
        if miner is not None:
            logger.info("miner %d dropped", conn_id)
            self.miner_plane.recover(miner)
            self._maybe_dispatch()
            return
        logger.info("client %d dropped", conn_id)
        self.queue.purge_tenant(conn_id)
        if self.qos.enabled:
            self.qos_plane.forget(conn_id)
        for req in [r for r in self._inflight.values()
                    if r.conn_id == conn_id]:
            self._retire(req)

    # --------------------------------------------------------------- dispatch

    def _finish(self, curr: Request, h: int, nonce: int,
                early: bool = False) -> None:
        """Answer the client and retire the request. ``early`` = prefix
        release: the job's other chunks are still in flight."""
        self._write(curr.conn_id, new_result(h, nonce))
        self.stats["results_sent"] += 1
        logger.info("request %d served in %.3fs: [%d, %d) over %d chunks%s%s",
                    curr.job_id, time.monotonic() - curr.started,
                    curr.lower, curr.upper, curr.num_chunks,
                    " (prefix release)" if early else "",
                    " (weak merge)" if curr.weak else "")
        self._retire(curr)

    def _retire(self, curr: Request) -> None:
        """Retire an in-flight request: its pending chunks are marked
        cancelled (their late Results pop as stale), its parked chunks
        are dropped, under QoS its tenant's granted-unanswered slots are
        released (ungranted chunks simply evaporate), and the queue is
        pumped."""
        self.miner_plane.cancel_job(curr.job_id)
        if self._inflight.pop(curr.job_id, None) is not None \
                and curr.qos_mode == "chunked":
            self._chunked_inflight -= 1
        if self.qos.enabled:
            self.qos_plane.release(
                curr.conn_id, curr.granted_chunks - sum(curr.answered))
        self._maybe_dispatch()

    def _maybe_dispatch(self) -> None:
        """Start queued work when the pool can take it: the stock FIFO
        pump or the QoS grant pump. Re-entrancy guard: an empty-range
        request finishes inside its own dispatch, and the outer pump loop
        then drains the queue iteratively."""
        if self._dispatching:
            return
        self._dispatching = True
        try:
            if self.qos.enabled:
                self._qos_pump()
            else:
                self._fifo_pump()
        finally:
            self._dispatching = False

    def _fifo_pump(self) -> None:
        """Pop the queue head whenever nothing is in flight."""
        while not self._inflight and len(self.queue):
            pool = self.miner_plane.eligible()
            if not pool:
                break
            self._load_balance(self.queue.pop_head(), pool)

    def _start(self, req: Request, mode: str) -> None:
        self._next_job_id += 1
        req.job_id = self._next_job_id
        req.qos_mode = mode
        req.started = time.monotonic()
        self._inflight[req.job_id] = req
        req.upper += 1  # inclusive -> exclusive

    def _load_balance(self, request: Request, pool: list[MinerState]) -> None:
        """Wholesale dispatch: split the range evenly over ``pool``."""
        self._start(request, "wholesale")
        num = len(pool)
        total = request.upper - request.lower
        if total <= 0:
            # Empty/inverted range: answer like an empty scan.
            self._finish(request, MAX_U64, 0)
            return
        individual = total // num
        leftover = total - individual * num
        if individual == 0:  # more miners than nonces
            individual, leftover, num = 1, 0, total
        request.num_chunks = request.granted_chunks = num
        request.answered = [False] * num
        start = request.lower
        bounds = []
        for idx in range(num):
            end = start + individual + (leftover if idx == 0 else 0)
            bounds.append((start, end))
            start = end
        if self.qos.enabled:
            # Wholesale chunks count against the tenant's share like
            # granted ones, so later contended rounds stay fair.
            for lo, up in bounds:
                self.qos_plane.on_grant(request.conn_id, up - lo)
        for idx, (lo, up) in enumerate(bounds):
            self.miner_plane.assign_chunk(pool[idx], Chunk(
                request.job_id, request.data, lo, up,
                target=request.target, idx=idx))

    # ------------------------------------------------------------ QoS plane

    @staticmethod
    def _qos_is_small(total: int, cold: bool, bound: float) -> bool:
        """THE wholesale-smallness predicate, shared by head pricing, pump
        candidacy and the dispatch decision: empty ranges and cold pools
        are small; otherwise one comparison against the hoisted bound."""
        return total <= 0 or cold or total <= bound

    def _qos_small_bound(self):
        """``(cold, bound_nonces)``: the pool is cold until a throughput
        sample exists; otherwise a request is small when it fits
        ``wholesale_s`` at the pool rate times the miners it would use."""
        mp = self.miner_plane
        rate = mp.pool_rate
        if rate is None or rate <= 0:
            return True, 0.0
        n = max(1, len(mp.eligible()) or len(mp.miners) or 1)
        return False, self.qos.wholesale_s * rate * n

    def _qos_chunk_plan(self, total: int, pool_n: int) -> tuple[int, int]:
        """``(n_chunks, first_chunk_size)`` for a chunked activation of
        ``total`` nonces: chunks of ``chunk_s`` seconds at the pool rate,
        at most ``max_chunks``; an even split over ``pool_n`` when cold.
        Shared by the activation and the DRR head cost, which must agree."""
        rate = self.miner_plane.pool_rate or 0.0
        if rate > 0:
            n = -(-total // max(1, int(rate * self.qos.chunk_s)))
        else:
            n = max(1, pool_n)
        n = max(1, min(self.qos.max_chunks, n, total))
        return n, total // n + (1 if total % n else 0)

    def _qos_heads(self) -> dict:
        """Each tenant's next grantable item: ``{tenant: (kind, request,
        cost_nonces)}``. ``"chunk"``: the next ungranted chunk of the
        tenant's oldest chunked in-flight request. ``"start"``: the
        tenant's oldest queued request (tenants serve their own requests
        FIFO), withheld while a WHOLESALE request is in flight (the stock
        one-at-a-time order) or while the tenant has a request in flight.
        Tenants at their ``max_inflight`` cap are skipped."""
        heads: dict = {}
        cap = self.qos.max_inflight
        tenants = self.qos_plane.tenants
        for req in self._inflight.values():     # oldest first
            if req.qos_mode != "chunked" or req.next_chunk >= req.num_chunks:
                continue
            t = req.conn_id
            if t in heads:
                continue
            if cap > 0 and self.qos_plane.tenant(t).inflight >= cap:
                continue
            lo, up = req.chunk_bounds[req.next_chunk]
            heads[t] = ("chunk", req, up - lo)
        if self._inflight and not self._chunked_inflight:
            return heads        # wholesale in flight: stock FIFO wait
        cold, small_bound = self._qos_small_bound()
        none_inflight = not self._inflight
        pool_n = len(self.miner_plane.miners) or 1
        busy = {r.conn_id for r in self._inflight.values()}
        for t, req in self.queue.tenant_heads():
            if t in heads or t in busy:
                continue
            st = tenants.get(t)
            if cap > 0 and st is not None and st.inflight >= cap:
                continue
            # The cost is what granting it will debit: the whole range
            # for a wholesale start, the first planned chunk for a
            # chunked one.
            total = req.upper - req.lower + 1
            if none_inflight and self._qos_is_small(total, cold,
                                                    small_bound):
                cost = max(1, total)
            else:
                _, cost = self._qos_chunk_plan(max(1, total), pool_n)
            heads[t] = ("start", req, cost)
        return heads

    def _qos_pump(self) -> None:
        """The QoS grant loop: while grantable work and capacity exist,
        pick the next tenant by DRR and execute ONE grant — a chunk, a
        chunked activation, or a stock wholesale dispatch.

        The pass carries a coalescing-window map (miner conn id ->
        ``[coalesce_id, lanes_used, {job_ids}]``): a small grant may land
        in an open window even when the capacity pool is empty (the
        window counts as one live slot however many lanes it holds),
        which is what batches several tenants' mice onto one miner in one
        pass. Windows live for ONE pass."""
        mp = self.miner_plane
        if self._inflight and not self._chunked_inflight:
            return      # wholesale in flight: no start may flow
        if not len(self.queue) and not self._chunked_inflight:
            return
        backlogged = list(dict.fromkeys(
            self.queue.backlog_tenants()
            + [r.conn_id for r in self._inflight.values()
               if r.qos_mode == "chunked" and r.next_chunk < r.num_chunks]))
        self.qos_plane.sync_backlog(backlogged)
        if not backlogged:
            return
        if not mp.capacity_pool(self.qos.depth) and \
                (self._inflight or not mp.eligible()):
            return     # saturated: nothing grantable this event
        window: dict = {}
        while True:
            heads = self._qos_heads()
            if not heads:
                break
            cap_pool = mp.capacity_pool(self.qos.depth)
            cold, small_bound = self._qos_small_bound()
            none_inflight = not self._inflight
            can_start = bool(mp.eligible())
            candidates = {}
            for t, (kind, req, cost) in heads.items():
                joinable = (mp.window_room(window, req.job_id)
                            and mp.coalescible_cost(req.target, cost))
                if kind == "start" and none_inflight and self._qos_is_small(
                        req.upper - req.lower + 1, cold, small_bound):
                    if can_start:      # wholesale: the stock eligibility
                        candidates[t] = cost
                elif cap_pool or joinable:
                    candidates[t] = cost
            if not candidates:
                break
            kind, req, cost = heads[self.qos_plane.pick(candidates)]
            if kind == "chunk":
                self._qos_grant(req, cap_pool, window)
                continue
            self.queue.dequeue(req)
            if not self._inflight and self._qos_is_small(
                    req.upper - req.lower + 1, cold, small_bound):
                self._load_balance(req, mp.eligible())
            else:
                self._qos_activate(req, cap_pool, window)

    def _qos_activate(self, req: Request, pool: list[MinerState],
                      window: dict) -> None:
        """Activate a request in CHUNKED mode: plan contiguous ascending
        chunks (:meth:`_qos_chunk_plan`, cold fallback over the whole
        pool) and grant the first; later pump turns grant the rest, so
        concurrent tenants' chunks interleave."""
        self._start(req, "chunked")
        self._chunked_inflight += 1
        total = req.upper - req.lower
        if total <= 0:
            self._finish(req, MAX_U64, 0)
            return
        n, _ = self._qos_chunk_plan(total, len(self.miner_plane.miners) or 1)
        size, rem = divmod(total, n)
        base = req.lower
        for i in range(n):
            step = size + (1 if i < rem else 0)
            req.chunk_bounds.append((base, base + step))
            base += step
        req.num_chunks = n
        req.answered = [False] * n
        self._qos_grant(req, pool, window)

    def _qos_grant(self, req: Request, pool: list[MinerState],
                   window: dict) -> None:
        """Hand the request's next planned chunk to a miner and account
        it with the DRR plane. A small chunk first joins an open window
        (sharing its coalesce id); else it goes to the least-loaded
        capacity miner and, still small, opens a window there for later
        grants of this pass. Large or difficulty chunks never touch
        windows."""
        mp = self.miner_plane
        idx = req.next_chunk
        lo, up = req.chunk_bounds[idx]
        miner = cid = None
        small = mp.coalescible_cost(req.target, up - lo)
        if small and window:
            miner, slot = mp.window_slot(window, req.job_id)
            if miner is not None:
                cid = slot[0]
                slot[1] += 1
                slot[2].add(req.job_id)
                self.stats["qos_window_grants"] += 1
        if miner is None:
            if not pool:
                return    # window gone and no capacity: next pump turn
            miner = pool[0]
            if small and miner.conn_id not in window:
                cid = mp.open_window(window, miner, req.job_id)
        req.next_chunk += 1
        req.granted_chunks += 1
        self.stats["qos_grants"] += 1
        self.qos_plane.on_grant(req.conn_id, up - lo)
        mp.assign_chunk(miner, Chunk(req.job_id, req.data, lo, up,
                                     target=req.target, idx=idx,
                                     coalesce_id=cid))

    # ---------------------------------------------------------------- helpers

    def _write(self, conn_id: int, msg: Message) -> None:
        try:
            self.server.write(conn_id, msg.to_json())
        except LspError:
            # The drop event for this connection is already in flight; the
            # drop handler will repair the assignment.
            logger.info("write to %d failed; awaiting drop event", conn_id)
