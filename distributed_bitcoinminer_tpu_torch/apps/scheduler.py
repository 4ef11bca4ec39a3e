"""The scheduler: shard nonce ranges over an elastic miner pool, merge argmins.

The stock path of the JAX package's ``apps/scheduler.py``
(itself the state machine of the reference coordinator, ref: bitcoin/
server/server.go:19-403), written lean, with the reference's method
names:

- FIFO request queue, ONE request in flight at a time.
- ``_load_balance``: bounds become exclusive (``upper += 1``); even split
  ``total // num_miners`` with the remainder given to the FIRST miner; when
  there are more miners than nonces, only ``total`` miners get 1-nonce chunks
  (ref: server.go:165-205).
- Bound quirk preserved for bit parity: chunks are sent with EXCLUSIVE upper
  bounds but the miner treats ``Upper`` as inclusive (ref: miner.go:51-52),
  so each chunk scans one extra nonce and the system as a whole scans
  ``[0, maxNonce+1]``.
- Claim check: every Result is a claim; its hash is recomputed on the
  host with ``hash_op`` and its nonce must lie in the chunk. A failed
  claim is not merged and its range runs again on another miner.
- Result merge: strict ``<`` on the uint64 hash; the barrier releases the
  Result to the client when every chunk of the request has been answered
  (ref: server.go:257-325).
- Miner drop: its unanswered chunks go to available miners, else they
  park; a parked chunk is re-issued when a miner joins or frees up
  (ref: server.go:326-376, 222-244, 285-304).
- Client drop: its queued requests are purged and its in-flight request
  is cancelled at once — miners are freed, parked chunks cleared, the
  next queued request starts.

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

Bookkeeping: every Request written to a miner pushes a chunk record onto
that miner's pending FIFO; since miners answer in order over exactly-once
LSP, each arriving Result pops exactly the chunk it answers, so stale
Results are identified precisely and a dead miner's unanswered chunks are
recovered one by one.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..bitcoin.hash import MAX_U64, hash_op
from ..bitcoin.message import Message, MsgType, new_request, new_result
from ..lsp.errors import LspError
from ..lsp.server import AsyncServer

logger = logging.getLogger("dbmt.scheduler")


@dataclass
class Chunk:
    job_id: int
    data: str
    lower: int
    upper: int              # exclusive end, as sent on the wire
    target: int = 0
    idx: int = 0            # position in the request's ascending chunk order
    # Set when the request retires: the chunk stays in the miner's pending
    # FIFO (its Result must still pop in order) but no longer counts
    # against the miner's availability.
    cancelled: bool = False


@dataclass
class MinerState:
    conn_id: int
    pending: list = field(default_factory=list)

    @property
    def available(self) -> bool:
        """A miner is available iff it has no live pending chunk."""
        return not any(not c.cancelled for c in self.pending)


@dataclass
class Request:
    conn_id: int
    data: str
    lower: int
    upper: int              # inclusive on arrival; +1 at load_balance
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


class Scheduler:
    """Single-actor scheduler over an :class:`AsyncServer`."""

    def __init__(self, server: AsyncServer):
        self.server = server
        self.miners: list[MinerState] = []      # join order
        self._by_conn: dict[int, MinerState] = {}
        self.queue: deque[Request] = deque()
        self.current: Optional[Request] = None  # the one request in flight
        self.parked: list[Chunk] = []           # chunks of dropped miners
        self._next_job_id = 0
        self._dispatching = False
        self.stats = {"results_sent": 0, "dup_results": 0,
                      "claims_checked": 0, "claims_failed": 0}

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
        self.queue.append(Request(conn_id=conn_id, data=msg.data,
                                  lower=msg.lower, upper=msg.upper,
                                  target=msg.target))
        self._maybe_dispatch()

    def _on_join(self, conn_id: int, msg: Optional[Message] = None) -> None:
        """A joining miner immediately absorbs one parked chunk, if any
        (ref: server.go:222-244)."""
        miner = MinerState(conn_id=conn_id)
        chunk = self._next_parked()
        if chunk is not None:
            self._assign_chunk(miner, chunk)
        self.miners.append(miner)
        self._by_conn[conn_id] = miner
        self._maybe_dispatch()

    def _on_result(self, conn_id: int, msg: Message) -> None:
        miner = self._by_conn.get(conn_id)
        if miner is None or not miner.pending:
            return
        chunk = miner.pending.pop(0)   # the Result answers the oldest Request
        # A freed miner absorbs one parked chunk (ref: server.go:285-304),
        # before the stale check so a stale answer still frees it; the
        # chunk this Result answers is not handed back.
        if self.parked and miner.available:
            parked = self._next_parked(skip_key=(chunk.job_id, chunk.idx))
            if parked is not None:
                self._assign_chunk(miner, parked)
        curr = self.current
        if curr is None or curr.job_id != chunk.job_id or chunk.cancelled:
            return  # stale Result for a cancelled/finished request
        if curr.answered[chunk.idx]:
            self.stats["dup_results"] += 1
            return
        if not self._claim_ok(curr, chunk, miner, msg):
            return
        if msg.hash < curr.min_hash:
            curr.min_hash = msg.hash
            curr.min_nonce = msg.nonce
        curr.answered[chunk.idx] = True
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

    def _claim_ok(self, curr: Request, chunk: Chunk, miner: MinerState,
                  msg: Message) -> bool:
        """Claim check: the nonce lies in the chunk (``Upper`` read
        inclusive), the hash equals the host recompute, and a difficulty
        claim entering the qualifying set satisfies the target bound on
        the RECOMPUTED hash (never the claimed one). A failed claim leaves
        ``answered[idx]`` False and sends the range to another eligible
        miner, or parks it."""
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
        takeover = next((m for m in self._eligible() if m is not miner),
                        None)
        if takeover is not None:
            self._assign_chunk(takeover, copy)
        else:
            self.parked.append(copy)
        return False

    def _on_drop(self, conn_id: int) -> None:
        miner = self._by_conn.pop(conn_id, None)
        if miner is not None:
            logger.info("miner %d dropped", conn_id)
            self.miners.remove(miner)
            self._recover(miner)
            self._maybe_dispatch()
            return
        logger.info("client %d dropped", conn_id)
        self.queue = deque(r for r in self.queue if r.conn_id != conn_id)
        if self.current is not None and self.current.conn_id == conn_id:
            self._retire(self.current)

    def _recover(self, miner: MinerState) -> None:
        """Hand every unanswered chunk of a dropped miner to an available
        miner, else park it."""
        curr = self.current
        for chunk in miner.pending:
            if curr is None or chunk.cancelled or chunk.job_id != curr.job_id \
                    or curr.answered[chunk.idx]:
                continue
            takeover = next(iter(self._eligible()), None)
            if takeover is not None:
                self._assign_chunk(takeover, chunk)
            else:
                self.parked.append(chunk)

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
        """Retire the in-flight request: its pending chunks are marked
        cancelled (their late Results pop as stale), its parked chunks
        are dropped, and the queue is pumped."""
        for m in self.miners:
            for c in m.pending:
                if c.job_id == curr.job_id:
                    c.cancelled = True
        self.parked = [c for c in self.parked if c.job_id != curr.job_id]
        if self.current is curr:
            self.current = None
        self._maybe_dispatch()

    def _maybe_dispatch(self) -> None:
        """Start queued work when the pool can take it. Re-entrancy guard:
        an empty-range request finishes inside its own dispatch, and the
        outer pump loop then drains the queue iteratively."""
        if self._dispatching:
            return
        self._dispatching = True
        try:
            self._fifo_pump()
        finally:
            self._dispatching = False

    def _fifo_pump(self) -> None:
        """Pop the queue head whenever nothing is in flight."""
        while self.current is None and self.queue:
            pool = self._eligible()
            if not pool:
                break
            self._load_balance(self.queue.popleft(), pool)

    def _load_balance(self, request: Request, pool: list[MinerState]) -> None:
        """Split the range evenly over ``pool``."""
        self._next_job_id += 1
        request.job_id = self._next_job_id
        request.started = time.monotonic()
        self.current = request
        num = len(pool)
        request.upper += 1  # inclusive -> exclusive
        total = request.upper - request.lower
        if total <= 0:
            # Empty/inverted range: answer like an empty scan.
            self._finish(request, MAX_U64, 0)
            return
        individual = total // num
        leftover = total - individual * num
        if individual == 0:  # more miners than nonces
            individual, leftover, num = 1, 0, total
        request.num_chunks = num
        request.answered = [False] * num
        start = request.lower
        for idx in range(num):
            end = start + individual + (leftover if idx == 0 else 0)
            self._assign_chunk(pool[idx], Chunk(
                request.job_id, request.data, start, end,
                target=request.target, idx=idx))
            start = end

    # ---------------------------------------------------------------- helpers

    def _eligible(self) -> list[MinerState]:
        return [m for m in self.miners if m.available]

    def _next_parked(self, skip_key=None) -> Optional[Chunk]:
        """Pop the next parked chunk that still needs executing."""
        while self.parked:
            chunk = self.parked.pop(0)
            curr = self.current
            if curr is None or curr.job_id != chunk.job_id \
                    or curr.answered[chunk.idx] \
                    or (chunk.job_id, chunk.idx) == skip_key:
                continue
            return chunk
        return None

    def _assign_chunk(self, miner: MinerState, chunk: Chunk) -> None:
        chunk.cancelled = False
        miner.pending.append(chunk)
        self._write(miner.conn_id, new_request(chunk.data, chunk.lower,
                                               chunk.upper, chunk.target))

    def _write(self, conn_id: int, msg: Message) -> None:
        try:
            self.server.write(conn_id, msg.to_json())
        except LspError:
            # The drop event for this connection is already in flight; the
            # drop handler will repair the assignment.
            logger.info("write to %d failed; awaiting drop event", conn_id)
