"""Miner plane: the pool roster, pending FIFOs, throughput and windows.

Counterpart of the JAX package's ``apps/miner_plane.py``, without leases,
striping, trust and quarantine. It owns everything miner-facing:

- the roster (join order) and each miner's pending FIFO: every Request
  written to a miner pushes a chunk record, and since miners answer in
  order over exactly-once LSP, each Result pops exactly the chunk it
  answers (:meth:`MinerPlane.pop_result`);
- parked chunks of dropped miners, absorbed by a joining or freed miner
  (ref: server.go:222-244, 285-304, 326-376);
- the pool's throughput EWMA, sampled over a wall-clock window per miner
  (:meth:`MinerPlane.observe_result`), which sizes QoS chunks;
- the QoS capacity pool, and the coalescing windows: small argmin chunks
  of different requests granted to one miner in one pump pass share a
  ``coalesce_id``, count as ONE live chunk against the QoS depth, and may
  share one device launch on that miner.

The scheduler decides who gets what; this plane executes the grant
(:meth:`MinerPlane.assign_chunk`) and never touches merge state.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..bitcoin.message import new_request
from ..utils.config import CoalesceParams


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
    # Chunks sharing a coalesce_id were granted into one miner's
    # coalescing window: they may share a launch and count as ONE live
    # chunk (miner_live). None = stock accounting.
    coalesce_id: Optional[int] = None
    # When the miner started on it: stamped at assignment, again when the
    # chunk reaches the head of its miner's FIFO.
    assigned_at: float = 0.0
    started: bool = False

    @property
    def size(self) -> int:
        """Nonces the miner scans (``Upper`` read inclusive)."""
        return self.upper - self.lower + 1


@dataclass
class MinerState:
    conn_id: int
    pending: list = field(default_factory=list)
    # The wall-clock window accumulating answered nonces (observe_result).
    win_t0: float = 0.0
    win_nonces: int = 0

    @property
    def available(self) -> bool:
        """A miner is available iff it has no live pending chunk."""
        return not any(not c.cancelled for c in self.pending)


class MinerPlane:
    """The miner-facing half of the scheduler.

    ``write(conn_id, msg)`` is the scheduler's wire write; ``inflight``
    its live ``{job_id: Request}`` map (read here: recovery and the
    parked queue skip retired jobs and answered chunks).
    """

    #: Wall-clock span one throughput sample must cover: the pipelined
    #: miner answers a prefetched chunk milliseconds after the previous
    #: one, so per-chunk size/elapsed samples would read far too high.
    RATE_WINDOW_S = 0.5
    #: Weight of the newest sample in the pool's rate EWMA.
    EWMA_ALPHA = 0.3

    def __init__(self, coalesce: CoalesceParams, *, write: Callable,
                 inflight: dict):
        self.coalesce = coalesce
        self._write = write
        self._inflight = inflight
        self.miners: list[MinerState] = []      # join order
        self._by_conn: dict[int, MinerState] = {}
        self.parked: list[Chunk] = []           # chunks of dropped miners
        self.pool_rate: Optional[float] = None  # pool throughput EWMA
        self._next_coalesce_id = 0

    # ------------------------------------------------------------- roster

    def find_miner(self, conn_id: int) -> Optional[MinerState]:
        return self._by_conn.get(conn_id)

    def on_join(self, conn_id: int) -> MinerState:
        """A joining miner immediately absorbs one parked chunk, if any."""
        miner = MinerState(conn_id=conn_id)
        chunk = self.next_parked()
        if chunk is not None:
            self.assign_chunk(miner, chunk)
        self.miners.append(miner)
        self._by_conn[conn_id] = miner
        return miner

    def drop_miner(self, conn_id: int) -> Optional[MinerState]:
        miner = self._by_conn.pop(conn_id, None)
        if miner is not None:
            self.miners.remove(miner)
        return miner

    def recover(self, miner: MinerState) -> None:
        """Hand every unanswered chunk of a dropped miner to an eligible
        miner, else park it."""
        for chunk in miner.pending:
            req = self._inflight.get(chunk.job_id)
            if req is None or chunk.cancelled or req.answered[chunk.idx]:
                continue
            takeover = next(iter(self.eligible()), None)
            if takeover is not None:
                self.assign_chunk(takeover, chunk)
            else:
                self.parked.append(chunk)

    def next_parked(self, skip_key=None) -> Optional[Chunk]:
        """Pop the next parked chunk that still needs executing; one of a
        retired job, an answered chunk, or ``(job_id, idx) == skip_key``
        (the assignment being answered right now) is dropped."""
        while self.parked:
            chunk = self.parked.pop(0)
            req = self._inflight.get(chunk.job_id)
            if req is None or req.answered[chunk.idx] \
                    or (chunk.job_id, chunk.idx) == skip_key:
                continue
            return chunk
        return None

    def eligible(self) -> list[MinerState]:
        return [m for m in self.miners if m.available]

    def cancel_job(self, job_id: int) -> None:
        """Mark a retiring job's pending chunks cancelled (late Results
        pop as stale) and drop its parked chunks."""
        for m in self.miners:
            for c in m.pending:
                if c.job_id == job_id:
                    c.cancelled = True
        self.parked = [c for c in self.parked if c.job_id != job_id]

    # ---------------------------------------------------- QoS capacity

    def miner_live(self, miner: MinerState) -> int:
        """Live chunks in a miner's FIFO, a coalescing window's chunks
        counting as one (they share one launch on the miner)."""
        n = 0
        groups = set()
        for c in miner.pending:
            if c.cancelled:
                continue
            if c.coalesce_id is None:
                n += 1
            else:
                groups.add(c.coalesce_id)
        return n + len(groups)

    def capacity_pool(self, depth: int) -> list[MinerState]:
        """Miners below the per-miner live-chunk cap, least loaded first
        (ties keep join order)."""
        pool = [m for m in self.miners if self.miner_live(m) < depth]
        pool.sort(key=self.miner_live)
        return pool

    def coalescible_cost(self, target: int, cost: int) -> bool:
        """May a grant of ``cost`` nonces enter a coalescing window?
        Argmin chunks only, at most ``max_nonces``, and on a warm pool
        at most ``small_s`` seconds of work."""
        if not self.coalesce.enabled or target \
                or cost > self.coalesce.max_nonces:
            return False
        rate = self.pool_rate
        if rate is not None and rate > 0:
            return cost <= rate * self.coalesce.small_s
        return True

    def window_slot(self, window: dict, job_id: int):
        """The first open window with a free lane that does not already
        hold ``job_id`` (windows batch ACROSS requests): ``(miner,
        slot)``, or ``(None, None)``. ``window`` maps a miner's conn id
        to ``[coalesce_id, lanes_used, {job_ids}]`` for one pump pass."""
        for conn_id, slot in window.items():
            if slot[1] >= self.coalesce.lanes or job_id in slot[2]:
                continue
            m = self.find_miner(conn_id)
            if m is not None:
                return m, slot
        return None, None

    def window_room(self, window: dict, job_id: int = 0) -> bool:
        return bool(window) and self.window_slot(window, job_id)[0] is not None

    def open_window(self, window: dict, miner: MinerState,
                    job_id: int) -> int:
        """Open a window on ``miner`` for this pump pass; returns its
        coalesce id."""
        self._next_coalesce_id += 1
        window[miner.conn_id] = [self._next_coalesce_id, 1, {job_id}]
        return self._next_coalesce_id

    # --------------------------------------------------- grant / complete

    def assign_chunk(self, miner: MinerState, chunk: Chunk) -> None:
        """One chunk onto one miner's FIFO, and its Request on the wire."""
        chunk.cancelled = False
        chunk.assigned_at = time.monotonic()
        chunk.started = not miner.pending
        miner.pending.append(chunk)
        self._write(miner.conn_id, new_request(chunk.data, chunk.lower,
                                               chunk.upper, chunk.target))

    def pop_result(self, conn_id: int):
        """An arriving Result pops the miner's oldest pending chunk, feeds
        the throughput window, and a freed miner absorbs one parked chunk
        (before the scheduler's stale check, so a stale answer still
        frees it; the chunk this Result answers is not handed back).
        Returns ``(miner, chunk)``, or None."""
        miner = self.find_miner(conn_id)
        if miner is None or not miner.pending:
            return None
        chunk = miner.pending.pop(0)
        self.observe_result(miner, chunk)
        if miner.pending and not miner.pending[0].started:
            miner.pending[0].assigned_at = time.monotonic()
            miner.pending[0].started = True
        if self.parked and miner.available:
            parked = self.next_parked(skip_key=(chunk.job_id, chunk.idx))
            if parked is not None:
                self.assign_chunk(miner, parked)
        return miner, chunk

    def observe_result(self, miner: MinerState, chunk: Chunk) -> None:
        """Throughput sampling over a wall-clock window per miner:
        answered nonces accumulate until ``RATE_WINDOW_S`` has passed
        since the window opened (at the first chunk's start), then one
        sample feeds the pool's EWMA. A difficulty chunk (its early exit
        scans an unknown part of the range) resets the window instead."""
        now = time.monotonic()
        if chunk.target:
            miner.win_t0, miner.win_nonces = 0.0, 0
            return
        if miner.win_nonces == 0 \
                or now - miner.win_t0 > 4 * self.RATE_WINDOW_S:
            # A fresh window, or a stale one (an idle gap must not
            # deflate the sample), opened at this chunk's start.
            miner.win_t0, miner.win_nonces = chunk.assigned_at or now, 0
        miner.win_nonces += chunk.size
        elapsed = now - miner.win_t0
        if elapsed >= self.RATE_WINDOW_S:
            rate = miner.win_nonces / elapsed
            miner.win_t0, miner.win_nonces = now, 0
            a = self.EWMA_ALPHA
            self.pool_rate = rate if self.pool_rate is None else \
                a * rate + (1 - a) * self.pool_rate
