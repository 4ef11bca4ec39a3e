"""Miner plane: the pool roster, pending FIFOs, leases, trust and windows.

Counterpart of the JAX package's ``apps/miner_plane.py``, metric series
included. It owns everything miner-facing:

- the roster (join order) and each miner's pending FIFO: every Request
  written to a miner pushes a chunk record, and since miners answer in
  order over exactly-once LSP, each Result pops exactly the chunk it
  answers (:meth:`MinerPlane.pop_result`);
- the lease plane: every assignment carries a deadline sized from the
  miner's throughput EWMA (else the pool's, else a flat grace); a sweep
  (:meth:`MinerPlane.check_leases`) blows expired leases and re-issues
  each blown chunk once to another eligible miner (the first Result
  wins, the other pops as a duplicate), and ``quarantine_after``
  consecutive blown leases bar a miner from new work until it answers
  again. A chunk assigned behind others gets a deadline that budgets
  them too, tightened when it reaches the head of the FIFO. A miner
  whose card hangs inside a kernel keeps its connection alive, so this
  is what moves its chunks;
- trust (the verification tier's half): a score per miner, decayed by
  the scheduler's claim checks and audits (:meth:`MinerPlane.trust_fail`)
  and stepped back by each answer; below the bar a miner gets no new
  grants, like a quarantined one, and takes no audits;
- the desperation pool: when every miner is quarantined or distrusted,
  the least-bad available one still serves;
- parked chunks of dropped miners, absorbed by a joining or freed miner
  (ref: server.go:222-244, 285-304, 326-376);
- the throughput EWMAs, per miner and for the pool, sampled over a
  wall-clock window per miner (:meth:`MinerPlane.observe_result`), which
  size leases, stripes and QoS chunks; a miner may JOIN with a rate
  hint (:meth:`MinerPlane.on_join`), which seeds its EWMA (and an empty
  pool's) as a claim: decayed each sweep, replaced outright by the first
  measured window, discarded on the first failed claim or audit;
- the stripe planner (:meth:`MinerPlane.stripe_chunks`): a miner's share
  of a wholesale request in chunks of ``chunk_s`` seconds at its rate,
  weighted by its trust, at most ``depth``;
- the QoS capacity pool, and the coalescing windows: small argmin chunks
  of different requests granted to one miner in one pump pass share a
  ``coalesce_id``, count as ONE live chunk against the QoS depth, and may
  share one device launch on that miner.

The scheduler decides who gets what; this plane executes the grant
(:meth:`MinerPlane.assign_chunk`), reports every lease transition through
the ``lease_event`` callback, and never touches merge state.

Its series, in the scheduler's registry (mounted under ``sched.``), at the
JAX package's moments: ``pool_size`` and ``pool_quarantined`` on every
roster or quarantine change; ``lease_remaining_s{miner}`` (each miner's
nearest live deadline) and ``lease_min_remaining_s`` after every lease
sweep, cleared when no request is in flight; the ``lease_wait_s``
histogram (a chunk's wait in its miner's FIFO, observed when its lease
starts) and ``stripe_chunks_per_share`` (the chunks of one miner's share
of a striped plan); ``miner_rate_nps{miner}`` and ``pool_rate_nps``
wherever a rate moves (a hinted JOIN, a hint refresh, a measured window,
the sweep's decay); ``miner_trust{miner}`` wherever a trust score moves;
``adapt_chunk_s_miner{miner}`` with each per-miner stripe seconds. A
dropped miner's labelled series retire with it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..bitcoin.message import new_request
from ..utils import trace as _tracing
from ..utils.config import (CoalesceParams, LeaseParams, StripeParams,
                            VerifyParams)
from ..utils.metrics import LATENCY_BUCKETS_S, OCCUPANCY_BUCKETS, Registry


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
    # Lease plane. Each FIFO entry is one assignment: a re-issue pushes a
    # fresh Chunk (same job, idx and range) onto the takeover miner's
    # FIFO, while the blown original stays in its miner's FIFO.
    assigned_at: float = 0.0   # reset when the lease starts
    deadline: float = 0.0
    # False until the chunk reaches the head of its miner's FIFO (with
    # fifo_aware); until then the deadline budgets the chunks ahead too.
    lease_started: bool = False
    lease_blown: bool = False  # expiry seen (counted once per entry)
    reissued: bool = False     # a copy is already in flight elsewhere
    # Chunks sharing a coalesce_id were granted into one miner's
    # coalescing window: they may share a launch and count as ONE live
    # chunk (miner_live). None = stock accounting; a re-issued copy never
    # inherits it.
    coalesce_id: Optional[int] = None

    @property
    def size(self) -> int:
        """Nonces the miner scans (``Upper`` read inclusive)."""
        return self.upper - self.lower + 1


@dataclass
class MinerState:
    conn_id: int
    pending: list = field(default_factory=list)
    # Observed throughput (nonces/s EWMA; None until a window closes),
    # consecutive blown leases, and the quarantine latch (set at
    # quarantine_after blown leases, cleared by the miner's next answer).
    rate_ewma: Optional[float] = None
    blown_streak: int = 0
    quarantined: bool = False
    # True while rate_ewma holds the miner's own JOIN hint, not a measured
    # sample: the first measured window replaces it.
    rate_hinted: bool = False
    # In [trust_floor, 1.0]: decays per claim or audit failure, steps back
    # per answer; stays 1.0 for a miner that never lies.
    trust: float = 1.0
    # The wall-clock window accumulating answered nonces (observe_result).
    win_t0: float = 0.0
    win_nonces: int = 0

    @property
    def available(self) -> bool:
        """A miner is available iff it has no live pending chunk."""
        return not any(not c.cancelled for c in self.pending)


class MinerPlane:
    """The miner-facing half of the scheduler.

    ``metrics`` is the scheduler's registry, which the plane's series go
    into. Callbacks, the scheduler's: ``write(conn_id, msg)`` its wire write;
    ``inflight`` its live ``{job_id: Request}`` map (read here: the sweep
    and recovery skip retired jobs and answered chunks);
    ``lease_event(kind, chunk, miner_conn, **info)`` the log of every
    lease transition (``blown``, ``reissue``, ``quarantine``,
    ``quarantine_lifted``, ``park``); ``dispatch()`` its pump (a lifted
    quarantine frees a miner mid-pop); ``count(name)`` its counters;
    ``trace_get(job_id)`` the request trace an assignment is recorded on
    (None when the job has none); ``trace_on`` arms the flight events.
    ``chunk_s_overrides`` holds the adapt plane's per-miner stripe
    seconds (``DBMT_ADAPT_PER_MINER``), read by :meth:`stripe_chunks`.
    """

    #: Wall-clock span one throughput sample must cover: the pipelined
    #: miner answers a prefetched chunk milliseconds after the previous
    #: one, so per-chunk size/elapsed samples would read far too high.
    RATE_WINDOW_S = 0.5
    #: The rate-hint JOIN's bounds: a hint is clamped to the cap, and
    #: until a measured window confirms it, decays by this factor a sweep.
    RATE_HINT_CAP = 1e12
    RATE_HINT_DECAY = 0.98

    def __init__(self, metrics: Registry, lease: LeaseParams,
                 coalesce: CoalesceParams, *, write: Callable,
                 inflight: dict, lease_event: Callable, dispatch: Callable,
                 count: Callable, stripe: StripeParams,
                 verify: Optional[VerifyParams] = None,
                 trace_get: Callable = lambda job_id: None,
                 trace_on: bool = False):
        self.metrics = metrics
        self.lease = lease
        self.coalesce = coalesce
        self.stripe = stripe
        self.verify = verify if verify is not None else VerifyParams()
        self._write = write
        self._inflight = inflight
        self._lease_event = lease_event
        self._dispatch = dispatch
        self._count = count
        self._trace_get = trace_get
        self._trace_on = trace_on
        self.miners: list[MinerState] = []      # join order
        self._by_conn: dict[int, MinerState] = {}
        self.parked: list[Chunk] = []           # chunks of dropped miners
        self.pool_rate: Optional[float] = None  # pool throughput EWMA
        # True while pool_rate holds only a JOIN hint.
        self._pool_hinted = False
        self._next_coalesce_id = 0
        # Per-miner stripe seconds from the adapt plane; retired on drop.
        self.chunk_s_overrides: dict[int, float] = {}
        self._pool_size = metrics.gauge("pool_size")
        self._pool_quarantined = metrics.gauge("pool_quarantined")
        self._lease_min_remaining = metrics.gauge("lease_min_remaining_s")
        self._lease_wait = metrics.histogram("lease_wait_s",
                                             LATENCY_BUCKETS_S)
        # Stripe plans: the chunks each miner's share was cut into.
        self._stripe_depth = metrics.histogram("stripe_chunks_per_share",
                                               OCCUPANCY_BUCKETS)

    def _set_rate(self, miner: MinerState) -> None:
        self.metrics.gauge("miner_rate_nps",
                           miner=str(miner.conn_id)).set(miner.rate_ewma)

    def _set_trust(self, miner: MinerState) -> None:
        self.metrics.gauge("miner_trust",
                           miner=str(miner.conn_id)).set(miner.trust)

    # ------------------------------------------------------------- roster

    def update_pool_gauges(self) -> None:
        self._pool_size.set(len(self.miners))
        self._pool_quarantined.set(
            sum(1 for m in self.miners if m.quarantined))

    def find_miner(self, conn_id: int) -> Optional[MinerState]:
        return self._by_conn.get(conn_id)

    def on_join(self, conn_id: int, rate_hint: float = 0.0) -> MinerState:
        """A joining miner immediately absorbs one parked chunk, if any.
        ``rate_hint`` (nonces/s; 0 = none) seeds its rate EWMA at
        ``min(hint, RATE_HINT_CAP) * trust``, flagged as a claim, and an
        empty pool's rate with it (a warm pool's is measured and
        outranks claims); seeded before the parked chunk, so that chunk's
        lease is sized from it."""
        miner = MinerState(conn_id=conn_id)
        if rate_hint > 0:
            miner.rate_ewma = min(float(rate_hint),
                                  self.RATE_HINT_CAP) * miner.trust
            miner.rate_hinted = True
            self._set_rate(miner)
            if self.pool_rate is None:
                self.pool_rate = miner.rate_ewma
                self._pool_hinted = True
                self.metrics.gauge("pool_rate_nps").set(self.pool_rate)
        chunk = self.next_parked()
        if chunk is not None:
            self.assign_chunk(miner, chunk, kind="parked")
        self.miners.append(miner)
        self._by_conn[conn_id] = miner
        self.update_pool_gauges()
        return miner

    def refresh_rate_hint(self, miner: MinerState, rate_hint: float) -> None:
        """A repeat JOIN's rate hint (a GatewayMiner re-sends its JOIN as
        its inner pool's sum moves): update ``miner`` in place, seeded as
        :meth:`on_join` seeds (clamped to ``RATE_HINT_CAP``, times the
        miner's trust). A hint-only EWMA is replaced; a MEASURED one
        outranks the claim unless they diverge at least 2x either way (the
        pool behind the gateway changed shape faster than the EWMA
        follows), and then the hint re-seeds it, flagged as a claim
        again. A hint of 0 or less changes nothing."""
        if rate_hint <= 0:
            return
        hinted = min(float(rate_hint), self.RATE_HINT_CAP) * miner.trust
        if miner.rate_ewma is not None and not miner.rate_hinted \
                and miner.rate_ewma * 0.5 < hinted < miner.rate_ewma * 2.0:
            return
        miner.rate_ewma = hinted
        miner.rate_hinted = True
        self._set_rate(miner)
        self._count("rate_hints_refreshed")

    def adopt_miner(self, conn_id: int, pending: Optional[list] = None,
                    rate_ewma: Optional[float] = None) -> MinerState:
        """The replica tier's takeover: adopt a miner that a dead replica
        owned. Its pending chunk records arrive marked cancelled (it
        answers them in order and each pops here as stale, so the k-th
        Result still answers the k-th Request), and its throughput EWMA
        comes with it. New chunks queue behind the dead ones."""
        miner = MinerState(conn_id=conn_id, rate_ewma=rate_ewma)
        for chunk in pending or []:
            chunk.cancelled = True
            miner.pending.append(chunk)
        self.miners.append(miner)
        self._by_conn[conn_id] = miner
        self.update_pool_gauges()
        return miner

    def drop_miner(self, conn_id: int) -> Optional[MinerState]:
        """Remove a dropped miner and retire its labelled series (a dead
        conn id's values must not linger, and reconnect churn, a fresh
        conn id a rejoin, must not exhaust a family's series bound); the
        scheduler recovers its chunks (:meth:`recover`)."""
        miner = self._by_conn.pop(conn_id, None)
        if miner is None:
            return None
        self.miners.remove(miner)
        self.chunk_s_overrides.pop(conn_id, None)
        self.update_pool_gauges()
        self.metrics.remove("miner_rate_nps", miner=str(conn_id))
        self.metrics.remove("lease_remaining_s", miner=str(conn_id))
        self.metrics.remove("adapt_chunk_s_miner", miner=str(conn_id))
        self.metrics.remove("miner_trust", miner=str(conn_id))
        return miner

    def recover(self, miner: MinerState) -> None:
        """Hand every unanswered chunk of a dropped miner to an eligible
        miner, else park it. A chunk already answered by its re-issued
        copy, or with a copy in flight, needs no recovery."""
        for chunk in miner.pending:
            req = self._inflight.get(chunk.job_id)
            if req is None or chunk.cancelled:
                continue
            if req.answered[chunk.idx] or chunk.reissued:
                continue
            takeover = next(iter(self.eligible()), None)
            if takeover is not None:
                self.assign_chunk(takeover, chunk, kind="recovered")
            else:
                self.parked.append(chunk)
                self._lease_event("park", chunk, miner.conn_id)

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

    def distrusted(self, miner: MinerState) -> bool:
        """Below the trust bar: no new grants, no audits."""
        return miner.trust < self.verify.trust_bar

    def eligible(self) -> list[MinerState]:
        """Miners that may take new work: available, not quarantined, not
        distrusted."""
        return [m for m in self.miners
                if m.available and not m.quarantined
                and not self.distrusted(m)]

    def desperation_pool(self) -> list[MinerState]:
        """When EVERY miner is quarantined or distrusted: the least-bad
        available one (lowest blown streak, then highest trust, then
        highest throughput), else nothing. One healthy miner, even a busy
        one, disables it: waiting for it beats feeding a bad one."""
        if not self.lease.desperation or not self.miners:
            return []
        if not all(m.quarantined or self.distrusted(m)
                   for m in self.miners):
            return []
        avail = [m for m in self.miners if m.available]
        if not avail:
            return []
        return [min(avail, key=lambda m: (m.blown_streak, -m.trust,
                                          -(m.rate_ewma or 0.0)))]

    def pick_auditor(self, *exclude: int) -> Optional[MinerState]:
        """Any trusted, unquarantined miner other than the excluded conn
        ids, busy or not (an audit queues behind its chunks): the least
        loaded, ties in join order."""
        cands = [m for m in self.miners
                 if m.conn_id not in exclude
                 and not m.quarantined and not self.distrusted(m)]
        if not cands:
            return None
        return min(cands, key=self.miner_live)

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
        """Miners below the per-miner live-chunk cap, neither quarantined
        nor distrusted, and not sitting on a blown lease (a chunk granted
        behind a wedged one would wait a whole lease), least loaded first
        (ties keep join order)."""
        pool = [m for m in self.miners
                if not m.quarantined and not self.distrusted(m)
                and self.miner_live(m) < depth
                and not any(c.lease_blown and not c.cancelled
                            for c in m.pending)]
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
        hold ``job_id`` (windows batch ACROSS requests), on a live
        unquarantined miner: ``(miner, slot)``, or ``(None, None)``.
        ``window`` maps a miner's conn id to ``[coalesce_id, lanes_used,
        {job_ids}]`` for one pump pass."""
        for conn_id, slot in window.items():
            if slot[1] >= self.coalesce.lanes or job_id in slot[2]:
                continue
            m = self.find_miner(conn_id)
            if m is not None and not m.quarantined:
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

    def assign_chunk(self, miner: MinerState, chunk: Chunk,
                     kind: str = "initial") -> None:
        """One chunk onto one miner's FIFO, its lease stamped, and its
        Request on the wire. At the head of the FIFO (or with
        ``fifo_aware`` off) the lease starts now; behind other chunks the
        deadline is the latest one ahead plus this chunk's own lease, and
        is tightened when the chunk reaches the head (:meth:`pop_result`).
        The request's trace records an ``assign`` event of ``kind``
        (``initial``, ``qos``, ``parked``, ``recovered``, ``reissue``,
        ``claim_retry``, ``audit``)."""
        chunk.assigned_at = time.monotonic()
        chunk.lease_blown = False
        chunk.reissued = False
        chunk.lease_started = False
        chunk.deadline = 0.0
        miner.pending.append(chunk)
        if not self.lease.fifo_aware or len(miner.pending) == 1:
            self.start_lease(miner, chunk)
        else:
            now = chunk.assigned_at
            ahead = max((c.deadline for c in miner.pending[:-1]),
                        default=now)
            chunk.deadline = max(now, ahead) + self.lease_for(miner, chunk)
        trace = self._trace_get(chunk.job_id)
        if trace is not None:
            trace.event("assign", miner=miner.conn_id, idx=chunk.idx,
                        lower=chunk.lower, upper=chunk.upper, kind=kind,
                        fifo_pos=len(miner.pending) - 1,
                        lease_started=chunk.lease_started)
        if self._trace_on:
            _tracing.flight("assign", job=chunk.job_id, idx=chunk.idx,
                            miner=miner.conn_id, kind=kind)
        self._write(miner.conn_id, new_request(chunk.data, chunk.lower,
                                               chunk.upper, chunk.target))

    def pop_result(self, conn_id: int):
        """An arriving Result pops the miner's oldest pending chunk, feeds
        the throughput window, starts the next chunk's lease, and a freed
        miner absorbs one parked chunk (before the scheduler's stale
        check, so a stale answer still frees it; the chunk this Result
        answers is not handed back; a distrusted miner absorbs none unless
        desperation picks it). Returns ``(miner, chunk)``, or None."""
        miner = self.find_miner(conn_id)
        if miner is None or not miner.pending:
            return None
        chunk = miner.pending.pop(0)
        self.observe_result(miner, chunk)
        if miner.pending and not miner.pending[0].lease_started:
            self.start_lease(miner, miner.pending[0])
        if self.parked and miner.available and (
                not self.distrusted(miner)
                or miner in self.desperation_pool()):
            parked = self.next_parked(skip_key=(chunk.job_id, chunk.idx))
            if parked is not None:
                self.assign_chunk(miner, parked, kind="parked")
        return miner, chunk

    # --------------------------------------------------------- lease plane

    def start_lease(self, miner: MinerState, chunk: Chunk) -> None:
        """The miner is (about to be) computing this chunk: observe its
        wait since assignment (``lease_wait_s``), re-stamp
        ``assigned_at``, so the throughput sample and the overdue time
        measure compute, not FIFO wait, and set the deadline."""
        now = time.monotonic()
        if chunk.assigned_at:
            self._lease_wait.observe(now - chunk.assigned_at)
        chunk.assigned_at = now
        chunk.deadline = now + self.lease_for(miner, chunk)
        chunk.lease_started = True

    def lease_for(self, miner: MinerState, chunk: Chunk) -> float:
        """Headroom over the EWMA-predicted scan time (the miner's rate,
        else the pool's), clamped below; ``grace_s`` on a cold pool."""
        if not self.lease.enabled:
            return float("inf")
        rate = miner.rate_ewma if miner.rate_ewma is not None \
            else self.pool_rate
        if rate is None or rate <= 0:
            return self.lease.grace_s
        return max(self.lease.floor_s, chunk.size / rate * self.lease.factor)

    def observe_result(self, miner: MinerState, chunk: Chunk) -> None:
        """Per-pop bookkeeping, for every pop (a stale answer was computed
        too): throughput sampling, the streak reset, a trust step back,
        and a quarantine lifted (then the scheduler's pump runs).

        Throughput is sampled over a wall-clock window per miner:
        answered nonces accumulate until ``RATE_WINDOW_S`` has passed
        since the window opened (at a chunk's lease start), then one
        sample feeds the miner's EWMA and the pool's. A blown chunk (its
        time measures the wedge) or a difficulty chunk (its early exit
        scans an unknown part of the range) resets the window instead."""
        alpha = self.lease.ewma_alpha
        now = time.monotonic()
        if chunk.assigned_at and not chunk.lease_blown and not chunk.target:
            if miner.win_nonces == 0 \
                    or now - miner.win_t0 > 4 * self.RATE_WINDOW_S:
                # A fresh window, or a stale one (an idle gap must not
                # deflate the sample), opened at this chunk's start.
                miner.win_t0 = chunk.assigned_at or now
                miner.win_nonces = 0
            miner.win_nonces += chunk.size
            elapsed = now - miner.win_t0
            if elapsed >= self.RATE_WINDOW_S:
                rate = miner.win_nonces / elapsed
                miner.win_t0, miner.win_nonces = now, 0
                # A JOIN hint is a claim: the first measured window
                # replaces it instead of blending with it.
                if miner.rate_hinted:
                    miner.rate_hinted = False
                    miner.rate_ewma = None
                if self._pool_hinted:
                    self._pool_hinted = False
                    self.pool_rate = None
                miner.rate_ewma = rate if miner.rate_ewma is None else \
                    alpha * rate + (1 - alpha) * miner.rate_ewma
                self.pool_rate = rate if self.pool_rate is None else \
                    alpha * rate + (1 - alpha) * self.pool_rate
                self._set_rate(miner)
                self.metrics.gauge("pool_rate_nps").set(self.pool_rate)
        else:
            miner.win_t0, miner.win_nonces = 0.0, 0
        miner.blown_streak = 0
        # The claim check runs after this step, so a lying Result's decay
        # lands last and a liar never gains trust from its own lie.
        if miner.trust < 1.0:
            miner.trust = min(1.0, miner.trust + self.verify.trust_recover)
            self._set_trust(miner)
        if miner.quarantined:
            miner.quarantined = False
            self.update_pool_gauges()
            self._lease_event("quarantine_lifted", chunk, miner.conn_id)
            self._dispatch()

    def trust_fail(self, miner: MinerState, reason: str) -> float:
        """Decay ``miner``'s trust after a claim or audit failure
        (``reason`` ``"claim"`` or ``"audit"``, counted per kind),
        clamped at the floor; an unconfirmed JOIN hint is discarded (a
        caught liar's claim of its own rate is worth nothing). Returns
        the new score."""
        v = self.verify
        miner.trust = max(v.trust_floor, miner.trust * v.trust_decay)
        self._count("trust_decays_" + reason)
        self._set_trust(miner)
        if self._trace_on:
            _tracing.flight("trust_decayed", miner=miner.conn_id,
                            trust=round(miner.trust, 4), reason=reason)
        if miner.rate_hinted:
            miner.rate_hinted = False
            miner.rate_ewma = None
            self.metrics.remove("miner_rate_nps", miner=str(miner.conn_id))
        return miner.trust

    def pin_rates(self, rate: float, include_hinted: bool = False) -> None:
        """Pin every (by default un-hinted) miner's rate EWMA and the pool
        rate to ``rate`` and clear the pool's hint flag: how a harness
        warms a pool without reaching into the hint bookkeeping (hinted
        miners keep their JOIN hint)."""
        for m in self.miners:
            if include_hinted or not m.rate_hinted:
                m.rate_ewma = rate
        self.pool_rate = rate
        self._pool_hinted = False

    def decay_rate_hints(self) -> None:
        """One sweep's decay of the unconfirmed hints, the miners' and the
        pool's, so a stale or inflated claim bleeds away."""
        for m in self.miners:
            if m.rate_hinted and m.rate_ewma:
                m.rate_ewma *= self.RATE_HINT_DECAY
                self._set_rate(m)
        if self._pool_hinted and self.pool_rate:
            self.pool_rate *= self.RATE_HINT_DECAY
            self.metrics.gauge("pool_rate_nps").set(self.pool_rate)

    # ------------------------------------------------------------ striping

    def stripe_chunks(self, miner: MinerState, share: int) -> int:
        """Chunks for one miner's ``share`` of a wholesale request:
        ``ceil(share / (rate * trust * chunk_s))``, at most ``depth``;
        1 (the stock split) with striping off, a trivial share, or no
        rate yet."""
        if not self.stripe.enabled or share <= 1:
            return 1
        rate = miner.rate_ewma if miner.rate_ewma is not None \
            else self.pool_rate
        if rate is None or rate <= 0:
            return 1
        # Weighted by trust: the rate may be an unauthenticated hint. The
        # adapt plane's per-miner seconds, when set, replace the pool's.
        rate *= miner.trust
        chunk_s = self.chunk_s_overrides.get(miner.conn_id,
                                             self.stripe.chunk_s)
        target = max(1, int(rate * chunk_s))
        return max(1, min(self.stripe.depth, -(-share // target)))

    def set_chunk_s_override(self, conn_id: int, chunk_s: float) -> None:
        """The adapt plane's per-miner stripe seconds for one miner."""
        self.chunk_s_overrides[conn_id] = chunk_s
        self.metrics.gauge("adapt_chunk_s_miner",
                           miner=str(conn_id)).set(chunk_s)

    def clear_chunk_s_overrides(self) -> None:
        """The pool re-converged: every per-miner value retires, and its
        gauge with it, so the pool-wide knob governs again."""
        for conn_id in self.chunk_s_overrides:
            self.metrics.remove("adapt_chunk_s_miner", miner=str(conn_id))
        self.chunk_s_overrides.clear()

    def service_sample(self, chunk: Chunk):
        """``(service_s, margin_frac)`` of a just-popped chunk for the
        adapt plane, from the lease plane's stamps: seconds since its
        lease started, and the unspent share of its lease. ``(None,
        None)`` when the stamps cannot say: the lease never started, blew
        or is infinite (leases off), or the chunk was cancelled."""
        if not chunk.lease_started or chunk.lease_blown \
                or chunk.cancelled or not chunk.assigned_at:
            return None, None
        lease_span = chunk.deadline - chunk.assigned_at
        if not (lease_span > 0) or lease_span == float("inf"):
            return None, None
        now = time.monotonic()
        service = max(0.0, now - chunk.assigned_at)
        margin = max(0.0, (chunk.deadline - now) / lease_span)
        return service, margin

    def observe_stripe(self, n_chunks: int) -> None:
        self._stripe_depth.observe(n_chunks)

    def clear_lease_gauges(self) -> None:
        """No request in flight: the remaining-lease gauges clear, so an
        idle scheduler does not report a retired job's last sweep."""
        for m in self.miners:
            self.metrics.remove("lease_remaining_s", miner=str(m.conn_id))
        self._lease_min_remaining.set(0.0)

    def check_leases(self) -> None:
        """One lease sweep over every in-flight job: blow expired leases
        (quarantining repeat offenders) and re-issue each blown chunk
        once to another eligible miner. A blown chunk with no taker is
        re-issued on a later sweep, once a miner frees up or joins."""
        if not self._inflight:
            return
        now = time.monotonic()
        # Each miner's nearest live deadline (a deep budgeted chunk must
        # not hide the head's), published after the sweep.
        remaining_by_miner: dict[int, float] = {}
        for miner in list(self.miners):
            for chunk in list(miner.pending):
                if chunk.cancelled:
                    continue
                curr = self._inflight.get(chunk.job_id)
                if curr is None or curr.answered[chunk.idx]:
                    continue
                if not chunk.lease_blown:
                    if now < chunk.deadline:
                        remaining = chunk.deadline - now
                        prev = remaining_by_miner.get(miner.conn_id)
                        if prev is None or remaining < prev:
                            remaining_by_miner[miner.conn_id] = remaining
                        continue
                    chunk.lease_blown = True
                    self._count("leases_blown")
                    # With the at-assignment clock a chunk can blow while
                    # others still sit ahead of it: counted, as noise.
                    spurious = (not self.lease.fifo_aware
                                and miner.pending[0] is not chunk)
                    if spurious:
                        self._count("leases_blown_spurious")
                    miner.blown_streak += 1
                    self._lease_event("blown", chunk, miner.conn_id,
                                      streak=miner.blown_streak,
                                      spurious=spurious,
                                      overdue_s=now - chunk.assigned_at)
                    if (miner.blown_streak >= self.lease.quarantine_after
                            and not miner.quarantined):
                        miner.quarantined = True
                        self._count("quarantines")
                        self.update_pool_gauges()
                        self._lease_event("quarantine", chunk,
                                          miner.conn_id,
                                          streak=miner.blown_streak)
                if chunk.reissued:
                    continue
                takeover = next(
                    (m for m in self.eligible() if m is not miner), None)
                if takeover is None:
                    continue   # retry next sweep
                chunk.reissued = True
                self._count("reissues")
                self._lease_event("reissue", chunk, miner.conn_id,
                                  to_miner=takeover.conn_id)
                self.assign_chunk(takeover, Chunk(
                    chunk.job_id, chunk.data, chunk.lower, chunk.upper,
                    target=chunk.target, idx=chunk.idx), kind="reissue")
        # A miner without a live unexpired lease (blown, answered, idle)
        # loses its series: a blown lease's stale positive remainder would
        # read as headroom.
        for m in self.miners:
            if m.conn_id not in remaining_by_miner:
                self.metrics.remove("lease_remaining_s", miner=str(m.conn_id))
        for conn_id, remaining in remaining_by_miner.items():
            self.metrics.gauge("lease_remaining_s",
                               miner=str(conn_id)).set(remaining)
        self._lease_min_remaining.set(
            min(remaining_by_miner.values()) if remaining_by_miner else 0.0)
